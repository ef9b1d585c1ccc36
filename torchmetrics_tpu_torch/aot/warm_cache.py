"""Precompile a named metric set into the AOT compile cache for boot-time use
(counterpart of ``tools/warm_cache.py``).

A freshly booted service instance pays for every metric program on its first batch.
This CLI runs the expensive part ONCE — at image-build time, in a deploy hook, or on a
sidecar — and publishes the exported, AOTInductor-compiled programs into a cache
directory that every serving process then loads from::

    # build/deploy time: populate the cache for the shapes you serve
    python -m torchmetrics_tpu_torch.aot.warm_cache --cache-dir /var/cache/metrics-aot --set flagship

    # serving process: aot.enable("/var/cache/metrics-aot") — first updates load the
    # packages instead of running the eager fold

Named sets pin the metric constructions and input shapes of the JAX package's bench
configs. ``--batch``/``--num-classes`` override shapes for custom traffic, ``--device``
the device (the card by default); ``--list`` shows the sets; ``--scan`` reports cache
health (entries, total bytes, undecodable files); ``--prune-tmp`` sweeps crashed
writers' temp files; ``--prune SIZE`` (or ``--max-bytes``; plain bytes or a K/M/G
suffix) LRU-prunes the cache to a size budget — least-recently-hit entries go first
(every validated load refreshes an entry's mtime).

Prints one JSON report. Exit code 0 unless a program failed to precompile.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Callable, Dict, Optional, Tuple


def _inputs(batch: int, num_classes: int, device: Any) -> tuple:
    import torch

    return (torch.zeros((batch, num_classes), dtype=torch.float32, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device))


def build_flagship(batch: int = 65536, num_classes: int = 5, device: Optional[str] = None) -> Tuple[Any, tuple]:
    """The bench flagship: MulticlassAccuracy on (batch, C) f32 logits."""
    from ..classification import MulticlassAccuracy

    metric = MulticlassAccuracy(num_classes=num_classes, average="micro", validate_args=False, device=device)
    return metric, _inputs(batch, num_classes, metric.device)


def build_classification16(batch: int = 4096, num_classes: int = 10, device: Optional[str] = None) -> Tuple[Any, tuple]:
    """The ``collection_sync_16metrics`` bench config: 16 stat-family metrics."""
    from ..classification import MulticlassAccuracy, MulticlassF1Score, MulticlassPrecision, MulticlassRecall
    from ..collections import MetricCollection

    collection = MetricCollection({
        f"{cls.__name__}_{avg}": cls(num_classes, average=avg, validate_args=False, device=device)
        for cls in (MulticlassAccuracy, MulticlassF1Score, MulticlassPrecision, MulticlassRecall)
        for avg in ("micro", "macro", "weighted", "none")
    }, compute_groups=False, device=device)
    return collection, _inputs(batch, num_classes, collection.device)


def build_fused_cifar10(batch: int = 10000, num_classes: int = 10, device: Optional[str] = None) -> Tuple[Any, tuple]:
    """The fused-collection bench config: Accuracy/F1/AUROC/ConfusionMatrix."""
    from ..classification import MulticlassAccuracy, MulticlassAUROC, MulticlassConfusionMatrix, MulticlassF1Score
    from ..collections import MetricCollection

    collection = MetricCollection({
        "acc": MulticlassAccuracy(num_classes, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(num_classes, average="macro", validate_args=False, device=device),
        "auroc": MulticlassAUROC(num_classes, thresholds=200, validate_args=False, device=device),
        "confmat": MulticlassConfusionMatrix(num_classes, validate_args=False, device=device),
    }, device=device)
    return collection, _inputs(batch, num_classes, collection.device)


BUILDERS: Dict[str, Callable[..., Tuple[Any, tuple]]] = {
    "flagship": build_flagship,
    "classification16": build_classification16,
    "fused_cifar10": build_fused_cifar10,
}


def _count_rows(report: Dict[str, Any]) -> Dict[str, int]:
    """Flatten a (possibly nested) precompile report into status counts."""
    counts = {"written": 0, "cached": 0, "skipped": 0, "failed": 0}

    def walk(node: Any) -> None:
        if isinstance(node, dict):
            status = node.get("status")
            if status in counts:
                counts[status] += 1
                return
            for v in node.values():
                walk(v)

    walk(report)
    return counts


def parse_size(text: str) -> int:
    """``"512M"``/``"2G"``/``"65536"`` → bytes (K/M/G/T binary suffixes)."""
    s = text.strip().upper().removesuffix("B")
    units = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if s and s[-1] in units:
        return int(float(s[:-1]) * units[s[-1]])
    return int(s)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m torchmetrics_tpu_torch.aot.warm_cache",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--cache-dir", default=None,
                        help="cache root (default: $TORCHMETRICS_TPU_AOT_CACHE or ~/.cache/torchmetrics_tpu_torch/aot)")
    parser.add_argument("--set", dest="sets", action="append", default=[], metavar="NAME",
                        help=f"metric set to precompile (repeatable); one of: {', '.join(BUILDERS)}")
    parser.add_argument("--all", action="store_true", help="precompile every named set")
    parser.add_argument("--tags", default="update",
                        help="comma-separated dispatch tags to precompile (default: update)")
    parser.add_argument("--batch", type=int, default=None, help="override the set's batch size")
    parser.add_argument("--num-classes", type=int, default=None, help="override the set's class count")
    parser.add_argument("--device", default=None, help="device of the metrics (default: cuda)")
    parser.add_argument("--force", action="store_true", help="rewrite entries that already exist")
    parser.add_argument("--list", action="store_true", help="list the named sets and exit")
    parser.add_argument("--scan", action="store_true", help="report cache health and exit")
    parser.add_argument("--prune-tmp", action="store_true", help="sweep orphaned temp files and exit")
    parser.add_argument("--prune", "--max-bytes", dest="max_bytes", default=None, metavar="SIZE",
                        help="LRU-prune the cache to this size budget and exit "
                             "(bytes, or K/M/G suffix; least-recently-hit entries removed first)")
    args = parser.parse_args(argv)

    if args.list:
        print(json.dumps({name: (fn.__doc__ or "").strip().splitlines()[0] for name, fn in BUILDERS.items()},
                         indent=2))
        return 0

    from .. import aot

    with aot.aot_session(args.cache_dir) as plane:
        if args.scan:
            print(json.dumps(plane.cache.scan(), indent=2))
            return 0
        if args.prune_tmp:
            print(json.dumps({"swept": plane.cache.prune_tmp()}))
            return 0
        if args.max_bytes is not None:
            report = plane.cache.prune(parse_size(args.max_bytes))
            report["scan"] = plane.cache.scan()
            print(json.dumps(report, indent=2))
            return 0

        names = list(BUILDERS) if args.all else args.sets
        if not names:
            parser.error("pick at least one --set NAME (or --all / --list)")
        unknown = [n for n in names if n not in BUILDERS]
        if unknown:
            parser.error(f"unknown set(s) {unknown}; available: {', '.join(BUILDERS)}")

        overrides = {k: v for k, v in (("batch", args.batch), ("num_classes", args.num_classes)) if v}
        tags = tuple(t.strip() for t in args.tags.split(",") if t.strip())
        out: Dict[str, Any] = {"cache_dir": plane.cache.root, "sets": {}}
        for name in names:
            obj, example = BUILDERS[name](device=args.device, **overrides)
            report = obj.precompile(*example, tags=tags, force=args.force)
            out["sets"][name] = {"counts": _count_rows(report), "report": report}
        out["stats"] = dict(plane.stats)
        print(json.dumps(out, indent=2, default=str))
        return 1 if any(s["counts"]["failed"] for s in out["sets"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
