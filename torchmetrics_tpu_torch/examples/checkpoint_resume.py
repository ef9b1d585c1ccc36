"""Checkpoint/resume an evaluation mid-stream with ``torch.save``
(counterpart of ``examples/checkpoint_resume.py``).

The pattern: metric states are plain tensor dicts, so they ride the same checkpoint
your model weights use. This script evaluates half a dataset, checkpoints the
collection + a wrapper, "restarts" (fresh objects), restores, finishes the second half,
and checks the resumed result equals a never-interrupted run.

It also demonstrates the reliability layer's restore guard: a truncated checkpoint
(lost keys — a half-written file on a preempted job) raises ``StateCorruptionError`` at
``load_state_dict`` instead of silently resuming from garbage.

Run: ``python -m torchmetrics_tpu_torch.examples.checkpoint_resume --device cpu`` (the
card without ``--device``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch


def make_collection(device):
    from ..classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
    from ..collections import MetricCollection

    return MetricCollection({
        "acc": MulticlassAccuracy(num_classes=5, average="micro", device=device),
        "f1": MulticlassF1Score(num_classes=5, average="macro", device=device),
        "auroc": MulticlassAUROC(num_classes=5, thresholds=64, device=device),
    }, device=device)


def make_tracker(device):
    from ..classification import MulticlassAccuracy
    from ..wrappers import MinMaxMetric

    return MinMaxMetric(MulticlassAccuracy(num_classes=5, average="micro", device=device), device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m torchmetrics_tpu_torch.examples.checkpoint_resume",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)

    from ..reliability import truncate_state_dict
    from ..utilities.checks import cli_device
    from ..utilities.exceptions import StateCorruptionError

    device = cli_device(parser, args.device)
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(5), size=512).astype(np.float32)
    target = rng.integers(0, 5, 512).astype(np.int32)
    batches = [(torch.from_numpy(probs[i:i + 64]).to(device), torch.from_numpy(target[i:i + 64]).to(device))
               for i in range(0, 512, 64)]

    # ---- first run: half the data, then checkpoint and "crash"
    collection = make_collection(device)
    tracker = make_tracker(device)
    for p, t in batches[:4]:
        collection.update(p, t)
        tracker(p, t)

    with tempfile.TemporaryDirectory(prefix="checkpoint_resume_") as root:
        path = os.path.join(root, "eval_state.pt")
        collection.persistent(True)
        tracker.persistent(True)
        torch.save({"collection": collection.state_dict(), "tracker": tracker.state_dict()}, path)

        # ---- resume: fresh process-equivalent objects, restore, finish the stream
        restored = torch.load(path, map_location=device, weights_only=True)
    resumed = make_collection(device)
    resumed_tracker = make_tracker(device)
    resumed.load_state_dict(restored["collection"])
    resumed_tracker.load_state_dict(restored["tracker"])
    for p, t in batches[4:]:
        resumed.update(p, t)
        resumed_tracker(p, t)

    # ---- ground truth: the uninterrupted run
    oneshot = make_collection(device)
    for p, t in batches:
        oneshot.update(p, t)

    got = {k: float(v) for k, v in resumed.compute().items()}
    want = {k: float(v) for k, v in oneshot.compute().items()}
    for key in want:
        assert abs(got[key] - want[key]) < 1e-7, (key, got[key], want[key])
    extrema = {k: float(v) for k, v in resumed_tracker.compute().items()}
    print("resumed == uninterrupted:", {k: round(v, 4) for k, v in got.items()})
    print("accuracy extrema across the stream:", {k: round(v, 4) for k, v in extrema.items()})

    # ---- a truncated checkpoint must REFUSE to load, not resume from garbage
    damaged = truncate_state_dict(restored["collection"], drop_keys=["acc.tp"])
    try:
        make_collection(device).load_state_dict(damaged)
        raise AssertionError("truncated checkpoint loaded silently")
    except StateCorruptionError as err:
        print("truncated checkpoint rejected:", str(err)[:90], "...")
    print(json.dumps({"resumed": got, "uninterrupted": want, "extrema": extrema, "truncated_rejected": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
