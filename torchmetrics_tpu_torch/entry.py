"""Entry points of the port (counterpart of the JAX package's ``__graft_entry__.py``).

``entry()``                  the fused ``{acc, f1, confmat}`` eval step as ``(fn, args)``:
                             ``fn(*args)`` updates every state and returns the values.
``_flagship_step_fn(n)``     the flagship (Accuracy + F1 + padded detection + FID behind a
                             toy extractor) as one step sharded over ``n`` ranks of a
                             ``torch.distributed`` group: ``(step, args, finalize)``.
``dryrun_multichip(n)``      ``n`` ranks spawned with ``torch.multiprocessing``, each
                             running the fused collection's sharded step and reduce, then
                             the flagship's step, sync and finalize; every rank's synced
                             values are held against one process over the whole batch.
``flagship_sync_latency_ms`` the flagship's sync alone, on a pre-built local state.

Everything runs on the card unless the caller passes ``device="cpu"``; without CUDA the
default device raises. ``Flagship`` and ``flagship_classification`` are the flagship's
parts at any width: ``chip_smoke.py`` runs them at full width behind the bf16 InceptionV3
trunk, whose 26 1x7/7x1 convs a forward go through ``kernels/sepconv.py``'s wrapper.

Example:
    >>> fn, (states, preds, target) = entry(device="cpu")
    >>> states, values = fn(states, preds, target)
    >>> sorted(values), values["confmat"].shape
    (['acc', 'confmat', 'f1'], torch.Size([5, 5]))
"""

from __future__ import annotations

import datetime
import json
import math
import os
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .utilities.checks import resolve_device

NUM_CLASSES = 5
ENTRY_BATCH = 32
ROWS_PER_RANK = 4  # classification rows, detection images and FID images of each rank
MAX_DET, MAX_GT = 8, 6
TOY_IMAGE = (3, 8, 8)
TOY_PROJECTION_SEED = 7
FID_RTOL = 1e-4  # float32 feature sums added per rank by the group, or in one process
RANKS_WALL_S = 300


def _pure_collection(device: torch.device):
    from .classification import MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score
    from .collections import MetricCollection

    return MetricCollection({
        "acc": MulticlassAccuracy(NUM_CLASSES, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(NUM_CLASSES, average="macro", validate_args=False, device=device),
        "confmat": MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, device=device),
    }, device=device).as_pure()


def _classification_batch(batch: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(0)
    preds = rng.normal(size=(batch, NUM_CLASSES)).astype(np.float32)
    target = rng.integers(0, NUM_CLASSES, batch, dtype=np.int32)
    return torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device)


def entry(device: Any = None):
    """Return ``(fn, example_args)``: one fused eval step that updates every metric state
    and emits the batch values, ``MetricCollection({acc, f1, confmat}).as_pure().apply``
    on seed-0 inputs of 32 x 5, on ``device`` (the card when None)."""
    device = resolve_device(device)
    pure = _pure_collection(device)
    preds, target = _classification_batch(ENTRY_BATCH, device)
    return pure.apply, (pure.init(), preds, target)


def flagship_classification(num_classes: int = 5, device=None):
    """The flagship's ``{acc, f1}`` pure collection."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score

    return MetricCollection({
        "acc": MulticlassAccuracy(num_classes, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(num_classes, average="macro", validate_args=False, device=device),
    }, device=device).as_pure()


class Flagship:
    """The port's flagship eval step, mirroring ``__graft_entry__._flagship_step_fn``:
    the ``{acc, f1}`` pure collection, the padded detection accumulator and FID behind
    the ``extractor`` the caller passes in. ``update`` folds one batch into the states;
    ``sync`` reduces them over the process group (``PureCollection.reduce``, then
    ``PaddedDetectionAccumulator.gather``, then FID's reduction; without a group, a
    world of one, only the gather's process axis is added); ``finalize`` computes the
    values, mAP by ``MeanAveragePrecision`` on the gathered rows."""

    def __init__(self, extractor, capacity_images: int, max_det: int, max_gt: int, num_classes: int = 5,
                 device=None) -> None:
        from torchmetrics_tpu_torch.detection import PaddedDetectionAccumulator
        from torchmetrics_tpu_torch.image import FrechetInceptionDistance

        self.device = device
        self.cls_pure = flagship_classification(num_classes, device)
        self.det_acc = PaddedDetectionAccumulator(capacity_images, max_det, max_gt, device=device)
        self.fid = FrechetInceptionDistance(feature=extractor, normalize=True, device=device)

    def init(self) -> dict:
        return {"cls": self.cls_pure.init(), "det": self.det_acc.init(), "fid": self.fid.init_state()}

    def update(self, states: dict, preds, target, det_batch, imgs_real, imgs_fake) -> dict:
        fid = self.fid.update_state(states["fid"], imgs_real, True)
        return {"cls": self.cls_pure.update(states["cls"], preds, target),
                "det": self.det_acc.update(states["det"], *det_batch),
                "fid": self.fid.update_state(fid, imgs_fake, False)}

    def sync(self, states: dict, group=None) -> dict:
        import torch.distributed as dist

        if not dist.is_initialized():
            return {"cls": states["cls"], "det": self.det_acc.gather(states["det"]), "fid": states["fid"]}
        return {"cls": self.cls_pure.reduce(states["cls"], group), "det": self.det_acc.gather(states["det"], group),
                "fid": self.fid.reduce_state(states["fid"], group)}

    def expected_collectives(self, states: dict) -> int:
        """The collectives ``sync`` runs, by ``collective_counts``: one per (reduction
        class x dtype) bucket of each of its three reductions."""
        from torchmetrics_tpu_torch.detection.sharded import _stacked
        from torchmetrics_tpu_torch.parallel import collective_counts

        cls_states = list(states["cls"].values())
        cls_reds = [m._reductions for m in self.cls_pure._metrics.values()]
        det = {k: _stacked for k in states["det"]}
        return sum(collective_counts(s, r)["in_graph_coalesced"] for s, r in (
            (cls_states, cls_reds), ([states["det"]], [det]), ([states["fid"]], [self.fid._reductions])))

    def finalize(self, synced: dict) -> dict:
        from torchmetrics_tpu_torch.detection import MeanAveragePrecision

        values = dict(self.cls_pure.compute(synced["cls"]))
        # the rows are already gathered: the metric must not sync them again
        map_metric = MeanAveragePrecision(class_metrics=False, device=self.device, sync_on_compute=False)
        map_metric.update(*self.det_acc.to_lists(synced["det"]))
        values["map"] = map_metric.compute()["map"]
        values["fid"] = self.fid.compute_state(synced["fid"])
        return values


def toy_projection(feature_dim: int = 16) -> np.ndarray:
    """The toy extractor's fixed projection of a flattened 3x8x8 image, drawn from numpy."""
    pixels = int(np.prod(TOY_IMAGE))
    return np.random.default_rng(TOY_PROJECTION_SEED).normal(size=(pixels, feature_dim)).astype(np.float32)


class ToyExtractor:
    """``(N, 3, 8, 8) -> (N, feature_dim)``: a fixed random projection of the pixels."""

    def __init__(self, feature_dim: int, device: torch.device) -> None:
        self.num_features = feature_dim
        self.proj = torch.from_numpy(toy_projection(feature_dim)).to(device)

    def __call__(self, imgs: torch.Tensor) -> torch.Tensor:
        return imgs.reshape(imgs.shape[0], -1).float() @ self.proj


def _group_world(group) -> Tuple[int, int]:
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class FlagshipStep:
    """The flagship as one sharded step: ``step(*args)`` folds this rank's share of the
    whole input into fresh states and syncs them; ``local_step(*args)`` only folds,
    ``sync_only(states)`` only syncs. ``args`` is the whole input of every rank; in a
    world of ``n_ranks`` a rank takes its own 4 rows and images, in a world of one the
    process takes all of them (the unsharded step over the whole batch)."""

    def __init__(self, flagship: Flagship, n_ranks: int, group, args: tuple) -> None:
        self.flagship, self.n_ranks, self.group, self.args = flagship, n_ranks, group, args

    def _share(self, args: tuple) -> tuple:
        rank, world = _group_world(self.group)
        if world == 1:
            return args
        rows = slice(rank * ROWS_PER_RANK, (rank + 1) * ROWS_PER_RANK)
        preds, target, det_batch, imgs_real, imgs_fake = args
        return preds[rows], target[rows], tuple(a[rows] for a in det_batch), imgs_real[rows], imgs_fake[rows]

    def local_step(self, *args) -> dict:
        return self.flagship.update(self.flagship.init(), *self._share(args))

    def sync_only(self, states: dict) -> dict:
        return self.flagship.sync(states, self.group)

    def __call__(self, *args) -> dict:
        return self.sync_only(self.local_step(*args))


def _flagship_inputs(n_ranks: int, device: torch.device) -> tuple:
    """The JAX flagship's seed-0 inputs for ``n_ranks`` ranks, drawn in its order."""
    from .detection import pack_detection_batch

    rng = np.random.default_rng(0)
    batch = ROWS_PER_RANK * n_ranks
    preds = np.asarray(rng.normal(size=(batch, NUM_CLASSES)), np.float32)
    target = rng.integers(0, NUM_CLASSES, batch).astype(np.int32)
    det_preds = [
        {"boxes": np.sort(rng.uniform(0, 50, (3, 4)), -1).astype(np.float32),
         "scores": rng.uniform(0, 1, 3).astype(np.float32),
         "labels": rng.integers(0, NUM_CLASSES, 3).astype(np.int32)}
        for _ in range(batch)
    ]
    det_target = [
        {"boxes": np.sort(rng.uniform(0, 50, (2, 4)), -1).astype(np.float32),
         "labels": rng.integers(0, NUM_CLASSES, 2).astype(np.int32)}
        for _ in range(batch)
    ]
    det_batch = pack_detection_batch(det_preds, det_target, MAX_DET, MAX_GT, device=device)
    imgs_real = np.asarray(rng.random((batch, *TOY_IMAGE)), np.float32)
    imgs_fake = np.asarray(rng.random((batch, *TOY_IMAGE)), np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(preds), t(target), det_batch, t(imgs_real), t(imgs_fake)


def _flagship_step_fn(n_ranks: int, feature_dim: int = 16, device: Any = None, group=None):
    """The flagship — Accuracy + F1 + padded detection + FID — as one step sharded over
    the ``n_ranks`` ranks of ``group`` (the default group; no group is a world of one,
    which takes the whole input). Returns ``(step, args, finalize)``: ``step(*args)``
    gives the synced states (``step.local_step`` and ``step.sync_only`` are its halves)
    and ``finalize(synced)`` the values ``{acc, f1, map, fid}``."""
    device = resolve_device(device)
    world = _group_world(group)[1]
    if world not in (1, n_ranks):
        raise ValueError(f"the flagship is sharded over {n_ranks} ranks, but the group has {world}")
    capacity = ROWS_PER_RANK * (n_ranks if world == 1 else 1)
    flagship = Flagship(ToyExtractor(feature_dim, device), capacity, MAX_DET, MAX_GT, NUM_CLASSES, device=device)
    args = _flagship_inputs(n_ranks, device)
    return FlagshipStep(flagship, n_ranks, group, args), args, flagship.finalize


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def flagship_sync_latency_ms(step: FlagshipStep, iters: int = 30) -> float:
    """Latency of the flagship's sync alone — one reduction per bucket of the whole
    Accuracy + F1 + mAP + FID state — timed on a pre-built local state (the update is
    left out), in ms a sync."""
    device = step.flagship.fid.device
    local = step.local_step(*step.args)
    step.sync_only(local)
    _synchronize(device)
    start = time.perf_counter()
    for _ in range(iters):
        step.sync_only(local)
    _synchronize(device)
    return round((time.perf_counter() - start) / iters * 1000, 3)


def _plain(value: torch.Tensor):
    value = value.detach().cpu()
    return value.item() if value.ndim == 0 else value.tolist()


def sharded_values(n_ranks: int, device: Any = None, group=None) -> Dict[str, Any]:
    """One rank's part of the dry run (all of it in a world of one): the fused
    collection's step on this rank's rows and its reduce over ``group``, then the
    flagship's step, sync and finalize, with the JAX dry run's asserts. Returns the
    synced collection states, its values and the flagship's values as plain Python."""
    import torch.distributed as dist

    device = resolve_device(device)
    rank, world = _group_world(group)
    pure = _pure_collection(device)
    preds, target = _classification_batch(ROWS_PER_RANK * n_ranks, device)
    if world != 1:
        rows = slice(rank * ROWS_PER_RANK, (rank + 1) * ROWS_PER_RANK)
        preds, target = preds[rows], target[rows]
    local = pure.update(pure.init(), preds, target)
    synced = pure.reduce(local, group) if dist.is_initialized() else local
    values = pure.compute(synced)
    assert 0.0 <= float(values["acc"]) <= 1.0

    step, args, finalize = _flagship_step_fn(n_ranks, device=device, group=group)
    flagship = finalize(step(*args))
    assert 0.0 <= float(flagship["acc"]) <= 1.0
    assert 0.0 <= float(flagship["map"]) <= 1.0
    assert float(flagship["fid"]) >= 0.0
    return {
        "collection": {"states": {name: {leaf: _plain(v) for leaf, v in state.items()}
                                  for name, state in synced.items()},
                       "values": {name: _plain(v) for name, v in values.items()}},
        "flagship": {name: float(v) for name, v in flagship.items()},
    }


def _rank_main(rank: int, fn, world: int, backend: str, device_type: str, init_method: str, out_dir: str) -> None:
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device_type == "cuda":
        device = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        result = fn(rank, world, device)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(result, fh)


def run_ranks(fn, world: int, device: Any = None, backend: Optional[str] = None) -> list:
    """Spawn ``world`` processes (``torch.multiprocessing``, start method spawn) that join
    one process group through a ``file://`` store in a temporary directory, run
    ``fn(rank, world, device)`` (a module-level function returning JSON-able values) and
    leave it; returns each rank's result in rank order.

    ``device`` is the card when None. ``backend`` is the caller's choice: ``"nccl"`` (the
    default on the card) puts rank ``r`` on card ``r`` and needs ``world`` cards;
    ``"gloo"`` (the default with ``device="cpu"``) runs the ranks on the CPU, or on the
    card, all sharing card 0, its collectives staged through the host."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL runs on the card; pass backend='gloo' with device='cpu'")
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} NCCL ranks need {world} cards but only {torch.cuda.device_count()} are "
                               "visible; pass backend='gloo' to run the ranks on one card.")
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    with tempfile.TemporaryDirectory(prefix="torchmetrics_ranks_") as tmp:
        context = mp.start_processes(_rank_main, args=(fn, world, backend, device.type, f"file://{tmp}/rendezvous", tmp),
                                     nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + RANKS_WALL_S
        try:
            while not context.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {world} ranks ran past {RANKS_WALL_S} s")
        finally:
            for proc in context.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json"), encoding="utf-8") as fh:
                results.append(json.load(fh))
    return results


def _dryrun_rank(rank: int, world: int, device: torch.device) -> Dict[str, Any]:
    return sharded_values(world, device)


def _hold_rank(rank: int, got: Dict[str, Any], want: Dict[str, Any]) -> float:
    """A rank's synced values against the unsharded step's: the collection's states and
    values and the flagship's acc, f1 and map equal, FID within ``FID_RTOL`` relative.
    Returns the FID's relative difference."""
    if got["collection"] != want["collection"]:
        raise AssertionError(f"dryrun_multichip: rank {rank}'s collection {got['collection']} differs from "
                             f"the unsharded step's {want['collection']}")
    for key in ("acc", "f1", "map"):
        if got["flagship"][key] != want["flagship"][key]:
            raise AssertionError(f"dryrun_multichip: rank {rank}'s flagship {key} {got['flagship'][key]}, "
                                 f"the unsharded step's {want['flagship'][key]}")
    fid, ref = got["flagship"]["fid"], want["flagship"]["fid"]
    diff = abs(fid - ref) / abs(ref)
    if not (math.isfinite(fid) and diff <= FID_RTOL):
        raise AssertionError(f"dryrun_multichip: rank {rank}'s FID {fid}, the unsharded step's {ref}")
    return diff


def dryrun_multichip(n_ranks: int, device: Any = None, backend: Optional[str] = None) -> Dict[str, Any]:
    """The full sharded eval step over ``n_ranks`` spawned ranks, twice over: the fused
    classification collection (rows sharded by rank, its states reduced over the group)
    and the flagship (tensor states reduced, the detection rows gathered, FID behind the
    toy extractor). Each rank's synced values must equal one process's step over the
    whole batch, which this process runs with no group.

    ``device`` and ``backend`` are :func:`run_ranks`'s: NCCL with one card a rank by
    default, gloo on the CPU or on one shared card when the caller asks. Returns
    ``{"backend", "ranks": [each rank's values], "unsharded": ..., "fid_rel_diff"}``.
    """
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    ranks = run_ranks(_dryrun_rank, n_ranks, device, backend)
    want = sharded_values(n_ranks, device)
    worst = max(_hold_rank(r, got, want) for r, got in enumerate(ranks))
    return {"backend": backend, "ranks": ranks, "unsharded": want, "fid_rel_diff": worst}
