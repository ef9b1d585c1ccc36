"""Distributed eval loop: a fused MetricCollection updated per rank and reduced over a
``torch.distributed`` group (counterpart of ``examples/pjit_eval_loop.py``, whose
``shard_map`` runs the same step over a device mesh).

This is the production pattern: each rank folds its shard of every eval step into the
collection's pure states, and the states are reduced across the group (one collective
per reduction bucket) only at compute time. The script spawns one NCCL rank a visible
card, or two gloo ranks with ``--device cpu``. Every step's global batch is 1,024 rows
(the JAX example's 128 a device over its 8-device CPU mesh), split over the ranks, so
the values do not depend on the number of ranks.

Run: ``python -m torchmetrics_tpu_torch.examples.distributed_eval_loop --device cpu``
(two gloo ranks), or on the card with no arguments (one rank a card).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

NUM_CLASSES = 10
GLOBAL_BATCH = 1024
STEPS = 4


def make_pure(device):
    from ..classification import (
        MulticlassAccuracy,
        MulticlassAUROC,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
    )
    from ..collections import MetricCollection

    return MetricCollection({
        "acc": MulticlassAccuracy(NUM_CLASSES, average="micro", device=device),
        "f1": MulticlassF1Score(NUM_CLASSES, average="macro", device=device),
        "auroc": MulticlassAUROC(NUM_CLASSES, thresholds=128, device=device),
        "confmat": MulticlassConfusionMatrix(NUM_CLASSES, device=device),
    }, device=device).as_pure()


def eval_batches():
    """The eval epoch: ``STEPS`` global batches of logits and labels, seed 0."""
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        logits = rng.normal(size=(GLOBAL_BATCH, NUM_CLASSES)).astype(np.float32)
        target = rng.integers(0, NUM_CLASSES, logits.shape[0]).astype(np.int32)
        yield logits, target


def rank_values(rank: int, world: int, device) -> dict:
    """This rank's shard of every step folded into the states, reduced over the group."""
    import torch.distributed as dist

    pure = make_pure(device)
    states = pure.init()
    for logits, target in eval_batches():
        rows = np.array_split(np.arange(GLOBAL_BATCH), world)[rank]
        probs = torch.softmax(torch.from_numpy(logits[rows]).to(device), dim=-1)
        states = pure.update(states, probs, torch.from_numpy(target[rows]).to(device))
    synced = pure.reduce(states) if dist.is_initialized() else states
    values = pure.compute(synced)
    return {k: v.detach().cpu().tolist() for k, v in values.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m torchmetrics_tpu_torch.examples.distributed_eval_loop",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)

    from ..entry import run_ranks
    from ..utilities.checks import cli_device

    device = cli_device(parser, args.device)
    on_card = device.type == "cuda"
    backend = "nccl" if on_card else "gloo"
    world = torch.cuda.device_count() if on_card else 2
    ranks = run_ranks(rank_values, world, device, backend)
    values = ranks[0]
    assert all(r == values for r in ranks), "every rank must hold the same reduced values"
    print(f"{world} {backend} ranks on {device.type}:",
          {k: np.round(np.asarray(v), 4).tolist() if np.asarray(v).ndim else round(float(v), 4)
           for k, v in values.items() if k != "confmat"})
    print("confmat row sums:", np.asarray(values["confmat"]).sum(1).astype(int).tolist())
    print(json.dumps({"ranks": world, "backend": backend, "values": values}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
