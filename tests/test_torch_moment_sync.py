"""The moment merges of Pearson, concordance and NRMSE across real processes: gloo process
groups of 2 and 3 OS processes on the CPU, each with an uneven shard of the data.

Their states register ``dist_reduce_fx=None``: a sync stacks one row of moments per rank
and ``compute()`` folds the stack in rank order, and ``reduce_state`` all-gathers over
the group and folds. None of this runs in a world of one. The parent holds each rank's
values, and the reduced moments, against the JAX package's ``_compute`` of the ranks'
states stacked in rank order, which folds them with ``_final_aggregation`` (for NRMSE,
its ``_merge`` loop): within 1e-6 relative (``RTOL``; 1e-6 absolute near 0), counts bit
for bit. ``R2Score``'s sum states ride along as a control.

The rendezvous is a ``FileStore`` under ``tmp_path``, every ``init_process_group`` has a
timeout and every worker a wall limit, as in ``test_torch_multiprocess_sync.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

from torchmetrics_tpu import regression as jax_reg

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER_WALL_S = 120
RTOL = 1e-6
SHARDS = {2: (60, 37), 3: (40, 25, 32)}  # rows per rank: uneven on purpose
METRICS = {  # name -> (class, kwargs)
    "pearson": ("PearsonCorrCoef", {"num_outputs": 2}),
    "concordance": ("ConcordanceCorrCoef", {"num_outputs": 2}),
    "nrmse_std": ("NormalizedRootMeanSquaredError", {"num_outputs": 2, "normalization": "std"}),
    "nrmse_range": ("NormalizedRootMeanSquaredError", {"num_outputs": 2, "normalization": "range"}),
    "nrmse_mean": ("NormalizedRootMeanSquaredError", {"num_outputs": 2, "normalization": "mean"}),
    "nrmse_l2": ("NormalizedRootMeanSquaredError", {"num_outputs": 2, "normalization": "l2"}),
    "r2": ("R2Score", {"num_outputs": 2, "multioutput": "raw_values"}),
}

_WORKER = textwrap.dedent(
    """
    import datetime, json, sys

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, init, shards, metrics = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *map(json.loads, sys.argv[4:])
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))

    from torchmetrics_tpu_torch import regression

    rng = np.random.default_rng(21)  # the same stream everywhere; shard by slicing
    total = sum(shards)
    preds = rng.normal(size=(total, 2)).astype(np.float32) * 2 + 1
    target = (preds + rng.normal(size=(total, 2))).astype(np.float32)
    lo = sum(shards[:rank])
    p, t = torch.from_numpy(preds[lo : lo + shards[rank]]), torch.from_numpy(target[lo : lo + shards[rank]])
    out = {}
    for name, (cls, kwargs) in metrics.items():
        metric = getattr(regression, cls)(device="cpu", **kwargs)
        metric.update(p[: len(p) // 2], t[: len(t) // 2])  # two updates: the local fold runs too
        metric.update(p[len(p) // 2 :], t[len(t) // 2 :])
        value = metric.compute()  # sync_on_compute: stacked rows, folded in _compute
        reduced = metric.reduce_state(dict(metric._state))
        out[name] = {"compute": value.tolist(), "reduced_value": metric.compute_state(reduced).tolist(),
                     "reduced": {k: v.tolist() for k, v in reduced.items()},
                     "dtypes": sorted({str(v.dtype) for v in reduced.values()})}
    dist.destroy_process_group()
    print("RESULT" + json.dumps(out))
    """
)


def _run_workers(tmp_path, world):
    (tmp_path / "worker.py").write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=os.pathsep.join([ROOT, env.get("PYTHONPATH", "")]), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'rendezvous'}"
    args = [json.dumps(list(SHARDS[world])), json.dumps(METRICS)]
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(r), str(world), init, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for proc in procs:
            text, _ = proc.communicate(timeout=WORKER_WALL_S)
            assert proc.returncode == 0, text[-3000:]
            payload = [line for line in text.splitlines() if line.startswith("RESULT")]
            assert payload, text[-3000:]
            outs.append(json.loads(payload[-1][len("RESULT"):]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    return outs


def _rank_states(world, cls, kwargs):
    """Each rank's JAX metric after the worker's two updates of its shard (the workers'
    data, from the same seed)."""
    shards = SHARDS[world]
    rng = np.random.default_rng(21)
    total = sum(shards)
    preds = rng.normal(size=(total, 2)).astype(np.float32) * 2 + 1
    target = (preds + rng.normal(size=(total, 2))).astype(np.float32)
    metrics = []
    for rank in range(world):
        lo = sum(shards[:rank])
        p, t = preds[lo : lo + shards[rank]], target[lo : lo + shards[rank]]
        metric = getattr(jax_reg, cls)(**kwargs)
        metric.update(jnp.asarray(p[: len(p) // 2]), jnp.asarray(t[: len(t) // 2]))
        metric.update(jnp.asarray(p[len(p) // 2 :]), jnp.asarray(t[len(t) // 2 :]))
        metrics.append(metric)
    return metrics


def _jax_fold(world):
    """name -> (the JAX package's value of the stacked rank states, its folded states,
    rank 0's own value)."""
    out = {}
    for name, (cls, kwargs) in METRICS.items():
        metrics = _rank_states(world, cls, kwargs)
        states = [m._state for m in metrics]
        metric, reductions = metrics[0], metrics[0]._reductions
        stacked = {k: jnp.stack([s[k] for s in states]) if reductions[k] is None else sum(s[k] for s in states)
                   for k in states[0]}
        if cls == "NormalizedRootMeanSquaredError":
            keys = list(stacked)
            folded = {k: stacked[k][0] for k in keys}
            for i in range(1, world):
                folded = metric._merge(folded, {k: stacked[k][i] for k in keys})
        elif cls == "R2Score":
            folded = stacked
        else:
            folded = metric._final_moments(stacked)
        out[name] = (np.asarray(metric._compute(stacked)), {k: np.asarray(v) for k, v in folded.items()},
                     np.asarray(metric.compute()))
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_moment_merges_across_processes_equal_the_jax_fold(tmp_path, world):
    outs = _run_workers(tmp_path, world)
    want = _jax_fold(world)
    for rank, res in enumerate(outs):
        for name, (value, folded, _) in want.items():
            ctx = f"rank {rank} of {world} {name}"
            got = res[name]
            np.testing.assert_allclose(got["compute"], value, rtol=RTOL, atol=1e-6, err_msg=f"{ctx} compute")
            np.testing.assert_allclose(got["reduced_value"], value, rtol=RTOL, atol=1e-6, err_msg=f"{ctx} reduce")
            assert got["dtypes"] == ["torch.float32"], ctx
            for key, state in folded.items():
                mine = np.asarray(got["reduced"][key], np.float32)
                if key in ("n_total", "total", "min_val", "max_val"):
                    np.testing.assert_array_equal(mine, state, err_msg=f"{ctx} {key}")
                else:
                    np.testing.assert_allclose(mine, state, rtol=RTOL, atol=1e-6, err_msg=f"{ctx} {key}")
    # the shards differ, so a rank's own value is not the synced one: the fold really ran
    assert not np.allclose(want["pearson"][2], want["pearson"][0], rtol=1e-3)
    assert not np.allclose(outs[0]["pearson"]["compute"], want["pearson"][2], rtol=1e-3)
