"""The port's sync over real processes: a gloo process group of 2 or 3 OS processes on
the CPU, not a fake gather (the port's counterpart of ``tests/test_multiprocess_sync.py``).

Each worker updates the port's metrics with its own shard, and ``compute()`` syncs
through the real ``process_sync`` (``torch.distributed.all_gather``). The same workers
reduce states over the group with ``reduce_many``/``PureCollection.reduce``
(``all_reduce``). The parent holds the workers' values against the JAX package: the
metrics run over the whole batch, and ``reduce_many`` under ``shard_map`` on a CPU mesh
of ``world`` devices, the device of rank r holding rank r's state.

Tolerances: counts, integer sums, max, min and cat values bit for bit; ratios within
1e-6; float32 sums and means over the group within 1e-6 relative and bfloat16 sums
within one bfloat16 ulp (2**-7 relative). An ``all_reduce`` adds the ranks' values in
an order that depends on where an element sits in the buffer (gloo's ring splits it in
segments), so with three ranks a float sum may differ in its last bit between the
bucketed and the per-leaf plane, and from XLA's; a bfloat16 sum may also be rounded at
each step rather than once. Two ranks add in one order, so there they are equal.

The rendezvous is a ``FileStore`` under ``tmp_path`` (no port), every
``init_process_group`` has a timeout, and every worker a wall limit, so that a hang
fails one test instead of stalling the run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torchmetrics_tpu as tm
from torchmetrics_tpu.parallel import coalesce as JC
from torchmetrics_tpu.parallel import shard_map as shard_map_compat

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER_WALL_S = 120

_WORKER = textwrap.dedent(
    """
    import datetime, json, sys

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))

    import torchmetrics_tpu_torch as tt
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.parallel import sync as PS
    from tm_shared import rank_state

    CPU = {"device": "cpu"}
    rng = np.random.default_rng(42)  # the same stream everywhere; shard by slicing
    preds = rng.normal(size=(48, 5)).astype(np.float32)
    target = rng.integers(0, 5, 48).astype(np.int32)
    shard = 48 // world
    lo, hi = rank * shard, (rank + 1) * shard
    p, t = torch.from_numpy(preds[lo:hi]), torch.from_numpy(target[lo:hi])
    out = {}

    acc = tt.MulticlassAccuracy(5, average="micro", **CPU)
    acc.update(p, t)
    out["acc"] = acc.compute().item()  # sync_on_compute: the real process_sync

    confmat = tt.MulticlassConfusionMatrix(5, **CPU)
    confmat.update(p, t)
    out["confmat"] = confmat.compute().tolist()

    # a concat state whose length differs by rank: padded to the world maximum, trimmed
    cat = tt.CatMetric(**CPU)
    n_take = shard if rank == 0 else shard - 7
    cat.update(torch.from_numpy(preds[lo : lo + n_take, 0]))
    out["cat"] = cat.compute().tolist()

    acc.sync()
    acc.unsync()
    local_only = tt.MulticlassAccuracy(5, average="micro", sync_on_compute=False, **CPU)
    local_only.update(p, t)
    out["acc_local"] = local_only.compute().item()

    # a process with zero updates still takes part in the collectives
    empty_cat = tt.CatMetric(**CPU)
    if rank == 0:
        empty_cat.update(torch.from_numpy(preds[:4, 1]))
    out["empty_cat"] = empty_cat.compute().tolist()

    step_synced = tt.MulticlassAccuracy(5, average="micro", dist_sync_on_step=True, **CPU)
    out["acc_step_synced"] = step_synced(p, t).item()

    class MeanState(tt.Metric):  # the n-way fold of a "mean" state: mean of the stack
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("m", default=torch.zeros(()), dist_reduce_fx="mean")

        def _batch_state(self, x):
            return {"m": x.mean()}

        def _compute(self, state):
            return state["m"]

    mean_state = MeanState(**CPU)
    mean_state.update(torch.full((4,), rank + 1.0))
    out["mean_state"] = mean_state.compute().item()

    def collection():
        return MetricCollection({
            "acc": tt.MulticlassAccuracy(5, average="micro", **CPU),
            "f1": tt.MulticlassF1Score(5, average="macro", **CPU),
            "confmat": tt.MulticlassConfusionMatrix(5, **CPU),
        }, **CPU)

    coll = collection()
    coll.update(p, t)
    out["collection"] = {k: v.tolist() for k, v in coll.compute().items()}  # one coalesced pre-sync

    pure = collection().as_pure()
    reduced = pure.reduce(pure.update(pure.init(), p, t))
    out["pure_reduce"] = {n: {k: v.tolist() for k, v in s.items()} for n, s in reduced.items()}

    state, reductions = rank_state(rank, torch, "torch")
    coalesced = PS.reduce_states(state, reductions)
    per_leaf = PS.reduce_states_per_leaf(state, reductions)
    out["reduce"] = {k: [str(v.dtype).replace("torch.", ""), v.float().tolist()] for k, v in coalesced.items()}
    out["reduce_per_leaf"] = {k: [str(v.dtype).replace("torch.", ""), v.float().tolist()] for k, v in per_leaf.items()}

    dist.destroy_process_group()
    print("RESULT" + json.dumps(out))
    """
)

# one rank's state for reduce_many, built by the workers (torch) and the parent (jax)
_SHARED = textwrap.dedent(
    """
    import numpy as np


    def rank_state(rank, lib, kind):
        rng = np.random.default_rng(100 + rank)
        raw = {
            "a": (rng.normal(size=(3, 2)), "float32"), "i": (rng.integers(0, 100, (2, 2)), "int32"),
            "mx": (rng.normal(), "float32"), "mn": (rng.normal(size=4), "bfloat16"),
            "m": (rng.normal(size=3), "float32"), "bsum": (rng.normal(size=4), "bfloat16"),
            "cat": (rng.normal(size=2), "float32"), "cust": (rng.normal(size=2), "float32"),
            "skip": (rng.normal(size=2), "float32"),
        }
        if kind == "torch":
            state = {k: lib.as_tensor(np.asarray(v, np.float64)).to(getattr(lib, dt)) for k, (v, dt) in raw.items()}
            cust = lambda g: g.amax(0)
        else:
            state = {k: lib.asarray(np.asarray(v, np.float64)).astype(dt) for k, (v, dt) in raw.items()}
            cust = lambda g: g.max(axis=0)
        reductions = {"a": "sum", "i": "sum", "mx": "max", "mn": "min", "m": "mean", "bsum": "sum",
                      "cat": "cat", "cust": cust, "skip": None}
        return state, reductions
    """
)


def _run_workers(tmp_path, world, worker=_WORKER):
    """Start ``world`` processes of ``worker`` (argv: rank, world, init method) and return
    each one's ``RESULT`` JSON line, parsed."""
    (tmp_path / "worker.py").write_text(worker)
    (tmp_path / "tm_shared.py").write_text(_SHARED)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=os.pathsep.join([ROOT, str(tmp_path), env.get("PYTHONPATH", "")]),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(r), str(world), init],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)
    ]
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


def _jax_reduce_many(world):
    """The JAX package's reduce_many under shard_map: device r holds rank r's state."""
    namespace: dict = {}
    exec(_SHARED, namespace)
    states = [namespace["rank_state"](r, jnp, "jax")[0] for r in range(world)]
    reductions = namespace["rank_state"](0, jnp, "jax")[1]
    stacked = {k: jnp.stack([s[k] for s in states]) for k in states[0]}
    mesh = jax.make_mesh((world,), ("dp",), devices=jax.devices()[:world])
    fn = shard_map_compat(lambda s: JC.reduce_many([({k: v[0] for k, v in s.items()}, reductions)], "dp")[0],
                          mesh=mesh, in_specs=(P("dp"),), out_specs=P(), check_vma=False)
    return jax.jit(fn)(stacked), states


def _jax_pure_reduce(preds, target, world):
    coll = tm.MetricCollection({
        "acc": tm.MulticlassAccuracy(5, average="micro"),
        "f1": tm.MulticlassF1Score(5, average="macro"),
        "confmat": tm.MulticlassConfusionMatrix(5),
    })
    pure = coll.as_pure()
    mesh = jax.make_mesh((world,), ("dp",), devices=jax.devices()[:world])
    fn = shard_map_compat(lambda p, t: pure.reduce(pure.update(pure.init(), p, t), "dp"), mesh=mesh,
                          in_specs=(P("dp"), P("dp")), out_specs=P(), check_vma=False)
    return jax.jit(fn)(jnp.asarray(preds), jnp.asarray(target))


@pytest.mark.parametrize("world", [2, 3])
def test_gloo_process_group_sync_equals_jax(tmp_path, world):
    outs = _run_workers(tmp_path, world)

    rng = np.random.default_rng(42)
    preds = rng.normal(size=(48, 5)).astype(np.float32)
    target = rng.integers(0, 5, 48).astype(np.int32)
    ref = tm.MetricCollection({
        "acc": tm.MulticlassAccuracy(5, average="micro"),
        "f1": tm.MulticlassF1Score(5, average="macro"),
        "confmat": tm.MulticlassConfusionMatrix(5),
    }, compute_groups=False)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    want = {k: np.asarray(v) for k, v in ref.compute().items()}
    shard = 48 // world
    want_cat = np.concatenate([preds[r * shard : r * shard + (shard if r == 0 else shard - 7), 0] for r in range(world)])
    pure_want = _jax_pure_reduce(preds, target, world)
    reduce_want, rank_states = _jax_reduce_many(world)

    for rank, res in enumerate(outs):
        ctx = f"rank {rank} of {world}"
        np.testing.assert_allclose(res["acc"], want["acc"], rtol=0, atol=1e-6, err_msg=ctx)
        np.testing.assert_allclose(res["acc_step_synced"], want["acc"], rtol=0, atol=1e-6, err_msg=ctx)
        np.testing.assert_array_equal(res["confmat"], want["confmat"], err_msg=ctx)
        np.testing.assert_array_equal(np.float32(res["cat"]), want_cat, err_msg=ctx)  # rank order, bit for bit
        np.testing.assert_array_equal(np.float32(res["empty_cat"]), preds[:4, 1], err_msg=ctx)
        np.testing.assert_allclose(res["mean_state"], np.mean(np.arange(1, world + 1)), rtol=1e-7, err_msg=ctx)
        for key in ("acc", "f1"):
            np.testing.assert_allclose(res["collection"][key], want[key], rtol=0, atol=1e-6, err_msg=f"{ctx} {key}")
        np.testing.assert_array_equal(res["collection"]["confmat"], want["confmat"], err_msg=ctx)
        for name, state in pure_want.items():  # int32 tp/fp/tn/fn and confusion counts
            for key, value in state.items():
                np.testing.assert_array_equal(res["pure_reduce"][name][key], np.asarray(value), err_msg=f"{ctx} {name}")

        for key, value in reduce_want.items():
            want_v = np.asarray(jnp.asarray(value).astype(jnp.float32))
            if key == "skip":  # passthrough: every rank keeps its own value
                want_v = np.asarray(rank_states[rank]["skip"])
            for plane in ("reduce", "reduce_per_leaf"):
                dtype, got = res[plane][key]
                assert dtype == jnp.asarray(value).dtype.name, f"{ctx} {plane} {key}"
                if key in ("a", "m"):
                    np.testing.assert_allclose(got, want_v, rtol=1e-6, err_msg=f"{ctx} {plane} {key}")
                elif key == "bsum":
                    np.testing.assert_allclose(got, want_v, rtol=2.0**-7, err_msg=f"{ctx} {plane} {key}")
                else:  # integer sum, max, min, cat and the custom max
                    np.testing.assert_array_equal(np.float32(got), want_v, err_msg=f"{ctx} {plane} {key}")
            if world == 2:
                assert res["reduce"][key] == res["reduce_per_leaf"][key], f"{ctx} {key}"
    # the local values differ from the global ones: the sync really ran
    assert any(res["acc_local"] != res["acc"] for res in outs)
