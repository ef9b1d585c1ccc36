"""The port's sync planes (``torchmetrics_tpu_torch/parallel``), ``Metric``'s and
``MetricCollection``'s sync lifecycle, and the aggregators, held against the JAX package.

Worlds are simulated through the ``dist_sync_fn`` seam with replay fakes, as
``tests/test_coalesced_sync.py`` does: each collective is answered with what every
simulated rank's ``build_local_metadata``/``build_bucket_payload`` would ship. The same
numpy-seeded states go through the JAX plane with that file's ``CoalescedWorld`` and
through the port's plane with a port fake of the same design. Real processes are in
``tests/test_torch_multiprocess_sync.py``.

Tolerances: sync results, counts, max, min and cat values equal the JAX package's bit
for bit. Aggregator sums and means over a batch are held within 1e-6 relative: torch
and XLA may add a batch's values in another order.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_coalesced_sync import _FULL_REDUCTIONS, CoalescedWorld, _make_rank_state

import torchmetrics_tpu as tm
import torchmetrics_tpu_torch as tt
from torchmetrics_tpu import Metric as JaxMetric
from torchmetrics_tpu import MetricCollection as JaxCollection
from torchmetrics_tpu.parallel import coalesce as JC
from torchmetrics_tpu.parallel import sync as JS
from torchmetrics_tpu_torch import Metric, MetricCollection
from torchmetrics_tpu_torch.parallel import coalesce as PC
from torchmetrics_tpu_torch.parallel import sync as PS
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError, TransientRuntimeError

CPU = {"device": "cpu"}
PORT_REDUCTIONS = {**_FULL_REDUCTIONS, "custom": lambda stacked: torch.sum(stacked * 2.0, dim=0)}

# ------------------------------------------------------------------ converters


def to_torch(value):
    """A JAX array (or a list of them) as torch tensors of the same dtype and values."""
    if isinstance(value, list):
        return [to_torch(v) for v in value]
    arr = jnp.asarray(value)
    if arr.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(arr.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def dtype_name(value) -> str:
    if isinstance(value, torch.Tensor):
        return str(value.dtype).replace("torch.", "")
    return jnp.asarray(value).dtype.name


def as_f64(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().to(torch.float64).numpy()
    arr = jnp.asarray(value)
    return np.asarray(arr.astype(jnp.float32) if arr.dtype == jnp.bfloat16 else arr).astype(np.float64)


def assert_bitwise(port, ref, context=""):
    """One value of the port against the JAX package's: dtype, shape and every value."""
    assert dtype_name(port) == dtype_name(ref), f"{context}: {dtype_name(port)} vs {dtype_name(ref)}"
    p, r = as_f64(port), as_f64(ref)
    assert p.shape == r.shape, f"{context}: {p.shape} vs {r.shape}"
    np.testing.assert_array_equal(p, r, err_msg=context)


def assert_value_close(port, ref, context=""):
    """A computed value: counts bit for bit, ratios within 1e-6 (the port's classification
    tolerance: torch and XLA may round a division's operands in another order)."""
    assert dtype_name(port) == dtype_name(ref), f"{context}: {dtype_name(port)} vs {dtype_name(ref)}"
    if isinstance(port, torch.Tensor) and port.is_floating_point():
        np.testing.assert_allclose(as_f64(port), as_f64(ref), rtol=0, atol=1e-6, err_msg=context)
    else:
        assert_bitwise(port, ref, context)


def assert_state_bitwise(port: dict, ref: dict, context=""):
    assert set(port) == set(ref)
    for k in ref:
        if isinstance(ref[k], list) or isinstance(port[k], list):
            assert isinstance(port[k], list) and isinstance(ref[k], list), f"{context}:{k}"
            assert len(port[k]) == len(ref[k]), f"{context}:{k} list lengths"
            for i, (p, r) in enumerate(zip(port[k], ref[k])):
                assert_bitwise(p, r, f"{context}:{k}[{i}]")
        else:
            assert_bitwise(port[k], ref[k], f"{context}:{k}")


# --------------------------------------------------------------- world fakes


class PortCoalescedWorld:
    """The port's replay fake: call 0 answers the metadata collective, call k bucket
    k-1, each row built by the port's own payload builders for every simulated rank."""

    def __init__(self, states_per_rank, reductions):
        self.states_per_rank = states_per_rank
        self.reductions = reductions
        self.calls = 0
        self.metas = None

    def __call__(self, value, group=None):
        k = self.calls
        self.calls += 1
        if k == 0:
            self.metas = [PC.build_local_metadata([s], [self.reductions]) for s in self.states_per_rank]
            return [torch.from_numpy(m) for m in self.metas]
        return [PC.build_bucket_payload([s], [self.reductions], k - 1, self.metas) for s in self.states_per_rank]


def port_per_leaf_world(states_per_rank):
    """The per-leaf plane's replay: one call per leaf in dict order, each answering every
    rank's prepared (list states concatenated) value."""
    order = list(states_per_rank[0])
    counter = {"i": 0}

    def prepared(v):
        if isinstance(v, list):
            return torch.cat([torch.atleast_1d(x) for x in v]) if v else torch.zeros((0,), dtype=torch.float32)
        return v

    def fake(value, group=None):
        name = order[counter["i"] % len(order)]
        counter["i"] += 1
        return [prepared(s[name]) for s in states_per_rank]

    return fake


class CollectionWorld:
    """Replay of a collection's coalesced sync: every rank ships all its members' states."""

    def __init__(self, module, members_per_rank, wrap):
        self.module, self.members_per_rank, self.wrap = module, members_per_rank, wrap
        self.calls = 0

    def __call__(self, value, group=None):
        k = self.calls
        self.calls += 1
        states = [[m._state for m in ms] for ms in self.members_per_rank]
        reds = [[m._reductions for m in ms] for ms in self.members_per_rank]
        if k == 0:
            self.metas = [self.module.build_local_metadata(s, r) for s, r in zip(states, reds)]
            return [self.wrap(m) for m in self.metas]
        return [self.module.build_bucket_payload(s, r, k - 1, self.metas) for s, r in zip(states, reds)]


class ZeroRow:
    """Wraps a replay fake: rank ``dead``'s row of every collective comes back as zeros,
    the tombstone a rank that died mid-collective leaves behind."""

    def __init__(self, inner, dead, zeros_like):
        self.inner, self.dead, self.zeros_like = inner, dead, zeros_like

    def __call__(self, value, group=None):
        rows = list(self.inner(value, group))
        rows[self.dead] = self.zeros_like(rows[self.dead])
        return rows


def world_states(world, seed):
    rng = np.random.default_rng(seed)
    jax_states = [_make_rank_state(rng, r, world, empty_cat=(r == world - 1 and seed % 2 == 0)) for r in range(world)]
    return jax_states, [{k: to_torch(v) for k, v in s.items()} for s in jax_states]


# ------------------------------------------------------- coalesced parity


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coalesced_process_sync_equals_jax_bitwise(world, seed):
    """Every tag, f32/bf16/i32, uneven cat lengths, a zero-update rank, a custom callable
    and None: the port's coalesced plane equals the JAX plane bit for bit, and its own
    per-leaf plane."""
    jax_states, port_states = world_states(world, seed)
    jw, pw = CoalescedWorld(jax_states, _FULL_REDUCTIONS), PortCoalescedWorld(port_states, PORT_REDUCTIONS)
    ref = JS.process_sync(dict(jax_states[0]), _FULL_REDUCTIONS, dist_sync_fn=jw)
    got = PS.process_sync(dict(port_states[0]), PORT_REDUCTIONS, dist_sync_fn=pw)
    assert pw.calls == jw.calls == 4  # metadata + f32, bf16 and i32 buckets: no fallback
    assert_state_bitwise(got, ref, f"world={world} seed={seed}")
    per_leaf = PS._process_sync_per_leaf(dict(port_states[0]), PORT_REDUCTIONS,
                                         dist_sync_fn=port_per_leaf_world(port_states))
    assert_state_bitwise(got, per_leaf, f"port coalesced vs per-leaf world={world} seed={seed}")


def test_metadata_row_layout_matches_the_jax_header_and_leaf_records():
    """The port's row is the JAX row int for int: the same header (with
    ``len(COUNTER_FIELDS)`` counter fields), the same leaf records and the telemetry
    tails, zeros when no session is on."""
    from torchmetrics_tpu_torch.observability import COUNTER_FIELDS
    from torchmetrics_tpu_torch.observability.histograms import FLEET_VECTOR_LEN

    jax_states, port_states = world_states(2, 1)
    port_row = PC.build_local_metadata([port_states[0]], [PORT_REDUCTIONS])
    jax_row = JC.build_local_metadata([jax_states[0]], [_FULL_REDUCTIONS])
    n = PC._HEADER_LEN + len(port_states[0]) * PC._LEAF_REC_LEN + 2 * len(COUNTER_FIELDS) + 2 * FLEET_VECTOR_LEN
    assert port_row.dtype == np.int32 and port_row.shape == (n,)
    assert port_row[3] == len(COUNTER_FIELDS)
    np.testing.assert_array_equal(port_row, jax_row)


# ------------------------------------------------------- fallbacks and errors


def test_mangled_metadata_falls_back_like_jax():
    port = PS.process_sync({"v": torch.tensor(4.0)}, {"v": "mean"},
                           dist_sync_fn=lambda v, g=None: [torch.as_tensor(v) + i for i in range(3)])
    ref = JS.process_sync({"v": jnp.asarray(4.0)}, {"v": "mean"},
                          dist_sync_fn=lambda v, g=None: [jnp.asarray(v) + i for i in range(3)])
    assert_bitwise(port["v"], ref["v"])
    assert float(port["v"]) == 5.0


def test_injected_gather_rejecting_metadata_falls_back_like_jax():
    def port_fake(v, g=None):
        assert v.dtype == torch.float32, "this seam ships f32 states only"
        return [v, v]

    def jax_fake(v, g=None):
        assert jnp.asarray(v).dtype == jnp.float32, "this seam ships f32 states only"
        return [jnp.asarray(v), jnp.asarray(v)]

    port = PS.process_sync({"x": torch.tensor([1.0, 2.0])}, {"x": "sum"}, dist_sync_fn=port_fake)
    ref = JS.process_sync({"x": jnp.asarray([1.0, 2.0])}, {"x": "sum"}, dist_sync_fn=jax_fake)
    assert_bitwise(port["x"], ref["x"])


def test_mixed_dtypes_across_ranks_raise_like_jax():
    port_states = [{"x": torch.zeros(2, dtype=torch.float32)}, {"x": torch.zeros(2, dtype=torch.int32)}]
    jax_states = [{"x": jnp.zeros((2,), jnp.float32)}, {"x": jnp.zeros((2,), jnp.int32)}]
    with pytest.raises(ValueError, match="same dtype"):
        JS.process_sync(dict(jax_states[0]), {"x": "sum"}, dist_sync_fn=CoalescedWorld(jax_states, {"x": "sum"}))
    with pytest.raises(ValueError, match="same dtype"):
        PS.process_sync(dict(port_states[0]), {"x": "sum"},
                        dist_sync_fn=PortCoalescedWorld(port_states, {"x": "sum"}))


def test_unsupported_dtype_raises_after_the_metadata_exchange_like_jax():
    jw = CoalescedWorld([{"x": jnp.zeros((2,), jnp.complex64)}], {"x": "sum"})
    pw = PortCoalescedWorld([{"x": torch.zeros(2, dtype=torch.complex64)}], {"x": "sum"})
    with pytest.raises(ValueError, match="unsupported dtype"):
        JS.process_sync({"x": jnp.zeros((2,), jnp.complex64)}, {"x": "sum"}, dist_sync_fn=jw)
    with pytest.raises(ValueError, match="unsupported dtype"):
        PS.process_sync({"x": torch.zeros(2, dtype=torch.complex64)}, {"x": "sum"}, dist_sync_fn=pw)
    assert pw.calls == jw.calls == 1  # every rank completed the metadata collective first


@pytest.mark.parametrize("dead", [1, 2])
def test_tombstone_row_folds_the_survivors_only_like_jax(dead):
    """A rank whose rows are all zero is a tombstone: the fold covers the survivors, as
    the JAX plane's does, and equals a world of the survivors alone."""
    jax_states, port_states = world_states(3, 1)
    ref = JS.process_sync(dict(jax_states[0]), _FULL_REDUCTIONS, dist_sync_fn=ZeroRow(
        CoalescedWorld(jax_states, _FULL_REDUCTIONS), dead, jnp.zeros_like))
    JC.clear_dead_ranks()  # the JAX plane's process-global liveness table
    got = PS.process_sync(dict(port_states[0]), PORT_REDUCTIONS, dist_sync_fn=ZeroRow(
        PortCoalescedWorld(port_states, PORT_REDUCTIONS), dead, torch.zeros_like))
    assert_state_bitwise(got, ref, f"dead={dead}")
    survivors = [s for r, s in enumerate(port_states) if r != dead]
    alone = PS.process_sync(dict(port_states[0]), PORT_REDUCTIONS,
                            dist_sync_fn=PortCoalescedWorld(survivors, PORT_REDUCTIONS))
    assert_state_bitwise(got, alone, "tombstone vs survivors alone")


def test_all_zero_world_is_a_fallback_not_a_fold():
    rows = [np.zeros(len(PC.build_local_metadata([{"x": torch.zeros(2)}], [{"x": "sum"}])), np.int32)] * 2
    leaves = PC._prepare_leaves([{"x": torch.zeros(2)}], [{"x": "sum"}])
    with pytest.raises(PC.CoalesceFallback, match="tombstone"):
        PC._plan_from_rows(rows, leaves)


# ------------------------------------------------------- collective counts


@pytest.fixture
def counted_world_of_one(monkeypatch):
    """The real transport seam, counted: a world of one process, no group."""
    calls = []

    def rows(value, process_group=None):
        calls.append(tuple(torch.as_tensor(value).shape))
        return [torch.as_tensor(value)]

    monkeypatch.setattr(PC, "process_rows", rows)
    return calls


def test_collective_counts_match_jax_and_the_counted_seam(counted_world_of_one):
    jax_states, port_states = world_states(2, 7)
    counts = PC.collective_counts([port_states[0]], [PORT_REDUCTIONS])
    assert counts == JC.collective_counts([jax_states[0]], [_FULL_REDUCTIONS])
    assert counts["process_coalesced"] == 4 and counts["process_per_leaf"] == 2 * counts["leaves"] == 20
    PS.process_sync(dict(port_states[0]), PORT_REDUCTIONS)
    assert len(counted_world_of_one) == counts["process_coalesced"]  # metadata + f32 + bf16 + i32
    counted_world_of_one.clear()
    PS._process_sync_per_leaf(dict(port_states[0]), PORT_REDUCTIONS)
    assert len(counted_world_of_one) == counts["process_per_leaf"]  # shape exchange + payload per leaf


def test_weighted_mean_rides_the_sum_bucket_like_jax():
    vals = ([1.0, 5.0], [2.0], [10.0, 20.0, 30.0])
    jax_ms, port_ms = [tm.aggregation.MeanMetric() for _ in vals], [tt.MeanMetric(**CPU) for _ in vals]
    for jm, pm, v in zip(jax_ms, port_ms, vals):
        jm.update(jnp.asarray(v))
        pm.update(torch.tensor(v))
    jax_states, port_states = [dict(m._state) for m in jax_ms], [dict(m._state) for m in port_ms]
    pw = PortCoalescedWorld(port_states, port_ms[0]._reductions)
    got = PS.process_sync(dict(port_states[0]), port_ms[0]._reductions, dist_sync_fn=pw)
    ref = JS.process_sync(dict(jax_states[0]), jax_ms[0]._reductions,
                          dist_sync_fn=CoalescedWorld(jax_states, jax_ms[0]._reductions))
    assert pw.calls == 2  # one metadata and one f32 sum bucket for value and weight
    assert_state_bitwise(got, ref)
    np.testing.assert_allclose(float(got["mean_value"]) / float(got["weight"]), np.mean(sum(vals, [])), rtol=1e-6)


# ------------------------------------------------------- Metric lifecycle


class PortMean(Metric):
    def __init__(self, **kwargs):
        super().__init__(**{"device": "cpu", **kwargs})
        self.add_state("v", default=torch.zeros(()), dist_reduce_fx="mean")

    def _batch_state(self, x):
        return {"v": torch.as_tensor(x, dtype=torch.float32).mean()}

    def _compute(self, state):
        return state["v"]


class JaxMean(JaxMetric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("v", default=jnp.zeros(()), dist_reduce_fx="mean")

    def _batch_state(self, x):
        return {"v": jnp.asarray(x, jnp.float32).mean()}

    def _compute(self, state):
        return state["v"]


def offset_gather(world, port):
    """The classic fake of the seam: rank i holds value + i."""
    if port:
        return lambda v, g=None: [torch.as_tensor(v) + i for i in range(world)]
    return lambda v, g=None: [jnp.asarray(v) + i for i in range(world)]


@pytest.mark.parametrize("fx", ["sum", "mean", "max", "min", "cat"])
def test_fold_gathered_three_ranks_like_jax(fx):
    values = [[1.0, 4.0], [2.0, 2.0], [6.0, 0.0]]
    got = PS._fold_gathered([torch.tensor(v) for v in values], fx)
    assert_bitwise(got, JS._fold_gathered([jnp.asarray(v) for v in values], fx), fx)
    if fx == "mean":
        np.testing.assert_array_equal(got.numpy(), [3.0, 2.0])  # ((1+2)/2+6)/2 would be the pairwise error


@pytest.mark.parametrize("dtype", ["int32", "bfloat16", "bool"])
def test_fold_gathered_dtypes_follow_jnp(dtype):
    rng = np.random.default_rng(3)
    values = [rng.integers(0, 3, 4) for _ in range(3)]
    jax_vals = [jnp.asarray(v).astype(dtype) for v in values]
    for fx in ("sum", "mean", "max", "min"):
        if dtype == "bool" and fx == "mean":
            continue
        got = PS._fold_gathered([to_torch(v) for v in jax_vals], fx)
        assert_bitwise(got, JS._fold_gathered(jax_vals, fx), f"{dtype} {fx}")


@pytest.mark.parametrize("use_forward", [False, True])
def test_running_mean_state_is_exact_like_jax(use_forward):
    port, ref = PortMean(), JaxMean()
    for b in [1.0, 2.0, 6.0, 11.0]:
        for metric in (port, ref):
            metric(np.asarray(b)) if use_forward else metric.update(np.asarray(b))
    assert float(port.compute()) == float(ref.compute()) == 5.0


def test_merge_state_chains_weighted_by_update_count_like_jax():
    ports, refs = [PortMean() for _ in range(3)], [JaxMean() for _ in range(3)]
    for i, (p, r, v) in enumerate(zip(ports, refs, [1.0, 2.0, 6.0])):
        for _ in range(i + 1):  # 1, 2 and 3 updates: the weights differ
            p.update(np.asarray(v))
            r.update(np.asarray(v))
    ports[0].merge_state(ports[1])
    ports[0].merge_state(ports[2])
    refs[0].merge_state(refs[1])
    refs[0].merge_state(refs[2])
    np.testing.assert_allclose(float(ports[0].compute()), float(refs[0].compute()), rtol=1e-7)
    np.testing.assert_allclose(float(ports[0].compute()), (1 + 2 * 2 + 3 * 6) / 6, rtol=1e-7)
    assert ports[0]._update_count == refs[0]._update_count == 6


def test_merge_state_dict_chain_and_errors_like_jax():
    port, ref = PortMean(), JaxMean()
    port.update(np.asarray(10.0))
    ref.update(np.asarray(10.0))
    for v in (20.0, 30.0):
        port.merge_state({"v": torch.tensor(v)})
        ref.merge_state({"v": jnp.asarray(v)})
    assert float(port.compute()) == float(ref.compute()) == 20.0
    with pytest.raises(RuntimeError, match="unknown state keys"):
        port.merge_state({"w": torch.tensor(1.0)})
    with pytest.raises(ValueError, match="of type"):
        port.merge_state(tt.SumMetric(**CPU))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_metric_sync_mean_with_fake_gather_like_jax(world):
    port, ref = PortMean(dist_sync_fn=offset_gather(world, True)), JaxMean(dist_sync_fn=offset_gather(world, False))
    port.update(np.asarray(4.0))
    ref.update(np.asarray(4.0))
    port.sync(distributed_available=lambda: True)
    ref.sync(distributed_available=lambda: True)
    assert_bitwise(port._state["v"], ref._state["v"])
    assert float(port._state["v"]) == 4.0 + (world - 1) / 2
    port.unsync()
    assert float(port._state["v"]) == 4.0


@pytest.mark.parametrize("world", [2, 3])
def test_compute_syncs_then_restores_like_jax(world):
    port = tt.SumMetric(dist_sync_fn=offset_gather(world, True), distributed_available_fn=lambda: True, **CPU)
    ref = tm.aggregation.SumMetric(dist_sync_fn=offset_gather(world, False), distributed_available_fn=lambda: True)
    port.update(torch.tensor([1.0, 2.0]))
    ref.update(jnp.asarray([1.0, 2.0]))
    assert_bitwise(port.compute(), ref.compute())
    assert float(port.compute()) == sum(3.0 + i for i in range(world))
    assert not port._is_synced and float(port._state["sum_value"]) == 3.0


def test_cat_fold_through_the_fallback_like_jax():
    port = PS.process_sync({"x": torch.tensor([1.0, 2.0])}, {"x": "cat"},
                           dist_sync_fn=lambda v, g=None: [torch.as_tensor(v), torch.as_tensor(v) * 10])
    ref = JS.process_sync({"x": jnp.asarray([1.0, 2.0])}, {"x": "cat"},
                          dist_sync_fn=lambda v, g=None: [jnp.asarray(v), jnp.asarray(v) * 10])
    assert_bitwise(port["x"], ref["x"])


def test_weighted_mean_zero_total_keeps_left():
    assert float(PS.weighted_mean(torch.tensor(5.0), torch.tensor(7.0), 0.0, 0.0)) == float(
        JS.weighted_mean(jnp.asarray(5.0), jnp.asarray(7.0), 0.0, 0.0)) == 5.0


def test_update_state_of_a_mean_state_raises():
    with pytest.raises(TorchMetricsUserError, match="mean"):
        PortMean().update_state(PortMean().init_state(), np.asarray(1.0))


@pytest.mark.parametrize(
    "kwargs, match",
    [({"dist_sync_on_step": 1}, "dist_sync_on_step"), ({"sync_on_compute": "yes"}, "sync_on_compute"),
     ({"dist_sync_fn": 3}, "dist_sync_fn"), ({"compute_on_step": True}, "Unexpected keyword")],
)
def test_sync_keywords_are_validated_like_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        tm.aggregation.SumMetric(**kwargs)
    with pytest.raises(ValueError, match=match):
        tt.SumMetric(**kwargs, **CPU)


def test_sync_keywords_are_accepted():
    metric = tt.MulticlassAccuracy(5, sync_on_compute=False, process_group=None, dist_sync_on_step=False,
                                   dist_sync_fn=None, distributed_available_fn=lambda: False, **CPU)
    assert metric.sync_on_compute is False and metric.distributed_available_fn() is False


def test_double_sync_and_updates_while_synced_raise():
    metric = tt.SumMetric(dist_sync_fn=offset_gather(2, True), **CPU)
    metric.update(torch.tensor([1.0]))
    metric.sync(distributed_available=lambda: True)
    with pytest.raises(TorchMetricsUserError, match="already been synced"):
        metric.sync(distributed_available=lambda: True)
    with pytest.raises(TorchMetricsUserError, match="update"):
        metric.update(torch.tensor([1.0]))
    with pytest.raises(TorchMetricsUserError, match="forward"):
        metric(torch.tensor([1.0]))
    with pytest.raises(TorchMetricsUserError, match="merge_state"):
        metric.merge_state(tt.SumMetric(**CPU))
    metric.unsync()
    with pytest.raises(TorchMetricsUserError, match="un-synced"):
        metric.unsync()
    metric.sync(distributed_available=lambda: True)
    metric.reset()
    assert not metric._is_synced and metric._cache is None


def test_compute_inside_sync_context_does_not_sync_again():
    port = tt.SumMetric(dist_sync_fn=offset_gather(2, True), distributed_available_fn=lambda: True, **CPU)
    ref = tm.aggregation.SumMetric(dist_sync_fn=lambda v, g=None: [jnp.asarray(v), jnp.asarray(v) + 1],
                                   distributed_available_fn=lambda: True)
    port.update(torch.tensor([2.0]))
    ref.update(jnp.asarray([2.0]))
    with port.sync_context():
        assert_bitwise(port.compute(), ref.compute())  # 2 + 3, synced once
        assert float(port.compute()) == 5.0
    assert not port._is_synced and float(port._state["sum_value"]) == 2.0


def test_dist_sync_on_step_forward_returns_the_synced_value():
    port = tt.SumMetric(dist_sync_on_step=True, dist_sync_fn=offset_gather(2, True),
                        distributed_available_fn=lambda: True, **CPU)
    ref = tm.aggregation.SumMetric(dist_sync_on_step=True, dist_sync_fn=offset_gather(2, False),
                                   distributed_available_fn=lambda: True)
    assert_bitwise(port(torch.tensor([1.0, 2.0])), ref(jnp.asarray([1.0, 2.0])))
    assert float(port._state["sum_value"]) == 3.0 and not port._is_synced


# ------------------------------------------------------- collection lifecycle


def stat_collections(port_only=False):
    def build(ns, coll_kwargs):
        return {
            f"{cls}_{avg}": getattr(ns, cls)(5, average=avg, validate_args=False, **coll_kwargs)
            for cls in ("MulticlassAccuracy", "MulticlassF1Score", "MulticlassPrecision", "MulticlassRecall")
            for avg in ("micro", "macro", "weighted", "none")
        }

    port = MetricCollection(build(tt, CPU), **CPU)
    return port if port_only else (port, JaxCollection(build(tm, {}), compute_groups=False))


def classification_batch(seed, n=64):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 5)).astype(np.float32), rng.integers(0, 5, n).astype(np.int32)


def test_collection_of_16_syncs_in_one_collective_set(counted_world_of_one):
    port, ref = stat_collections()
    preds, target = classification_batch(3)
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    local = port.compute()
    port.sync(distributed_available=lambda: True)
    assert len(counted_world_of_one) == 2  # metadata + one int32 bucket for all 64 leaves
    assert all(m._is_synced for m in port.values())
    synced = port.compute()  # pre-synced members compute on their synced states
    port.unsync()
    assert not any(m._is_synced for m in port.values())
    want = ref.compute()
    for k in want:
        assert_bitwise(synced[k], local[k], k)  # a world of one: the sync is the identity
        assert_value_close(synced[k], want[k], k)


def test_collection_mixed_seams_fall_back_to_per_member_syncs():
    port = MetricCollection({"a": tt.SumMetric(dist_sync_fn=offset_gather(2, True), **CPU),
                             "b": tt.SumMetric(dist_sync_fn=offset_gather(3, True), **CPU)}, **CPU)
    ref = JaxCollection({"a": tm.aggregation.SumMetric(dist_sync_fn=offset_gather(2, False)),
                         "b": tm.aggregation.SumMetric(dist_sync_fn=offset_gather(3, False))}, compute_groups=False)
    port.update(torch.tensor([1.0]))
    ref.update(jnp.asarray([1.0]))
    port.sync(distributed_available=lambda: True)
    ref.sync(distributed_available=lambda: True)
    for k in ("a", "b"):
        assert_bitwise(port[k]._state["sum_value"], ref[k]._state["sum_value"], k)
    assert float(port["a"]._state["sum_value"]) == 3.0 and float(port["b"]._state["sum_value"]) == 6.0
    port.unsync()
    assert float(port["b"]._state["sum_value"]) == 1.0


def test_collection_compute_presyncs_once(counted_world_of_one):
    port, ref = stat_collections()
    preds, target = classification_batch(5, 32)
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    for m in port.values():
        m.distributed_available_fn = lambda: True
    values = port.compute()
    assert len(counted_world_of_one) == 2  # one coalesced sync for all 16 members
    assert not any(m._is_synced for m in port.values())
    want = ref.compute()
    assert set(values) == set(want)
    for k in want:
        assert_value_close(values[k], want[k], k)


def test_collection_double_sync_raises_and_async_names_the_streaming_plane():
    port = stat_collections(port_only=True)
    port.update(*map(torch.from_numpy, classification_batch(1, 8)))
    port.sync(distributed_available=lambda: True)
    with pytest.raises(TorchMetricsUserError, match="already been synced"):
        port.sync(distributed_available=lambda: True)
    port.unsync()
    handle = port.sync(async_=True)  # nothing distributed: the streaming plane's no-op handle
    assert type(handle).__module__ == "torchmetrics_tpu_torch.parallel.async_sync" and handle.commit() == []
    with pytest.raises(NotImplementedError, match="parallel/quantize.py"):
        port.sync(async_=True, sync_config=object())


def test_collection_sync_over_a_simulated_world_like_jax():
    """Three ranks through the port's replay fake: the collection's coalesced sync equals
    the JAX collection's over the JAX fake, on the same states (the JAX ranks' states,
    copied into the port's members)."""
    batches = [classification_batch(10 + r, 16) for r in range(3)]
    ports = [MetricCollection({"acc": tt.MulticlassAccuracy(5, average="micro", **CPU),
                               "cm": tt.MulticlassConfusionMatrix(5, **CPU), "cat": tt.CatMetric(**CPU),
                               "mean": tt.MeanMetric(**CPU), "max": tt.MaxMetric(**CPU)}, **CPU) for _ in batches]
    refs = [JaxCollection({"acc": tm.MulticlassAccuracy(5, average="micro"), "cm": tm.MulticlassConfusionMatrix(5),
                           "cat": tm.CatMetric(), "mean": tm.MeanMetric(), "max": tm.MaxMetric()},
                          compute_groups=False) for _ in batches]
    for port, ref, (preds, target) in zip(ports, refs, batches):
        for name in ("acc", "cm"):
            ref[name].update(jnp.asarray(preds), jnp.asarray(target))
        for name in ("cat", "mean", "max"):
            ref[name].update(jnp.asarray(preds[: len(target) - 2 * len(batches), 0]))
        for name in ("acc", "cm", "cat", "mean", "max"):
            port[name]._state = {k: to_torch(v) for k, v in ref[name]._state.items()}
    port_names, jax_names = list(ports[0].keys(keep_base=True)), list(refs[0].keys(keep_base=True))
    port_world = CollectionWorld(PC, [[p[n] for n in port_names] for p in ports], torch.from_numpy)
    jax_world = CollectionWorld(JC, [[r[n] for n in jax_names] for r in refs], jnp.asarray)
    ports[0].sync(dist_sync_fn=port_world, distributed_available=lambda: True)
    refs[0].sync(dist_sync_fn=jax_world, distributed_available=lambda: True)
    assert port_world.calls == jax_world.calls == 3  # metadata, f32 and int32 buckets
    for n in port_names:
        assert_state_bitwise(ports[0][n]._state, refs[0][n]._state, n)


# ------------------------------------------------------------- aggregators

AGGREGATORS = ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric", "RunningMean", "RunningSum"]
NAN_STRATEGIES = ["error", "warn", "ignore", "disable", 2.5]


@pytest.mark.parametrize("name", AGGREGATORS)
@pytest.mark.parametrize("nan_strategy", NAN_STRATEGIES, ids=str)
def test_aggregator_matches_jax(name, nan_strategy):
    rng = np.random.default_rng(len(name))
    batches = [rng.normal(size=int(rng.integers(2, 6))).astype(np.float32) for _ in range(7)]
    batches[3][1] = np.nan
    kwargs = {"window": 3} if name.startswith("Running") else {}
    port = getattr(tt, name)(nan_strategy=nan_strategy, **kwargs, **CPU)
    ref = getattr(tm, name)(nan_strategy=nan_strategy, **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "warn" is checked below
        for i, batch in enumerate(batches):
            if i == 3 and nan_strategy in ("error", "warn"):
                if nan_strategy == "error":
                    for metric, conv in ((port, torch.from_numpy), (ref, jnp.asarray)):
                        with pytest.raises(RuntimeError, match="nan"):
                            metric.update(conv(batch))
                    continue
                with pytest.warns(UserWarning, match="nan"):
                    port.update(torch.from_numpy(batch))
                ref.update(jnp.asarray(batch))
                continue
            port.update(torch.from_numpy(batch))
            ref.update(jnp.asarray(batch))
        got, want = port.compute(), ref.compute()
    assert dtype_name(got) == dtype_name(want) and tuple(got.shape) == tuple(jnp.asarray(want).shape)
    if name in ("MaxMetric", "MinMetric", "CatMetric"):
        assert_bitwise(got, want, name)
    else:  # sums over a batch: torch and XLA may add in another order
        np.testing.assert_allclose(as_f64(got), as_f64(want), rtol=1e-6, equal_nan=True)


def test_mean_metric_weights_like_jax():
    port, ref = tt.MeanMetric(**CPU), tm.MeanMetric()
    for value, weight in (([1.0, 3.0], 1.0), (5.0, 2.0), ([2.0, 4.0], [0.5, 3.0])):
        port.update(torch.tensor(value), weight=torch.tensor(weight))
        ref.update(jnp.asarray(value), weight=jnp.asarray(weight))
    np.testing.assert_allclose(float(port.compute()), float(ref.compute()), rtol=1e-6)


def test_aggregators_in_a_collection_sync_in_one_collective_set(counted_world_of_one):
    port = MetricCollection({"sum": tt.SumMetric(**CPU), "mean": tt.MeanMetric(**CPU), "max": tt.MaxMetric(**CPU),
                             "min": tt.MinMetric(**CPU), "cat": tt.CatMetric(**CPU),
                             "run": tt.RunningSum(window=2, **CPU)}, **CPU)
    port.update(torch.tensor([2.0, 4.0]))
    local = port.compute()
    port.sync(distributed_available=lambda: True)
    counts = PC.collective_counts([m._state for m in port.values()], [m._reductions for m in port.values()])
    assert len(counted_world_of_one) == counts["process_coalesced"] == 4  # metadata; f32, bool and int32 buckets
    synced = port.compute()
    port.unsync()
    for k in local:
        assert_bitwise(synced[k], local[k], k)


@pytest.mark.parametrize("name", AGGREGATORS)
def test_aggregator_forward_matches_jax(name):
    """``forward`` returns the batch's value (states the batch does not touch at their
    defaults, as the ring buffers are) and accumulates as ``update`` does."""
    rng = np.random.default_rng(len(name) + 1)
    kwargs = {"window": 2} if name.startswith("Running") else {}
    port, ref = getattr(tt, name)(**kwargs, **CPU), getattr(tm, name)(**kwargs)
    for _ in range(3):
        batch = rng.normal(size=4).astype(np.float32)
        got, want = port(torch.from_numpy(batch)), ref(jnp.asarray(batch))
        np.testing.assert_allclose(as_f64(got), as_f64(want), rtol=1e-6)
    np.testing.assert_allclose(as_f64(port.compute()), as_f64(ref.compute()), rtol=1e-6)


# ------------------------------------------------ a transient error of an injected gather


def _probe_gather(lib, first_error):
    """The seam's gather of a world of one that raises ``first_error`` on its first call."""
    calls = {"n": 0}

    def gather(value, group=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise first_error
        return [torch.as_tensor(value)] if lib is torch else [jnp.asarray(value)]

    return gather, calls


@pytest.mark.parametrize("first_error, propagates", [
    (ConnectionError("connection reset by peer"), True),
    (TransientRuntimeError("INTERNAL: stream terminated by RST_STREAM"), True),
    (AssertionError("expected a float32 state leaf"), False),
])
def test_process_sync_propagates_a_transient_gather_error_as_the_jax_package_does(first_error, propagates):
    """A transient error of an injected gather reaches the retry layer after one call; a
    deterministic one falls back to the per-leaf plane, in both packages."""
    state = {"s": np.arange(3, dtype=np.float32), "n": np.asarray(4, np.int32)}
    reductions = {"s": "sum", "n": "sum"}
    results = []
    for lib, sync, convert in ((torch, PS, torch.as_tensor), (jnp, JS, jnp.asarray)):
        gather, calls = _probe_gather(lib, first_error)
        local = {k: convert(v) for k, v in state.items()}
        if propagates:
            with pytest.raises(type(first_error)):
                sync.process_sync(local, reductions, dist_sync_fn=gather)
            results.append(calls["n"])
        else:
            synced = sync.process_sync(local, reductions, dist_sync_fn=gather)
            results.append((calls["n"], {k: as_f64(v).tolist() for k, v in synced.items()}))
    assert results[0] == results[1]
    if propagates:
        assert results[0] == 1
