"""The port's streaming plane (``torchmetrics_tpu_torch/streaming``, the window core of
``metric.py``, ``parallel/async_sync.py`` and ``MetricCollection.sync(async_=True)``)
against the JAX package's on the CPU.

Each test feeds the same numpy stream to the JAX wrapper and to the port's. Tolerances:
integer counts equal; float values within the JAX oracle's ``rtol=1e-5, atol=1e-6``
(``tests/test_streaming.py``), bfloat16 inputs within its ``rtol=2e-2, atol=1e-2``.
The JAX package runs without x64, so its integer window accumulators are float32 and
the port's int64: values are compared, dtypes pinned apart
(``test_window_dual_accumulator_dtype_policy``). Worlds are simulated through the
``dist_sync_fn`` seam with replay fakes of each package's coalesced protocol. The JAX
tests marked ``serving`` wait for the port's ``serving/``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
from torchmetrics_tpu import observability as jobs
from torchmetrics_tpu import streaming as jstream
from torchmetrics_tpu.parallel import coalesce as JC
from torchmetrics_tpu_torch import MetricCollection, aot
from torchmetrics_tpu_torch import observability as obs
from torchmetrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from torchmetrics_tpu_torch.classification import (MulticlassAccuracy, MulticlassConfusionMatrix,
                                                   MulticlassPrecision)
from torchmetrics_tpu_torch.metric import Metric, window_defaults, window_step, window_tier
from torchmetrics_tpu_torch.parallel import AsyncSyncHandle, clear_dead_ranks
from torchmetrics_tpu_torch.parallel import coalesce as PC
from torchmetrics_tpu_torch.regression import MeanSquaredError
from torchmetrics_tpu_torch.reliability import FlakyGather, ReliabilityConfig, RetryPolicy
from torchmetrics_tpu_torch.streaming import DriftMonitor, ExponentialDecay, SlidingWindow
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError, TransientRuntimeError

CPU = {"device": "cpu"}
RTOL, ATOL = 1e-5, 1e-6  # the JAX package's window oracle


@pytest.fixture(autouse=True)
def _planes_off():
    yield
    aot.disable()
    clear_dead_ranks()


# --------------------------------------------------------------------- helpers


def _np(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().double().numpy()
    return np.asarray(value, np.float64)


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, rtol, atol)
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _cls_batches(seed, n, num_classes=5, batch=16):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch, num_classes)).astype(np.float32),
             rng.integers(0, num_classes, batch).astype(np.int32)) for _ in range(n)]


def _t(batch):
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in batch)


def _j(batch):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in batch)


PORT = {
    "accuracy": lambda: MulticlassAccuracy(num_classes=5, average="micro", validate_args=False, **CPU),
    "precision": lambda: MulticlassPrecision(num_classes=5, average="macro", validate_args=False, **CPU),
    "confmat": lambda: MulticlassConfusionMatrix(num_classes=5, validate_args=False, **CPU),
    "sum": lambda: SumMetric(**CPU),
    "mean": lambda: MeanMetric(**CPU),
    "max": lambda: MaxMetric(**CPU),
    "min": lambda: MinMetric(**CPU),
    "mse": lambda: MeanSquaredError(**CPU),
    "cat": lambda: CatMetric(**CPU),
}
JAX = {
    "accuracy": lambda: jtm.classification.MulticlassAccuracy(num_classes=5, average="micro", validate_args=False),
    "precision": lambda: jtm.classification.MulticlassPrecision(num_classes=5, average="macro", validate_args=False),
    "confmat": lambda: jtm.classification.MulticlassConfusionMatrix(num_classes=5, validate_args=False),
    "sum": jtm.SumMetric,
    "mean": jtm.MeanMetric,
    "max": jtm.MaxMetric,
    "min": jtm.MinMetric,
    "mse": jtm.regression.MeanSquaredError,
    "cat": jtm.CatMetric,
}


def _run_pair(name, batches, window, **kw):
    """The same stream through the port's and the JAX package's SlidingWindow."""
    port = SlidingWindow(PORT[name](), window, **kw)
    ref = jstream.SlidingWindow(JAX[name](), window, **kw)
    for b in batches:
        port.update(*_t(b))
        ref.update(*_j(b))
    return port, ref


def _oracle(sw, factory, batches, rtol=RTOL, atol=ATOL):
    """The window-parity oracle: the window's value equals a fresh metric fed the
    trailing ``covered_updates()`` batches."""
    covered = sw.covered_updates()
    assert covered >= min(len(batches), sw.window)
    plain = factory()
    for b in batches[len(batches) - covered:] if covered else []:
        plain.update(*_t(b))
    _close(sw.compute(), plain.compute(), rtol, atol)


def _hold_pair(port, ref, rtol=RTOL, atol=ATOL):
    assert port.tier == ref.tier and port.covered_updates() == ref.covered_updates()
    _close(port.compute(), ref.compute(), rtol, atol)
    got, want = port.window_state(), ref.window_state()
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, list):
            _close(torch.cat(got[key]) if got[key] else torch.zeros(0),
                   jnp.concatenate(value) if value else np.zeros(0), rtol, atol)
        elif np.issubdtype(np.asarray(value).dtype, np.integer) or not got[key].is_floating_point():
            np.testing.assert_array_equal(_np(got[key]), _np(value))  # counts: equal
        else:
            _close(got[key], value, rtol, atol)


# ------------------------------------------------------------ window parity


@pytest.mark.parametrize("name", ["accuracy", "precision", "confmat"])
@pytest.mark.parametrize("tier", ["auto", "dual", "two_stack", "ring"])
@pytest.mark.parametrize("window,stream", [(4, 11), (5, 5), (8, 3)])
def test_window_parity_classification(name, tier, window, stream):
    """The oracle in every tier, for windows smaller than, equal to and larger than the
    stream, and the window equal to the JAX package's (counts equal)."""
    batches = _cls_batches(window * 100 + stream, stream)
    port, ref = _run_pair(name, batches, window, tier=tier)
    if tier == "auto":
        assert port.tier == "dual"
    _oracle(port, PORT[name], batches)
    _hold_pair(port, ref)


def test_window_ring_tier_exact_trailing_n():
    batches = _cls_batches(11, 11)
    sw = SlidingWindow(PORT["accuracy"](), 4, tier="ring")
    for i, b in enumerate(batches):
        sw.update(*_t(b))
        assert sw.covered_updates() == min(i + 1, 4)
    _oracle(sw, PORT["accuracy"], batches)


def _feed(kind, rng, n):
    out = []
    for _ in range(n):
        if kind == "scalar":
            out.append((float(rng.normal()),))
        elif kind == "vector":
            out.append((rng.normal(size=(4,)).astype(np.float32),))
        else:
            out.append((rng.normal(size=(6,)).astype(np.float32), rng.normal(size=(6,)).astype(np.float32)))
    return out


@pytest.mark.parametrize("name,feed,expect_tier", [
    ("sum", "scalar", "dual"), ("mean", "vector", "dual"), ("max", "scalar", "two_stack"),
    ("min", "vector", "two_stack"), ("mse", "pair", "dual"),
])
@pytest.mark.parametrize("tier", ["auto", "ring"])
def test_window_parity_aggregation_regression(name, feed, expect_tier, tier):
    batches = _feed(feed, np.random.default_rng(3), 9)
    port, ref = _run_pair(name, batches, 3, tier=tier)
    if tier == "auto":
        assert port.tier == expect_tier
    _oracle(port, PORT[name], batches)
    _hold_pair(port, ref)


@pytest.mark.parametrize("tier,pane", [("dual", None), ("two_stack", None), ("two_stack", 3), ("ring", None)])
def test_window_parity_tier_fuzz(tier, pane):
    """Awkward window and stream phases, a pane that does not divide the window (the
    two-stack rounds the effective window up)."""
    for window, stream in [(4, 11), (7, 23), (16, 5), (10, 37)]:
        batches = _cls_batches(window + stream, stream)
        port, ref = _run_pair("accuracy", batches, window, tier=tier, pane=pane)
        _oracle(port, PORT["accuracy"], batches)
        _hold_pair(port, ref)


@pytest.mark.parametrize("tier", ["dual", "two_stack", "ring"])
def test_window_parity_bf16_inputs(tier):
    batches = _cls_batches(7, 7)
    port = SlidingWindow(PORT["accuracy"](), 3, tier=tier)
    ref = jstream.SlidingWindow(JAX["accuracy"](), 3, tier=tier)
    for p, t in batches:
        port.update(torch.from_numpy(p).to(torch.bfloat16), torch.from_numpy(t))
        ref.update(jnp.asarray(p).astype(jnp.bfloat16), jnp.asarray(t))
    _close(port.compute(), ref.compute(), rtol=2e-2, atol=1e-2)


def test_window_parity_list_state_bounded():
    """CatMetric: cat contributions in a bounded host ring, equal to the trailing window
    and to the JAX package's, and never more than ``window`` of them."""
    vals = [(np.full((3,), float(i), np.float32),) for i in range(9)]
    port, ref = _run_pair("cat", vals, 4)
    assert port.tier == "ring"
    _oracle(port, PORT["cat"], vals, rtol=0, atol=0)
    _hold_pair(port, ref, rtol=0, atol=0)
    live = [b for b in port._append_ring if b is not None]
    assert len(live) == 4 and sum(len(b.get("value", [])) for b in live) == 4


class PortLastValue(Metric):
    """A custom merge that keeps the incoming side: the window folds through it in
    stream order."""

    def __init__(self):
        super().__init__(**CPU)
        self.add_state("v", default=torch.zeros(()), dist_reduce_fx=None)
        self.add_state("seen", default=torch.zeros(()), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"v": torch.as_tensor(x, dtype=torch.float32), "seen": torch.ones(())}

    def _merge(self, a, b):
        return {"v": b.get("v", a["v"]), "seen": a["seen"] + b.get("seen", 0.0)}

    def _compute(self, state):
        return state["v"]


class JaxLastValue(jtm.Metric):
    def __init__(self):
        super().__init__()
        self.add_state("v", default=np.zeros((), np.float32), dist_reduce_fx=None)
        self.add_state("seen", default=np.zeros((), np.float32), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"v": jnp.asarray(x, jnp.float32), "seen": jnp.ones((), jnp.float32)}

    def _merge(self, a, b):
        return {"v": b.get("v", a["v"]), "seen": a["seen"] + b.get("seen", 0.0)}

    def _compute(self, state):
        return state["v"]


def test_window_custom_merge_stream_order():
    port, ref = SlidingWindow(PortLastValue(), 3), jstream.SlidingWindow(JaxLastValue(), 3)
    for x in [1.0, 2.0, 3.0, 4.0]:
        port.update(x)
        ref.update(x)
    assert port.tier == ref.tier == "ring"
    assert float(port.compute()) == float(ref.compute()) == 4.0
    assert float(port.window_state()["seen"]) == float(np.asarray(ref.window_state()["seen"])) == 3.0


def test_window_forward_batch_value_and_reset():
    for tier in ("dual", "ring"):
        sw = SlidingWindow(SumMetric(**CPU), 2, tier=tier)
        assert float(sw.forward(5.0)) == 5.0  # the batch's own value
        sw.update(7.0)
        assert float(sw.compute()) == 12.0
        sw.reset()
        assert sw._ring is None and sw._wstate is None and sw.update_count == 0
        sw.update(1.0)
        assert float(sw.compute()) == 1.0


def _window_counters(lib, rec, tag):
    snap = rec.counters.snapshot()
    keys = {k: v for k, v in snap.per_key.items() if k.endswith(f".{tag}")}
    return {"compiles": sum(v["compiles"] for v in keys.values()),
            "dispatches": sum(v["compiles"] + v["cache_hits"] + v["aot_hits"] for v in keys.values()),
            "window_rolls": snap["window_rolls"], "window_rotations": snap["window_rotations"],
            "events": [(e.tag, e.payload["window"], e.payload["tier"]) for e in rec.events_of("window_roll")]}


@pytest.mark.parametrize("tier,tag", [("dual", "wdual"), ("ring", "wupdate")])
def test_window_one_compile_and_telemetry(tier, tag):
    """One fresh signature serves every windowed update under the tier's tag; rolls,
    rotations and the window_roll events equal the JAX package's."""
    batches = _cls_batches(5, 10)
    got = {}
    for lib, session, factory, conv in ((jstream, jobs, JAX["accuracy"], _j), (None, obs, PORT["accuracy"], _t)):
        with session.telemetry_session() as rec:
            sw = (lib.SlidingWindow if lib else SlidingWindow)(factory(), 4, tier=tier)
            for b in batches:
                sw.update(*conv(b))
        got[lib is None] = _window_counters(lib, rec, tag)
    assert got[True] == got[False]
    assert got[True]["compiles"] == 1 and got[True]["dispatches"] == 10 and got[True]["window_rolls"] == 10
    assert got[True]["window_rotations"] == (2 if tier == "dual" else 0)


def test_window_rejects_host_and_composition():
    with pytest.raises(TorchMetricsUserError):
        SlidingWindow(SumMetric(**CPU) + SumMetric(**CPU), 4)  # no pure core
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    with pytest.raises(TorchMetricsUserError):
        SlidingWindow(MeanAveragePrecision(**CPU), 4)  # a host metric
    with pytest.raises(ValueError):
        SlidingWindow(SumMetric(**CPU), 0)
    sw = SlidingWindow(SumMetric(**CPU), 2)
    with pytest.raises(TorchMetricsUserError):
        sw.merge_state({"sum_value": 1.0})


# ------------------------------------------------------------------- decay


def _decay_pair(name, batches, **kw):
    port = ExponentialDecay(PORT[name](), **kw)
    ref = jstream.ExponentialDecay(JAX[name](), **kw)
    for b in batches:
        port.update(*_t(b))
        ref.update(*_j(b))
    return port, ref


def test_decay_sum_closed_form():
    d, xs = 0.75, [1.0, -2.0, 3.0, 0.5, 4.0]
    port, ref = _decay_pair("sum", [(x,) for x in xs], decay=d)
    n = len(xs)
    np.testing.assert_allclose(float(port.compute()), sum(d ** (n - 1 - i) * x for i, x in enumerate(xs)), rtol=1e-6)
    np.testing.assert_allclose(float(port.decayed_count), sum(d**k for k in range(n)), rtol=1e-6)
    _close(port.compute(), ref.compute())
    _close(port.decayed_count, ref.decayed_count)


def test_decay_mean_weighted_average():
    d, xs = 0.5, [2.0, 4.0, 8.0]
    port, ref = _decay_pair("mean", [(x,) for x in xs], decay=d)
    n = len(xs)
    num = sum(d ** (n - 1 - i) * x for i, x in enumerate(xs))
    np.testing.assert_allclose(float(port.compute()), num / sum(d**k for k in range(n)), rtol=1e-6)
    _close(port.compute(), ref.compute())


def test_decay_halflife_semantics():
    port, ref = _decay_pair("sum", [(1.0,), (0.0,), (0.0,)], halflife=2.0)
    assert port.decay == pytest.approx(2.0 ** (-0.5)) == ref.decay
    np.testing.assert_allclose(float(port.compute()), 0.5, rtol=1e-6)
    _close(port.compute(), ref.compute())


def test_decay_accuracy_constant_stream():
    batch = _cls_batches(9, 1)[0]
    port, ref = _decay_pair("accuracy", [batch] * 6, halflife=8)
    plain = PORT["accuracy"]()
    plain.update(*_t(batch))
    _close(port.compute(), plain.compute())
    _close(port.compute(), ref.compute())
    # max leaves keep their plain merge, int counts become float32
    port, ref = _decay_pair("max", [(3.0,), (1.0,), (2.0,)], decay=0.5)
    assert float(port.compute()) == float(ref.compute()) == 3.0


def test_decay_one_compile_and_rejections():
    with obs.telemetry_session() as rec:
        ed = ExponentialDecay(SumMetric(**CPU), decay=0.9)
        for x in range(8):
            ed.update(float(x))
    assert _window_counters(None, rec, "dupdate")["compiles"] == 1
    with pytest.raises(TorchMetricsUserError):
        ExponentialDecay(CatMetric(**CPU), decay=0.9)
    with pytest.raises(TorchMetricsUserError):
        ExponentialDecay(PortLastValue(), decay=0.9)
    with pytest.raises(ValueError):
        ExponentialDecay(SumMetric(**CPU), decay=1.5)
    with pytest.raises(ValueError):
        ExponentialDecay(SumMetric(**CPU))


# ------------------------------------------------- async double-buffered sync


class PortSimWorld:
    """The port's replay ``dist_sync_fn``: N simulated ranks answering the coalesced
    plane's collectives; a metadata row restarts the bucket sequence, so a retried
    sync replays from the top."""

    MAGIC = 0x436F414C

    def __init__(self, ranks):
        self.ranks = ranks  # [(states_list, reductions_list), ...]
        self.metas = None
        self.bucket_i = 0
        self.calls = 0

    def __call__(self, value, group=None):
        self.calls += 1
        v = torch.as_tensor(value)
        if v.dtype == torch.int32 and v.dim() == 1 and v.numel() >= 4 and int(v[0]) == self.MAGIC:
            self.metas = [PC.build_local_metadata(s, r) for s, r in self.ranks]
            self.bucket_i = 0
            return [torch.from_numpy(m) for m in self.metas]
        k = self.bucket_i
        self.bucket_i += 1
        return [PC.build_bucket_payload(s, r, k, self.metas) for s, r in self.ranks]


class JaxSimWorld(PortSimWorld):
    def __call__(self, value, group=None):
        self.calls += 1
        v = np.asarray(value)
        if v.dtype.kind == "i" and v.ndim == 1 and v.size >= 4 and int(v[0]) == self.MAGIC:
            self.metas = [JC.build_local_metadata(s, r) for s, r in self.ranks]
            self.bucket_i = 0
            return [jnp.asarray(m) for m in self.metas]
        k = self.bucket_i
        self.bucket_i += 1
        return [JC.build_bucket_payload(s, r, k, self.metas) for s, r in self.ranks]


def _freeze(coll):
    return ([{k: (list(v) if isinstance(v, list) else v) for k, v in m._state.items()} for m in coll.values()],
            [m._reductions for m in coll.values()])


def _coll(port=True, reliability=None):
    if port:
        return MetricCollection({"acc": MulticlassAccuracy(num_classes=5, average="micro", validate_args=False,
                                                           reliability=reliability, **CPU),
                                 "s": SumMetric(**CPU), "cat": CatMetric(**CPU)}, compute_groups=False, **CPU)
    return jtm.MetricCollection({"acc": JAX["accuracy"](), "s": jtm.SumMetric(), "cat": jtm.CatMetric()},
                                compute_groups=False)


def _feed_coll(coll, seed, port=True, n=2, extra=None):
    conv = _t if port else _j
    rng = np.random.default_rng(seed)
    for b in _cls_batches(seed, n):
        coll["acc"].update(*conv(b))
    coll["s"].update(3.0)
    coll["cat"].update(*conv((rng.normal(size=(2,)).astype(np.float32),)))
    if extra is not None:
        coll["s"].update(extra)
    return coll


def _states(coll):
    return {key: {k: (np.concatenate([_np(x) for x in v]) if isinstance(v, list) else _np(v))
                  for k, v in m._state.items()} for key, m in coll.items(keep_base=True)}


def _states_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].keys() == b[key].keys()
        for name in a[key]:
            np.testing.assert_array_equal(a[key][name], b[key][name], err_msg=f"{key}.{name}")


def test_async_sync_bitwise_parity_with_overlap():
    """The async commit equals the blocking sync bit for bit while the collection keeps
    updating, unsync restores the overlap-updated states, and both equal the JAX
    package's async sync of the same stream."""
    force = lambda: True  # noqa: E731
    remote = _feed_coll(_coll(), 99, n=3, extra=11.0)
    blocking = _feed_coll(_coll(), 1)
    blocking.sync(distributed_available=force, dist_sync_fn=PortSimWorld([_freeze(blocking), _freeze(remote)]))
    coll = _feed_coll(_coll(), 1)
    handle = coll.sync(async_=True, distributed_available=force,
                       dist_sync_fn=PortSimWorld([_freeze(coll), _freeze(remote)]))
    assert isinstance(handle, AsyncSyncHandle)
    coll["s"].update(100.0)
    coll["cat"].update(torch.tensor([42.0]))
    handle.commit()
    assert handle.committed and handle.gather_s >= 0.0 and not handle.used_fallback
    _states_equal(_states(coll), _states(blocking))
    assert float(coll["s"]._state["sum_value"]) == pytest.approx(17.0)
    # the JAX package's async sync of the same stream
    jremote = _feed_coll(_coll(False), 99, port=False, n=3, extra=11.0)
    jcoll = _feed_coll(_coll(False), 1, port=False)
    jhandle = jcoll.sync(async_=True, distributed_available=force,
                         dist_sync_fn=JaxSimWorld([_freeze(jcoll), _freeze(jremote)]))
    jcoll["s"].update(100.0)
    jcoll["cat"].update(jnp.asarray([42.0], jnp.float32))
    jhandle.commit()
    _states_equal(_states(coll), _states(jcoll))
    coll.unsync()
    jcoll.unsync()
    assert float(coll["s"]._state["sum_value"]) == pytest.approx(103.0) and not coll["s"]._is_synced
    _states_equal(_states(coll), _states(jcoll))


def test_async_sync_flaky_gather_rollback_mid_overlap():
    coll = _feed_coll(_coll(), 2)
    flaky = FlakyGather(inner=PortSimWorld([_freeze(coll), _freeze(_feed_coll(_coll(), 99, n=3))]), fail_times=10)
    before = _states(coll)
    handle = coll.sync(async_=True, distributed_available=lambda: True, dist_sync_fn=flaky)
    coll["s"].update(50.0)  # an overlap update: it must survive the rollback
    with pytest.raises(TransientRuntimeError):
        handle.commit()
    assert not any(m._is_synced for m in coll.values())
    before["s"]["sum_value"] = before["s"]["sum_value"] + 50.0
    _states_equal(_states(coll), before)


def test_async_sync_flaky_gather_retry_recovers():
    rel = ReliabilityConfig(retry=RetryPolicy(max_attempts=3, backoff_base=0.001))
    remote = _feed_coll(_coll(), 77)
    plain = _feed_coll(_coll(), 4)
    plain.sync(distributed_available=lambda: True, dist_sync_fn=PortSimWorld([_freeze(plain), _freeze(remote)]))
    coll = _feed_coll(_coll(reliability=rel), 4)
    flaky = FlakyGather(inner=PortSimWorld([_freeze(coll), _freeze(remote)]), fail_times=1)
    coll.sync(async_=True, distributed_available=lambda: True, dist_sync_fn=flaky).commit()
    assert flaky.failures == 1
    _states_equal(_states(coll), _states(plain))


def test_async_sync_noop_and_contracts():
    coll = _feed_coll(_coll(), 6)
    handle = coll.sync(async_=True)  # nothing distributed: a no-op handle
    assert handle.done and handle.commit() == []
    assert not any(m._is_synced for m in coll.values())
    with pytest.raises(TorchMetricsUserError):
        handle.commit()  # one-shot
    mixed = _feed_coll(_coll(), 6)
    mixed["s"].dist_sync_fn = lambda v, g: [v]
    with pytest.raises(TorchMetricsUserError):
        mixed.sync(async_=True, distributed_available=lambda: True)
    with pytest.raises(NotImplementedError, match="parallel/quantize.py"):
        coll.sync(async_=True, sync_config=object())
    with pytest.raises(NotImplementedError, match="parallel/quantize.py"):
        AsyncSyncHandle([], [], sync_config=object())


def test_async_sync_telemetry_overlap_accounting():
    """The counters and the async_sync event, equal in shape to the JAX package's."""
    got = {}
    for port in (True, False):
        coll = _feed_coll(_coll(port), 8, port=port)
        remote = _feed_coll(_coll(port), 99, port=port, n=3)
        world = (PortSimWorld if port else JaxSimWorld)([_freeze(coll), _freeze(remote)])
        with (obs if port else jobs).telemetry_session() as rec:
            handle = coll.sync(async_=True, distributed_available=lambda: True, dist_sync_fn=world)
            handle.commit()
            coll.unsync()
        snap = rec.counters.snapshot()
        events = rec.events_of("async_sync")
        got[port] = {"async_syncs": snap["async_syncs"], "sync_calls": snap["sync_calls"], "events": len(events),
                     "collectives": events[0].payload["collectives"], "fallback": events[0].payload["fallback"],
                     "payload_bytes": events[0].payload.get("payload_bytes")}
        assert 0.0 <= events[0].payload["overlap_pct"] <= 100.0
    assert got[True] == got[False]
    assert got[True]["async_syncs"] == 1 and got[True]["collectives"] >= 1 and not got[True]["fallback"]


def test_async_handle_failed_commit_not_locked():
    coll = _feed_coll(_coll(), 23)
    flaky = FlakyGather(inner=PortSimWorld([_freeze(coll), _freeze(_feed_coll(_coll(), 99, n=3))]), fail_times=10)
    handle = coll.sync(async_=True, distributed_available=lambda: True, dist_sync_fn=flaky)
    with pytest.raises(TransientRuntimeError):
        handle.commit()
    assert not handle.committed
    with pytest.raises(TransientRuntimeError):  # the real error again, not "already ran"
        handle.commit()


def test_async_handle_bare_usage_and_a_healthy_sync_leaves_no_dead_ranks():
    state = {"s": torch.tensor([1.0, 2.0])}
    handle = AsyncSyncHandle([state], [{"s": "sum"}])  # a world of one: the identity fold
    synced = handle.result()
    assert torch.equal(synced[0]["s"], state["s"])
    assert handle.commit() is synced and handle.overlap_pct >= 0.0
    assert PC.dead_ranks() == {} and not handle.degraded and handle.dead_ranks == {}
    PC._DEAD_RANKS[3] = 1
    assert PC.dead_ranks() == {3: 1}
    clear_dead_ranks()
    assert PC.dead_ranks() == {}


def test_streaming_wrappers_refuse_distributed_sync():
    for port in (True, False):
        lib = (SlidingWindow, ExponentialDecay) if port else (jstream.SlidingWindow, jstream.ExponentialDecay)
        base = (lambda: SumMetric(**CPU)) if port else jtm.SumMetric
        sw = lib[0](base(), 2)
        sw.update(1.0)
        sw.sync()  # nothing distributed: a no-op
        assert not sw._is_synced
        sw.update(2.0)
        with pytest.raises(Exception, match="stream-local") as err:
            sw.sync(distributed_available=lambda: True)
        assert type(err.value).__name__ == "TorchMetricsUserError"
        ed = lib[1](base(), decay=0.5)
        ed.update(1.0)
        with pytest.raises(Exception, match="stream-local"):
            ed.sync(distributed_available=lambda: True)


# ------------------------------------------------------------- drift monitor


def _drift_run(port):
    o = obs if port else jobs
    rules = (o.SloRule(name="drift_watch", expr="drift('acc_drift') > 0.5", window=60.0, cooldown=0.0,
                       severity="critical"),)
    with o.telemetry_session(o.TelemetryConfig(slo_rules=rules, slo_eval_on_sync=False)) as rec:
        dm = (DriftMonitor if port else jstream.DriftMonitor)(
            PORT["mean"]() if port else jtm.MeanMetric(), reference_window=4, test_window=2, threshold=0.5,
            name="acc_drift", eval_every=1)
        for v in [1.0, 1.0, 1.0, 1.0]:
            dm.update(v)
        assert dm.reference_value is not None
        for v in [1.0, 1.0]:
            dm.update(v)
        assert dm.last is not None and not dm.breached
        for v in [9.0, 9.0]:
            dm.update(v)
        # the eighth update rolled the reference to mean(1, 1, 9, 9) = 5 before it scored
        assert dm.breached and dm.last["score"] == pytest.approx(4.0)
        assert rec.drift_score("acc_drift") == pytest.approx(4.0)
        alerts = rec.evaluate_slos()
        assert any(a["rule"] == "drift_watch" and a["kind"] == "breach" for a in alerts)
    snap = rec.counters.snapshot()
    drift_alerts = [e for e in rec.events_of("alert") if e.tag == "drift"]
    assert drift_alerts and drift_alerts[0].payload["kind"] == "drift"
    return snap["drift_evals"], snap["drift_breaches"], [round(h["score"], 6) for h in dm.history]


def test_drift_monitor_breach_and_slo_namespace():
    got, want = _drift_run(True), _drift_run(False)
    assert got == want and got[0] >= 4 and got[1] >= 2


def test_drift_monitor_rolling_reference_and_reset():
    dm = DriftMonitor(SumMetric(**CPU), reference_window=3, test_window=2, threshold=0.1, eval_every=0)
    assert dm.evaluate() is None
    for v in [1.0, 1.0, 1.0]:
        dm.update(v)
    assert float(dm.reference_value) == pytest.approx(3.0)
    for v in [2.0, 2.0, 2.0]:
        dm.update(v)
    assert float(dm.reference_value) == pytest.approx(6.0)
    assert dm.evaluate()["breached"]
    dm.reset()
    assert dm.reference_value is None and dm.last is None
    with pytest.raises(ValueError):
        DriftMonitor(SumMetric(**CPU), mode="bogus")


# ------------------------------------------------- tiers, dtypes, memory, AOT


class PortIntCount(Metric):
    def __init__(self):
        super().__init__(**CPU)
        self.add_state("n", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"n": torch.as_tensor(x, dtype=torch.int32).sum()}

    def _compute(self, state):
        return state["n"]


class JaxIntCount(jtm.Metric):
    def __init__(self):
        super().__init__()
        self.add_state("n", default=np.zeros((), np.int32), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"n": jnp.asarray(x, jnp.int32).sum()}

    def _compute(self, state):
        return state["n"]


class PortProduct(Metric):
    def __init__(self):
        super().__init__(**CPU)
        self.add_state("prod", default=torch.ones(()), dist_reduce_fx=lambda s: torch.prod(s, dim=0))

    def _batch_state(self, x):
        return {"prod": torch.as_tensor(x, dtype=torch.float32)}

    def _compute(self, state):
        return state["prod"]


def test_window_tier_selection_pinned():
    from torchmetrics_tpu.metric import window_tier as jwindow_tier

    for name in ("sum", "mean", "mse", "accuracy", "confmat", "max", "min", "cat"):
        assert window_tier(PORT[name]()) == jwindow_tier(JAX[name]()), name
    assert window_tier(PortIntCount()) == "dual" and window_tier(PortProduct()) == "two_stack"
    assert window_tier(PortLastValue()) == "ring"
    assert SlidingWindow(MaxMetric(**CPU), 8).tier == "two_stack"
    assert SlidingWindow(CatMetric(**CPU), 8).tier == "ring"
    sw = SlidingWindow(SumMetric(**CPU), 8, pane=1)
    assert sw.tier == "two_stack" and sw.pane == 1
    with pytest.raises(ValueError):
        SlidingWindow(SumMetric(**CPU), 8, tier="dual", pane=1)
    with pytest.raises(TorchMetricsUserError):
        SlidingWindow(CatMetric(**CPU), 8, pane=1)


def test_window_tier_forced_rejections():
    for build, kw in ((lambda: MaxMetric(**CPU), {"tier": "dual"}), (PortLastValue, {"tier": "two_stack"}),
                      (lambda: CatMetric(**CPU), {"tier": "dual"}), (PortProduct, {"tier": "dual"})):
        with pytest.raises(TorchMetricsUserError):
            SlidingWindow(build(), 4, **kw)
    with pytest.raises(ValueError):
        SlidingWindow(SumMetric(**CPU), 4, tier="bogus")
    with pytest.raises(ValueError):
        SlidingWindow(MaxMetric(**CPU), 4, tier="two_stack", pane=0)
    assert SlidingWindow(MaxMetric(**CPU), 4, tier="ring").tier == "ring"
    base = MaxMetric(**CPU)
    SlidingWindow(base, 4, pane=2)
    with pytest.raises(TorchMetricsUserError, match="one two-stack depth"):
        SlidingWindow(base, 4, pane=1)


def test_window_parity_callable_reduction_two_stack():
    sw = SlidingWindow(PortProduct(), 4, pane=2)
    assert sw.tier == "two_stack"
    vals = [1.5, 2.0, 0.5, 3.0, 1.25, 0.8, 2.5]
    for v in vals:
        sw.update(v)
    np.testing.assert_allclose(float(sw.compute()), float(np.prod(vals[-sw.covered_updates():])), rtol=1e-6)


def test_window_dual_accumulator_dtype_policy():
    """Integer sum leaves accumulate in int64 in the port (exact past 2**24) and in
    float32 in the JAX package without x64: the values are equal, the dtypes pinned."""
    for kw, n, width in (({}, 12, 3), ({"tier": "two_stack", "pane": 2}, 9, 2)):
        port = SlidingWindow(PortIntCount(), 5 if not kw else 6, **kw)
        ref = jstream.SlidingWindow(JaxIntCount(), 5 if not kw else 6, **kw)
        for _ in range(n):
            port.update(np.full((width,), 1, np.int32))
            ref.update(np.full((width,), 1, np.int32))
        assert port._wstate["n"].dtype == torch.int64 and ref._wstate["n"].dtype == jnp.float32
        assert int(port.compute()) == width * port.covered_updates() == int(np.asarray(ref.compute()))
    ring = SlidingWindow(PortIntCount(), 4, tier="ring")
    ring.update(np.full((2,), 1, np.int32))
    assert ring._ring["n"].dtype == torch.int32  # one update's contribution a bucket
    big = SlidingWindow(PortIntCount(), 4)
    for _ in range(3):
        big.update(np.full((1,), 2**24 + 1, np.int32))
    assert int(big.compute()) == 3 * (2**24 + 1)  # float32 would round


def test_window_state_memory_window_independent():
    acc = PORT["accuracy"]
    assert SlidingWindow(acc(), 1_000).state_memory()["total_bytes"] == \
        SlidingWindow(acc(), 100_000).state_memory()["total_bytes"]
    assert SlidingWindow(MaxMetric(**CPU), 1_000).state_memory()["total_bytes"] == \
        SlidingWindow(MaxMetric(**CPU), 100_000).state_memory()["total_bytes"]
    small, big = SlidingWindow(acc(), 8, tier="ring"), SlidingWindow(acc(), 64, tier="ring")
    batch = _t(_cls_batches(0, 1)[0])
    small.update(*batch)
    big.update(*batch)
    assert big.state_memory()["total_bytes"] > small.state_memory()["total_bytes"]


def test_two_stack_hinted_flip_equals_the_branch_free_step():
    """The eager step takes the flip from the host's update count; the exported program
    evaluates it under ``where``: the same states bit for bit through several flips."""
    metric = MaxMetric(**CPU)
    sw = SlidingWindow(metric, 12, pane=2)  # depth 6
    state = window_defaults(metric, 12, "two_stack", 2)
    rng = np.random.default_rng(1)
    for _ in range(40):
        x = torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))
        sw.update(x)
        state = window_step(metric, "wstack", state, (torch.tensor(2.0), x), {})
        for key, value in state.items():
            assert torch.equal(value, sw._wstate[key]), key


@pytest.fixture
def portable(monkeypatch):
    from torchmetrics_tpu.aot import codecs as jcodecs
    from torchmetrics_tpu_torch.aot import codecs

    def refuse(exported):
        raise codecs.CodecError("AOTInductor packaging left out of this test")

    def jax_refuse(compiled):
        raise jcodecs.CodecError("the native codec fails on this CPU mesh")

    monkeypatch.setattr(codecs, "encode_executable", refuse)
    monkeypatch.setattr(jcodecs, "encode_executable", jax_refuse)


def test_window_dual_aot_warm_start(tmp_path, portable):
    """A windowed accuracy's ``wdual`` program precompiles, a fresh window serves its
    first update from the cache (no compile), and its states equal the eager ones bit
    for bit."""
    batches = [_t(b) for b in _cls_batches(31, 6)]
    eager = SlidingWindow(PORT["accuracy"](), 4)
    for b in batches:
        eager.update(*b)
    row = SlidingWindow(PORT["accuracy"](), 4).precompile(*batches[0], cache_dir=str(tmp_path / "cache"))["wdual"]
    assert row["status"] == "written" and row["codecs"] == ["torch_export"]
    aot.enable(str(tmp_path / "cache"))
    with obs.telemetry_session() as rec:
        warm = SlidingWindow(PORT["accuracy"](), 4)
        for b in batches:
            warm.update(*b)
    snap = rec.counters.snapshot()
    keys = {k: v for k, v in snap.per_key.items() if k.endswith(".wdual")}
    assert snap["aot_cache_hits"] == 1 and sum(v["compiles"] for v in keys.values()) == 0
    for key, value in eager._wstate.items():
        assert torch.equal(warm._wstate[key], value), key
    assert torch.equal(warm.compute(), eager.compute())
