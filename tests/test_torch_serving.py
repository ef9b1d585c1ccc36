"""The port's serving plane (``torchmetrics_tpu_torch/serving``) and its tenant programs
(``Metric._get_vupdate_fn`` and siblings) held against the JAX package's, on the CPU.

Mirrors ``tests/test_serving.py`` (its 25 tests) and the 12 ``serving``-marked tests
of ``tests/test_streaming.py``; the JAX package's own tests that are known red here
(the AOT warm boots and the shard-by-tenant placement) are mirrored against their
docstrings' contracts. The same numpy-seeded traffic goes through the port's engine,
standalone port metrics and, where named, the JAX engine.

Tolerances: integer states equal the references bit for bit; float states and values
within 1e-6 (the JAX oracles' ``rtol=1e-6``; running means within 1e-5 as there).
The megabatch programs run the same aten ops whatever their row count (counted with a
``TorchDispatchMode``, the CPU's view of the launches): the confusion matrix's batched
count and the sepconv7 batching rule hold that, and both equal their per-row forms bit
for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torchmetrics_tpu_torch import aot
from torchmetrics_tpu_torch import observability as obs
from torchmetrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, SumMetric
from torchmetrics_tpu_torch.aot import codecs
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix
from torchmetrics_tpu_torch.metric import TENANT_COUNT_KEY, Metric
from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

pytestmark = pytest.mark.serving

CPU = {"device": "cpu"}
NUM_CLASSES = 3
BATCH = 4


@pytest.fixture(autouse=True)
def _port_plane_off():
    yield
    aot.disable()


@pytest.fixture
def portable(monkeypatch):
    """A native codec that refuses: entries carry the portable ``torch.export`` codec
    alone (an AOTInductor compile takes seconds on this CPU; ``tests/test_torch_aot.py``
    holds that codec)."""

    def refuse(exported):
        raise codecs.CodecError("AOTInductor packaging left out of this test")

    monkeypatch.setattr(codecs, "encode_executable", refuse)


def _acc():
    return MulticlassAccuracy(num_classes=NUM_CLASSES, average="micro", validate_args=False, **CPU)


def _batches(rng, n, batch=BATCH, classes=NUM_CLASSES):
    return [(rng.normal(size=(batch, classes)).astype(np.float32), rng.integers(0, classes, batch).astype(np.int32))
            for _ in range(n)]


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(b)) if isinstance(b, np.ndarray) else b for b in batch)


def _assert_state_parity(engine, tenant_id, ref):
    """Engine rows against a standalone metric: integer states bit for bit, float
    states within 1e-6."""
    state = engine._tenant_state(engine._tenants[tenant_id])
    for name, want in ref._state.items():
        got = state[name]
        if not want.is_floating_point():
            assert torch.equal(got.to(want.dtype), want), f"{tenant_id}/{name}"
        else:
            np.testing.assert_allclose(got.double().numpy(), want.double().numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{tenant_id}/{name}")


class _OpCount(TorchDispatchMode):
    """aten ops dispatched below ``torch.func.vmap`` (a per-row fallback shows as more)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _program_ops(metric, megabatch, classes=NUM_CLASSES, batch=BATCH):
    """aten ops of one ``vupdate`` program call over ``megabatch`` rows."""
    engine = ServingEngine(metric, ServingConfig(capacity=megabatch, megabatch_size=megabatch))
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.normal(size=(megabatch, batch, classes)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, classes, (megabatch, batch)).astype(np.int32))
    engine.update("probe", p[0], t[0])
    cls = next(iter(engine._classes.values()))
    fn = engine._metric._get_vupdate_fn()
    idx = torch.arange(megabatch)
    with _OpCount() as count:
        fn(cls.stacked, None, idx, (p, t), {})
    return count.ops


# ------------------------------------------------------------------- basics


def test_single_tenant_matches_reference_with_padding():
    rng = np.random.default_rng(0)
    engine = ServingEngine(_acc(), ServingConfig(capacity=8, megabatch_size=8))
    ref = _acc()
    for b in _batches(rng, 3):
        engine.update("only", *b)
        ref.update(*_t(b))
    engine.flush()
    assert engine.stats["padded_rows"] > 0
    _assert_state_parity(engine, "only", ref)
    assert abs(float(engine.compute("only")) - float(ref.compute())) < 1e-6
    assert engine.update_count("only") == 3


def test_tenant_isolation_fuzz_and_jax_engine_parity():
    """Shuffled interleaved traffic with a mid-run reset: every tenant stays isolated,
    and its states equal the JAX engine's fed the same traffic, bit for bit."""
    from torchmetrics_tpu.classification import MulticlassAccuracy as JAccuracy
    from torchmetrics_tpu.serving import ServingConfig as JServingConfig
    from torchmetrics_tpu.serving import ServingEngine as JServingEngine

    rng = np.random.default_rng(1)
    n_tenants, rounds = 9, 3
    engine = ServingEngine(_acc(), ServingConfig(capacity=16, megabatch_size=4))
    jengine = JServingEngine(JAccuracy(num_classes=NUM_CLASSES, average="micro", validate_args=False),
                             JServingConfig(capacity=16, megabatch_size=4))
    refs = {t: _acc() for t in range(n_tenants)}
    per_tenant = {t: _batches(rng, rounds) for t in range(n_tenants)}
    order = [(t, i) for t in range(n_tenants) for i in range(rounds)]
    rng.shuffle(order)
    for step, (t, i) in enumerate(order):
        engine.update(t, *per_tenant[t][i])
        jengine.update(t, *(jnp.asarray(x) for x in per_tenant[t][i]))
        refs[t].update(*_t(per_tenant[t][i]))
        if step == len(order) // 2:
            engine.flush()
            jengine.flush()
            engine.reset(4)
            jengine.reset(4)
            refs[4] = _acc()
    engine.flush()
    jengine.flush()
    for t in range(n_tenants):
        _assert_state_parity(engine, t, refs[t])
        assert abs(float(engine.compute(t)) - float(refs[t].compute())) < 1e-6
        jstate = jengine._tenant_state(jengine._tenants[t])
        for name, v in engine._tenant_state(engine._tenants[t]).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jstate[name]), err_msg=f"{t}/{name}")
    for key in ("dispatches", "tenant_rows", "padded_rows", "spills", "readmissions"):
        assert engine.stats[key] == jengine.stats[key], key


def test_mean_metric_per_tenant_running_mean():
    rng = np.random.default_rng(2)
    engine = ServingEngine(MeanMetric(**CPU), ServingConfig(capacity=8, megabatch_size=3))
    refs = {t: MeanMetric(**CPU) for t in range(5)}
    for t in range(5):
        for _ in range(t + 1):
            v = rng.normal(size=(4,)).astype(np.float32)
            engine.update(t, v)
            refs[t].update(torch.from_numpy(v))
    engine.flush()
    for t in range(5):
        np.testing.assert_allclose(float(engine.compute(t)), float(refs[t].compute()), rtol=1e-5)


def test_kwargs_traffic_and_structure_distinct_classes():
    rng = np.random.default_rng(17)
    engine = ServingEngine(MeanMetric(**CPU), ServingConfig(capacity=8, megabatch_size=3))
    refs = {t: MeanMetric(**CPU) for t in range(4)}
    for _ in range(3):
        for t in range(4):
            v = rng.normal(size=(5,)).astype(np.float32)
            w = rng.uniform(0.5, 2.0, size=(5,)).astype(np.float32)
            engine.update(t, v, weight=w)
            refs[t].update(torch.from_numpy(v), weight=torch.from_numpy(w))
    engine.flush()
    for t in range(4):
        np.testing.assert_allclose(float(engine.compute(t)), float(refs[t].compute()), rtol=1e-5)
    engine.update("positional", rng.normal(size=(5,)).astype(np.float32))
    engine.flush()
    assert len(engine._classes) == 2


def test_nonzero_default_states_survive_stacking():
    rng = np.random.default_rng(3)
    engine = ServingEngine(MaxMetric(**CPU), ServingConfig(capacity=4, megabatch_size=2))
    ref = MaxMetric(**CPU)
    v = rng.normal(size=(6,)).astype(np.float32) - 10.0
    engine.update("a", v)
    ref.update(torch.from_numpy(v))
    engine.flush()
    np.testing.assert_allclose(float(engine.compute("a")), float(ref.compute()), rtol=1e-6)


def test_concat_state_metric_rejected():
    with pytest.raises(TorchMetricsUserError, match="concat states"):
        ServingEngine(CatMetric(**CPU))


def test_config_validation():
    with pytest.raises(ValueError, match="on_error"):
        ServingConfig(on_error="explode")
    with pytest.raises(ValueError, match="capacity"):
        ServingConfig(capacity=0)
    with pytest.raises(ValueError, match="megabatch_size"):
        ServingConfig(capacity=4, megabatch_size=8)
    for bad in ({"max_tenants_per_sec": 0}, {"clock": 3}, {"spill_codec": "int4"}, {"journal": 3},
                {"journal_fsync_every": 0}, {"journal_segment_records": 0}, {"retain_snapshots": 0},
                {"window": 0}, {"window_tier": "ring"}, {"megabatch_size": 0}):
        with pytest.raises(ValueError):
            ServingConfig(**bad)


@pytest.mark.parametrize("on_error", ["raise", "quarantine"])
def test_full_width_megabatch_never_evicts_its_own_members(on_error):
    rng = np.random.default_rng(18)
    engine = ServingEngine(_acc(), ServingConfig(capacity=4, megabatch_size=4, on_error=on_error, auto_flush=False))
    refs = {t: _acc() for t in range(8)}
    batch = _batches(rng, 1)[0]
    for t in range(8):
        engine.update(t, *batch)
        refs[t].update(*_t(batch))
    engine.flush()
    assert not any(r["quarantined"] for r in engine.tenants().values())
    for t in range(8):
        _assert_state_parity(engine, t, refs[t])


# --------------------------------------------------------- spill / readmission


def test_eviction_readmission_roundtrip_parity():
    """Churn over 3 slots: states bit for bit, and the LRU victims the JAX engine's (the
    same spills, readmissions and residents, tenant by tenant)."""
    from torchmetrics_tpu.classification import MulticlassAccuracy as JAccuracy
    from torchmetrics_tpu.serving import ServingConfig as JServingConfig
    from torchmetrics_tpu.serving import ServingEngine as JServingEngine

    rng = np.random.default_rng(4)
    engine = ServingEngine(_acc(), ServingConfig(capacity=3, megabatch_size=2))
    jengine = JServingEngine(JAccuracy(num_classes=NUM_CLASSES, average="micro", validate_args=False),
                             JServingConfig(capacity=3, megabatch_size=2))
    refs = {t: _acc() for t in range(8)}
    per_tenant = {t: _batches(rng, 4) for t in range(8)}
    order = [(t, i) for t in range(8) for i in range(4)]
    rng.shuffle(order)
    for t, i in order:
        engine.update(t, *per_tenant[t][i])
        jengine.update(t, *(jnp.asarray(x) for x in per_tenant[t][i]))
        refs[t].update(*_t(per_tenant[t][i]))
        assert {k: v["resident"] for k, v in engine.tenants().items()} == \
            {k: v["resident"] for k, v in jengine.tenants().items()}
    engine.flush()
    jengine.flush()
    assert engine.stats["spills"] > 0 and engine.stats["readmissions"] > 0
    assert (engine.stats["spills"], engine.stats["readmissions"]) == \
        (jengine.stats["spills"], jengine.stats["readmissions"])
    for t in range(8):
        _assert_state_parity(engine, t, refs[t])
    assert engine.summary()["tenant_spill_us"] > 0
    mem = engine.memory()
    assert mem["spilled_tenants"] == len([t for t in engine.tenants().values() if t["spilled"]])


def test_spilled_tenant_computes_without_readmission():
    rng = np.random.default_rng(5)
    engine = ServingEngine(_acc(), ServingConfig(capacity=4, megabatch_size=2))
    ref = _acc()
    for b in _batches(rng, 2):
        engine.update("cold", *b)
        ref.update(*_t(b))
    engine.flush()
    engine.evict("cold")
    before = engine.stats["readmissions"]
    assert engine.tenants()["cold"]["spilled"]
    assert abs(float(engine.compute("cold")) - float(ref.compute())) < 1e-6
    assert engine.tenants()["cold"]["spilled"] and engine.stats["readmissions"] == before


def test_spill_disabled_raises_at_capacity():
    (b,) = _batches(np.random.default_rng(6), 1)
    engine = ServingEngine(_acc(), ServingConfig(capacity=2, megabatch_size=2, spill=False))
    engine.update("a", *b)
    engine.update("b", *b)
    with pytest.raises(TorchMetricsUserError, match="full"):
        engine.update("c", *b)


def test_spill_telemetry_counters():
    rng = np.random.default_rng(7)
    with obs.telemetry_session() as rec:
        engine = ServingEngine(_acc(), ServingConfig(capacity=2, megabatch_size=2))
        for t in range(4):
            for b in _batches(rng, 2):
                engine.update(t, *b)
        engine.flush()
    c = rec.counters.snapshot().counts
    assert c["tenant_spills"] == engine.stats["spills"] > 0
    assert c["tenant_readmits"] == engine.stats["readmissions"]
    assert c["tenant_spill_us"] > 0
    assert rec.events_of("tenant_spill")


# ------------------------------------------------- one program, many tenants


def test_one_compile_many_tenants_counters_reconcile():
    rng = np.random.default_rng(8)
    batches = _batches(rng, 2)
    with obs.telemetry_session() as rec:
        engine = ServingEngine(_acc(), ServingConfig(capacity=64, megabatch_size=8))
        for b in batches:
            for t in range(40):
                engine.update(t, *b)
            engine.flush()
    snap = rec.counters.snapshot()
    (row,) = [v for k, v in snap.per_key.items() if k.endswith(".vupdate")]
    assert row["compiles"] == 1
    c = snap.counts
    assert c["serve_tenant_rows"] == 80 == engine.stats["tenant_rows"]
    assert c["serve_dispatches"] == engine.stats["dispatches"] == c["dispatches"]
    assert c["jit_compiles"] + c["jit_cache_hits"] + c["aot_cache_hits"] == c["dispatches"]
    assert snap.summary(brief=True)["tenants_per_dispatch"] == pytest.approx(80 / c["serve_dispatches"])
    assert rec.events_of("serve")


def test_shape_class_bucketing():
    rng = np.random.default_rng(9)
    small = _batches(rng, 1, batch=4)[0]
    big = _batches(rng, 1, batch=6)[0]
    with obs.telemetry_session() as rec:
        engine = ServingEngine(_acc(), ServingConfig(capacity=8, megabatch_size=2))
        ref_a, ref_b = _acc(), _acc()
        engine.update("a", *small)
        ref_a.update(*_t(small))
        engine.update("b", *big)
        ref_b.update(*_t(big))
        engine.flush()
    (row,) = [v for k, v in rec.counters.snapshot().per_key.items() if k.endswith(".vupdate")]
    assert row["compiles"] == 2 and len(engine._classes) == 2
    _assert_state_parity(engine, "a", ref_a)
    _assert_state_parity(engine, "b", ref_b)
    with pytest.raises(TorchMetricsUserError, match="shape-class"):
        engine.update("a", *big)


@pytest.mark.parametrize("make", [_acc, lambda: MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, **CPU)],
                         ids=["accuracy", "confusion_matrix"])
def test_megabatch_program_ops_do_not_grow_with_rows(make):
    """The ``vupdate`` program dispatches as many aten ops at 16 rows as at 4 (no
    per-row fallback of ``torch.func.vmap``), and the confusion matrix's batched count
    equals the per-row counts bit for bit."""
    assert _program_ops(make(), 4) == _program_ops(make(), 16)
    rng = np.random.default_rng(19)
    engine = ServingEngine(make(), ServingConfig(capacity=8, megabatch_size=8))
    refs = {t: make() for t in range(6)}
    for b_i in range(2):
        for t in range(6):
            b = _batches(rng, 1)[0]
            engine.update(t, *b)
            refs[t].update(*_t(b))
    engine.flush()
    for t in range(6):
        _assert_state_parity(engine, t, refs[t])


# ---------------------------------------------------------- fault isolation


def test_fault_injected_megabatch_quarantines_only_offender():
    rng = np.random.default_rng(10)
    engine = ServingEngine(_acc(), ServingConfig(capacity=16, megabatch_size=4, on_error="quarantine",
                                                 auto_flush=False))
    refs = {t: _acc() for t in range(8)}

    def hook(tenant_ids):
        if 3 in tenant_ids:
            raise RuntimeError("injected tenant fault")

    engine._fault_hook = hook
    batch = _batches(rng, 1)[0]
    for t in range(8):
        engine.update(t, *batch)
        if t != 3:
            refs[t].update(*_t(batch))
    engine.flush()
    roster = engine.tenants()
    assert roster[3]["quarantined"] and engine.stats["quarantined"] == 1
    assert all(not roster[t]["quarantined"] for t in range(8) if t != 3)
    for t in range(8):
        if t != 3:
            _assert_state_parity(engine, t, refs[t])
    with pytest.raises(TorchMetricsUserError, match="quarantined"):
        engine.update(3, *batch)
    engine.reset(3)
    engine._fault_hook = None
    engine.update(3, *batch)
    engine.flush()
    ref3 = _acc()
    ref3.update(*_t(batch))
    _assert_state_parity(engine, 3, ref3)


def test_spilled_offender_quarantine_keeps_codec_peers_bitwise():
    rng = np.random.default_rng(12)
    engine = ServingEngine(_acc(), ServingConfig(capacity=4, megabatch_size=4, on_error="quarantine",
                                                 auto_flush=False, spill_codec="int8"))
    refs = {t: _acc() for t in range(8)}
    first, second = _batches(rng, 8), _batches(rng, 8)
    for lo, hi in ((0, 4), (4, 8)):
        for t in range(lo, hi):
            engine.update(t, *first[t])
            refs[t].update(*_t(first[t]))
        engine.flush()
    assert engine.stats["spills"] >= 4 and all(engine._tenants[t].spilled is not None for t in range(4))

    def hook(tenant_ids):
        if 0 in tenant_ids:
            raise RuntimeError("injected fault pinned to spilled tenant 0")

    engine._fault_hook = hook
    for t in range(8):
        engine.update(t, *second[t])
        if t != 0:
            refs[t].update(*_t(second[t]))
    assert all(engine._tenants[t].spilled is not None for t in range(4))
    engine.flush()
    roster = engine.tenants()
    assert roster[0]["quarantined"] and engine.stats["quarantined"] == 1
    assert all(not roster[t]["quarantined"] for t in range(1, 8))
    for t in range(1, 8):
        _assert_state_parity(engine, t, refs[t])
    engine.reset(0)
    engine._fault_hook = None
    engine.update(0, *second[0])
    engine.flush()
    ref0 = _acc()
    ref0.update(*_t(second[0]))
    _assert_state_parity(engine, 0, ref0)


def test_quarantine_emits_telemetry():
    batch = _batches(np.random.default_rng(11), 1)[0]
    with obs.telemetry_session() as rec:
        engine = ServingEngine(_acc(), ServingConfig(capacity=8, megabatch_size=2, on_error="quarantine",
                                                     auto_flush=False))
        engine._fault_hook = lambda tids: (_ for _ in ()).throw(RuntimeError("boom"))
        engine.update("x", *batch)
        engine.flush()
    assert rec.counters.snapshot().counts["quarantines"] == 1
    assert rec.events_of("quarantine")


# ----------------------------------------------------- checkpoint round-trips


def test_checkpoint_roundtrips_with_standalone_metric():
    rng = np.random.default_rng(12)
    engine = ServingEngine(_acc(), ServingConfig(capacity=4, megabatch_size=2))
    ref = _acc()
    for b in _batches(rng, 3):
        engine.update("ckpt", *b)
        ref.update(*_t(b))
    engine.flush()
    sd = engine.state_dict("ckpt")
    assert sd["_update_count"] == 3
    solo = _acc()
    solo.load_state_dict(sd)
    np.testing.assert_allclose(float(solo.compute()), float(ref.compute()), rtol=1e-6)
    ref.persistent(True)
    engine2 = ServingEngine(_acc(), ServingConfig(capacity=4, megabatch_size=2))
    engine2.load_state_dict("restored", ref.state_dict())
    extra = _batches(rng, 1)[0]
    engine2.update("restored", *extra)
    engine2.flush()
    ref.update(*_t(extra))
    _assert_state_parity(engine2, "restored", ref)


def test_load_state_dict_validates_keys():
    engine = ServingEngine(_acc(), ServingConfig(capacity=2, megabatch_size=2))
    with pytest.raises(TorchMetricsUserError, match="missing"):
        engine.load_state_dict("t", {"tp": np.zeros(NUM_CLASSES, np.int32)})
    with pytest.raises(TorchMetricsUserError, match="unknown"):
        engine.load_state_dict("t", {**{k: np.zeros(NUM_CLASSES, np.int32) for k in ("tp", "fp", "tn", "fn")},
                                     "bogus": np.zeros(3)})


# ------------------------------------------------------- self-warming (aot)


@pytest.mark.aot
def test_write_on_miss_second_boot_is_warm(tmp_path, portable):
    """Boot 1 misses and writes the megabatch program through; boot 2 (a fresh engine
    and template, the same cache dir) loads it: no compile, one AOT hit, the same
    value."""
    cache = str(tmp_path / "serve-aot")
    batch = _batches(np.random.default_rng(13), 1)[0]
    cfg = lambda: ServingConfig(capacity=8, megabatch_size=4, aot_cache_dir=cache)
    e1 = ServingEngine(_acc(), cfg())
    for t in range(4):
        e1.update(t, *batch)
    e1.flush()
    plane1 = aot.active_plane()
    assert plane1.stats["writes"] >= 1 and plane1.stats["misses"] >= 1
    v1 = e1.compute(0)
    aot.disable()
    with obs.telemetry_session() as rec:
        e2 = ServingEngine(_acc(), cfg())
        for t in range(4):
            e2.update(t, *batch)
        e2.flush()
        v2 = e2.compute(0)
    plane2 = aot.active_plane()
    assert plane2.stats["loads"] == 1 and plane2.stats["misses"] == 0
    snap = rec.counters.snapshot()
    (row,) = [v for k, v in snap.per_key.items() if k.endswith(".vupdate")]
    assert row["compiles"] == 0 and row["aot_hits"] == 1
    c = snap.counts
    assert c["aot_cache_hits"] == 1
    assert c["jit_compiles"] + c["jit_cache_hits"] + c["aot_cache_hits"] == c["dispatches"]
    assert torch.equal(v1, v2)
    for t in range(4):
        for name, v in e1._tenant_state(e1._tenants[t]).items():
            assert torch.equal(v, e2._tenant_state(e2._tenants[t])[name])


@pytest.mark.aot
def test_engine_precompile_and_prefetch(tmp_path, portable):
    cache = str(tmp_path / "precompile-aot")
    batch = _batches(np.random.default_rng(14), 1)[0]
    aot.enable(cache)
    e1 = ServingEngine(_acc(), ServingConfig(capacity=8, megabatch_size=4))
    report = e1.precompile(*batch)
    (row,) = report.values()
    assert row["status"] == "written"
    assert e1.precompile(*batch)[list(report)[0]]["status"] == "cached"
    aot.disable()
    aot.enable(cache)
    e2 = ServingEngine(_acc(), ServingConfig(capacity=8, megabatch_size=4))
    (pref,) = e2.prefetch(*batch).values()
    assert pref["status"] == "loaded"
    with obs.telemetry_session() as rec:
        e2.update("t", *batch)
        e2.flush()
    (row,) = [v for k, v in rec.counters.snapshot().per_key.items() if k.endswith(".vupdate")]
    assert row["compiles"] == 0 and row["aot_hits"] == 1
    aot.disable()
    with pytest.raises(TorchMetricsUserError, match="AOT plane"):
        e2.precompile(*batch)


# ------------------------------------------------------- placement / sharding


def test_shard_by_tenant_placement(tmp_path):
    """Stacks placed by ``parallel.tenant_sharding`` over a one-card (world of one)
    mesh keep every tenant's values bit for bit; capacity 15 gives 16 rows."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torchmetrics_tpu_torch.parallel import tenant_sharding

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("tenants",))
        sharding = tenant_sharding(mesh)
        assert sharding.size == 1 and type(sharding.placements[0]).__name__ == "Shard"
        engine = ServingEngine(_acc(), ServingConfig(capacity=15, megabatch_size=4, sharding=sharding))
        refs = {t: _acc() for t in range(6)}
        for b in _batches(np.random.default_rng(15), 2):
            for t in range(6):
                engine.update(t, *b)
                refs[t].update(*_t(b))
        engine.flush()
        for t in range(6):
            _assert_state_parity(engine, t, refs[t])
        assert next(iter(engine._classes.values())).stacked[TENANT_COUNT_KEY].shape == (16,)
        with pytest.raises(ValueError, match="no axis"):
            tenant_sharding(init_device_mesh("cpu", (1,), mesh_dim_names=("dp",)))
    finally:
        dist.destroy_process_group()


def test_tenant_sharding_unknown_axis_raises():
    from torchmetrics_tpu_torch.parallel import tenant_sharding

    class _Mesh:
        mesh_dim_names = ("dp",)

    with pytest.raises(ValueError, match="no axis"):
        tenant_sharding(_Mesh())


# ------------------------------------------------------------- misc plumbing


def test_template_is_not_disturbed():
    template = _acc()
    engine = ServingEngine(template, ServingConfig(capacity=4, megabatch_size=2))
    engine.update("t", *_batches(np.random.default_rng(16), 1)[0])
    engine.flush()
    assert template.update_count == 0
    assert all(int(v.sum()) == 0 for v in template._state.values())


def test_counters_fleet_vector_includes_serving_fields():
    from torchmetrics_tpu_torch.observability import COUNTER_FIELDS, Counters, aggregate_counters

    a, b = Counters(), Counters()
    a.record_serve_dispatch(8, 2)
    a.record_tenant_spill(0.001)
    b.record_serve_dispatch(4, 0)
    b.record_tenant_spill(0.002, readmit=True)
    fleet = aggregate_counters([a.snapshot(), b.snapshot()])
    assert fleet["serve_dispatches"] == 2 and fleet["serve_tenant_rows"] == 12
    assert fleet["tenant_spills"] == 1 and fleet["tenant_readmits"] == 1
    assert fleet["tenant_spill_us"] == 3000
    assert len(a.counts_vector()) == len(COUNTER_FIELDS) and "serve_dispatches" in COUNTER_FIELDS


def test_forget_and_summary():
    rng = np.random.default_rng(20)
    engine = ServingEngine(_acc(), ServingConfig(capacity=4, megabatch_size=2, auto_flush=False))
    engine.update("gone", *_batches(rng, 1)[0])
    engine.forget("gone")  # flushes first, then frees the slot
    assert "gone" not in engine.tenants() and engine.stats["dispatches"] == 1
    s = engine.summary()
    assert s["tenants"] == 0 and s["shape_classes"] == 1 and s["window"] is None
    engine.block_until_ready()


# -------------------------------------------- the sepconv7 batching rule (FID)


def test_sepconv7_batching_rule_equals_per_row():
    """Under ``torch.func.vmap`` sepconv7 folds the rows into the conv's batch axis:
    the plain version's batched result equals the per-row result bit for bit, and a
    batched weight takes a launch a row with the same values."""
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7, sepconv7_rows

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(3, 2, 8, 9, 11)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 8, 7)).astype(np.float32))
    for axis in ("W", "H"):
        batched = torch.func.vmap(lambda r: sepconv7_rows(r, w, axis))(x)
        per_row = torch.stack([sepconv7(x[r], w, axis) for r in range(3)])
        assert torch.equal(batched, per_row)
    ws = torch.from_numpy(rng.normal(size=(3, 5, 8, 7)).astype(np.float32))
    both = torch.func.vmap(lambda r, wr: sepconv7_rows(r, wr, "W"))(x, ws)
    assert torch.equal(both, torch.stack([sepconv7(x[r], ws[r], "W") for r in range(3)]))


def test_fid_tenants_vmapped_trunk_equals_per_row():
    """FID tenants: the megabatch runs the InceptionV3 trunk under vmap (sepconv7
    through its batching rule, 26 calls a dispatch whatever the row count) and every
    tenant's states equal a standalone FID fed the same batches, bit for bit on the
    CPU."""
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    from torchmetrics_tpu_torch.image._extractors import InceptionV3Features
    from torchmetrics_tpu_torch.kernels import sepconv as sepconv_mod

    trunk = InceptionV3Features(seed=0, device="cpu")
    make = lambda: FrechetInceptionDistance(feature=trunk, normalize=True, **CPU)
    engine = ServingEngine(make(), ServingConfig(capacity=2, megabatch_size=2, auto_flush=False))
    rng = np.random.default_rng(22)
    refs = {t: make() for t in range(3)}
    calls = {"n": 0}
    original = sepconv_mod.sepconv7

    def counted(*args, **kwargs):
        calls["n"] += 1
        return original(*args, **kwargs)

    sepconv_mod.sepconv7 = counted
    try:
        for real in (True, False):
            for t in range(2):
                imgs = rng.integers(0, 256, (2, 3, 32, 32)).astype(np.uint8)
                engine.update(t, imgs, real)
                refs[t].update(torch.from_numpy(imgs), real)
            calls["n"] = 0
            engine.flush()
            assert calls["n"] == 26 and engine.stats["dispatches"] == (1 if real else 2)
    finally:
        sepconv_mod.sepconv7 = original
    for t in range(2):
        _assert_state_parity(engine, t, refs[t])


# --------------------------------- the streaming plane's serving satellites


def _serve_batch(rng, num_classes=4, batch=8):
    return (rng.normal(size=(batch, num_classes)).astype(np.float32),
            rng.integers(0, num_classes, batch).astype(np.int32))


def _acc4():
    return MulticlassAccuracy(num_classes=4, average="micro", validate_args=False, **CPU)


def test_vmapped_compute_all_parity_one_compile():
    rng = np.random.default_rng(12)
    preds, target = _serve_batch(rng)
    with obs.telemetry_session() as rec:
        eng = ServingEngine(_acc4(), ServingConfig(capacity=64, megabatch_size=16))
        for t in range(40):
            eng.update(t, preds, target)
            if t % 3 == 0:
                eng.update(t, preds, target)
        eng.flush()
        vals = eng.compute_all()
        assert set(vals) == set(range(40))
        for t in (0, 7, 39):
            np.testing.assert_allclose(vals[t].numpy(), eng.compute(t).numpy(), rtol=1e-6)
        assert torch.equal(eng.compute_all()[5], vals[5])
    keys = {k: v for k, v in rec.counters.snapshot().per_key.items() if k.endswith(".vcompute")}
    assert sum(v["compiles"] for v in keys.values()) == 1
    assert sum(v["cache_hits"] for v in keys.values()) == 1


def test_vmapped_compute_all_spilled_fallback():
    preds, target = _serve_batch(np.random.default_rng(13))
    eng = ServingEngine(_acc4(), ServingConfig(capacity=8, megabatch_size=4))
    for t in range(16):
        eng.update(t, preds, target)
    eng.flush()
    vals = eng.compute_all()
    assert set(vals) == set(range(16))
    for t in range(16):
        np.testing.assert_allclose(vals[t].numpy(), eng.compute(t).numpy(), rtol=1e-6)


def test_admission_rate_limit_sheds():
    preds, target = _serve_batch(np.random.default_rng(14))
    with obs.telemetry_session() as rec:
        clock = {"t": 1000.0}
        eng = ServingEngine(_acc4(), ServingConfig(capacity=8, megabatch_size=4, max_tenants_per_sec=5,
                                                   clock=lambda: clock["t"]))
        assert [eng.update(i % 4, preds, target) for i in range(8)] == [True] * 5 + [False] * 3
        assert eng.stats["rejected_batches"] == 3
        clock["t"] += 0.5
        assert eng.update(0, preds, target) is True
        assert eng.update(1, preds, target) is True
        assert eng.update(2, preds, target) is False
    snap = rec.counters.snapshot()
    assert snap["serve_rejected"] == 4
    rejected = rec.events_of("serve_rejected")
    assert len(rejected) == 4 and rejected[0].tag == "admission"
    assert "rejected_batches" in eng.summary()


def test_engine_sync_async_global_snapshot():
    preds, target = _serve_batch(np.random.default_rng(15))
    eng = ServingEngine(_acc4(), ServingConfig(capacity=8, megabatch_size=4))
    for t in range(6):
        eng.update(t, preds, target)
    eng.flush()
    frozen_ref = {key: {k: v.clone() for k, v in cls.stacked.items()} for key, cls in eng._classes.items()}
    handle = eng.sync_async()
    eng.update(0, preds, target)  # the live stack keeps serving during the overlap
    eng.flush()
    synced = handle.commit()
    assert set(synced) == set(frozen_ref)
    for key, stack in synced.items():
        for name, v in stack.items():
            assert torch.equal(v, frozen_ref[key][name])
    handle2 = eng.sync_async(reset_window=True)
    for cls in eng._classes.values():
        assert not cls.stacked[TENANT_COUNT_KEY].any()
    handle2.commit()


class _MeanTagMetric(Metric):
    def __init__(self):
        super().__init__(**CPU)
        self.add_state("m", default=np.zeros((), np.float32), dist_reduce_fx="mean")

    def _batch_state(self, x):
        return {"m": torch.as_tensor(x, dtype=torch.float32).mean()}

    def _compute(self, state):
        return state["m"]


def test_admission_sub_unit_rate_still_admits():
    preds, target = _serve_batch(np.random.default_rng(21))
    clock = {"t": 0.0}
    eng = ServingEngine(_acc4(), ServingConfig(capacity=4, megabatch_size=2, max_tenants_per_sec=0.5,
                                               clock=lambda: clock["t"]))
    assert eng.update(0, preds, target) is True
    assert eng.update(1, preds, target) is False
    clock["t"] += 2.5
    assert eng.update(1, preds, target) is True
    assert eng.update(2, preds, target) is False


def test_engine_sync_async_flushes_pending_and_rotates_spilled():
    preds, target = _serve_batch(np.random.default_rng(22))
    eng = ServingEngine(_acc4(), ServingConfig(capacity=8, megabatch_size=4, auto_flush=False))
    eng.update(0, preds, target)
    handle = eng.sync_async()
    assert eng._tenants[0].pending == 0
    (stack,) = handle.commit().values()
    assert float(stack[TENANT_COUNT_KEY][:8].sum()) == pytest.approx(1.0)
    churn = ServingEngine(_acc4(), ServingConfig(capacity=4, megabatch_size=2))
    for t in range(8):
        churn.update(t, preds, target)
    churn.flush()
    assert any(t.spilled is not None for t in churn._tenants.values())
    churn.sync_async(reset_window=True).commit()
    assert all(t.spilled is None for t in churn._tenants.values())
    np.testing.assert_allclose(churn.compute(0).numpy(), 0.0, atol=1e-6)


def test_engine_sync_async_rejects_bare_mean_states():
    eng = ServingEngine(_MeanTagMetric(), ServingConfig(capacity=4, megabatch_size=2))
    with pytest.raises(TorchMetricsUserError):
        eng.sync_async()


def test_engine_sync_async_quantized_equals_jax_engine():
    """``sync_async(sync_config=...)`` over a simulated two-rank world: the committed
    stacks equal the blocking quantized sync of the same frozen stacks bit for bit,
    and the JAX engine's within one int8 code step (integer states bit for bit)."""
    from test_quantized_sync import MultiQuantWorld as JaxMultiWorld
    from test_torch_quantized_sync import QuantWorld

    from torchmetrics_tpu.classification import MulticlassAccuracy as JAccuracy
    from torchmetrics_tpu.parallel import SyncConfig as JSyncConfig
    from torchmetrics_tpu.serving import ServingConfig as JServingConfig
    from torchmetrics_tpu.serving import ServingEngine as JServingEngine
    from torchmetrics_tpu_torch.parallel import SyncConfig
    from torchmetrics_tpu_torch.parallel import coalesce as C

    preds, target = _serve_batch(np.random.default_rng(23))
    eng = ServingEngine(_acc4(), ServingConfig(capacity=8, megabatch_size=4))
    jeng = JServingEngine(JAccuracy(num_classes=4, average="micro", validate_args=False),
                          JServingConfig(capacity=8, megabatch_size=4))
    for t in range(6):
        eng.update(t, preds, target)
        jeng.update(t, jnp.asarray(preds), jnp.asarray(target))
    eng.flush()
    jeng.flush()
    states = [dict(cls.stacked) for cls in eng._classes.values()]
    reds = [{**{k: "sum" for k in ("tp", "fp", "tn", "fn")}, TENANT_COUNT_KEY: "sum"}]
    configs = [SyncConfig(codec="int8"), SyncConfig(codec="int8")]
    blocking = C.coalesced_process_sync([dict(s) for s in states], reds, sync_config=configs[0],
                                        dist_sync_fn=QuantWorld([states, states], reds, configs))
    cfg_async = [SyncConfig(codec="int8"), SyncConfig(codec="int8")]
    synced = eng.sync_async(dist_sync_fn=QuantWorld([states, states], reds, cfg_async),
                            sync_config=cfg_async[0]).commit()
    (stack,) = synced.values()
    for name, v in blocking[0].items():
        assert torch.equal(stack[name], v), name
    jstates = [dict(cls.stacked) for cls in jeng._classes.values()]
    jcfg = [JSyncConfig(codec="int8"), JSyncConfig(codec="int8")]
    (jstack,) = jeng.sync_async(dist_sync_fn=JaxMultiWorld([jstates, jstates], reds, jcfg),
                                sync_config=jcfg[0]).commit().values()
    for name in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(stack[name].numpy(), np.asarray(jstack[name]), err_msg=name)
    np.testing.assert_allclose(stack[TENANT_COUNT_KEY].numpy(), np.asarray(jstack[TENANT_COUNT_KEY]), atol=1e-2)


def test_windowed_serving_parity_one_compile_and_rotations():
    rng = np.random.default_rng(41)
    streams = {t: [_serve_batch(rng) for _ in range(9)] for t in range(12)}
    with obs.telemetry_session() as rec:
        eng = ServingEngine(_acc4(), ServingConfig(capacity=16, megabatch_size=4, window=3))
        for i in range(9):
            for t in range(12):
                eng.update(t, *streams[t][i])
        eng.flush()
        for t in range(12):
            cov = eng.covered_updates(t)
            assert 3 <= cov < 6
            plain = _acc4()
            for b in streams[t][-cov:]:
                plain.update(*_t(b))
            np.testing.assert_allclose(eng.compute(t).numpy(), plain.compute().numpy(), rtol=1e-6)
        vals = eng.compute_all()
        for t in range(12):
            np.testing.assert_allclose(vals[t].numpy(), eng.compute(t).numpy(), rtol=1e-6)
    snap = rec.counters.snapshot()
    vw = {k: v for k, v in snap.per_key.items() if k.endswith(".vwupdate")}
    assert sum(v["compiles"] for v in vw.values()) == 1
    assert snap["window_rolls"] == 12 * 9 and snap["window_rotations"] == 12 * 3
    s = eng.summary()
    assert s["window"] == 3 and s["window_tier"] == "dual" and s["window_rotations"] == 12 * 3


def test_windowed_serving_two_stack_spill_and_checkpoint():
    rng = np.random.default_rng(43)
    eng = ServingEngine(MaxMetric(**CPU), ServingConfig(capacity=4, megabatch_size=2, window=6,
                                                        window_tier="two_stack", window_pane=2))
    assert eng.summary()["window_tier"] == "two_stack"
    vals = {t: [float(rng.normal()) for _ in range(13)] for t in range(8)}
    for i in range(13):
        for t in range(8):
            eng.update(t, vals[t][i])
    eng.flush()
    assert any(t.spilled is not None for t in eng._tenants.values())
    for t in range(8):
        cov = eng.covered_updates(t)
        assert cov >= 6
        np.testing.assert_allclose(float(eng.compute(t)), max(vals[t][-cov:]), rtol=1e-6)
    before = eng.compute(5)
    sd = eng.state_dict(5)
    eng.reset(5)
    np.testing.assert_allclose(eng.compute(5).numpy(), MaxMetric(**CPU).compute().numpy())
    eng.load_state_dict(5, sd)
    assert torch.equal(eng.compute(5), before)


def test_windowed_serving_rejections_and_contracts():
    with pytest.raises(TorchMetricsUserError):
        ServingEngine(CatMetric(**CPU), ServingConfig(window=4))
    with pytest.raises(ValueError):
        ServingConfig(window=0)
    with pytest.raises(ValueError):
        ServingConfig(window=4, window_tier="ring")
    rng = np.random.default_rng(44)
    eng = ServingEngine(_acc4(), ServingConfig(capacity=4, megabatch_size=2, window=4))
    eng.update(0, *_serve_batch(rng))
    eng.flush()
    with pytest.raises(TorchMetricsUserError):
        eng.sync_async()
    plain = ServingEngine(_acc4(), ServingConfig(capacity=4, megabatch_size=2))
    plain.update(0, *_serve_batch(rng))
    plain.flush()
    with pytest.raises(TorchMetricsUserError):
        eng.load_state_dict(1, plain.state_dict(0))


def test_windowed_serving_quarantine_isolates_offender():
    rng = np.random.default_rng(45)
    eng = ServingEngine(_acc4(), ServingConfig(capacity=8, megabatch_size=4, on_error="quarantine", window=3))
    batch = _serve_batch(rng)
    for t in range(4):
        eng.update(t, *batch)
    eng.flush()

    def hook(tids):
        if 2 in tids:
            raise RuntimeError("poisoned tenant")

    eng._fault_hook = hook
    for t in range(4):
        eng.update(t, *batch)
    eng.flush()
    eng._fault_hook = None
    roster = eng.tenants()
    assert roster[2]["quarantined"]
    for t in (0, 1, 3):
        assert not roster[t]["quarantined"] and eng._tenants[t].update_count == 2


def test_windowed_serving_ragged_phase_parity():
    rng = np.random.default_rng(77)
    for cfg_kw, mk in [({}, SumMetric), ({"window_tier": "two_stack", "window_pane": 2}, SumMetric),
                       ({}, MaxMetric)]:
        eng = ServingEngine(mk(**CPU), ServingConfig(capacity=16, megabatch_size=4, window=5, **cfg_kw))
        streams = {t: [] for t in range(10)}
        for i in range(23):
            for t in range(10):
                if (i + t) % (t % 3 + 1) == 0:
                    v = float(rng.normal())
                    streams[t].append(v)
                    eng.update(t, v)
        eng.flush()
        for t in range(10):
            cov = eng.covered_updates(t)
            plain = mk(**CPU)
            for v in streams[t][-cov:] if cov else []:
                plain.update(v)
            np.testing.assert_allclose(eng.compute(t).numpy(), plain.compute().numpy(), rtol=1e-5)
        vals = eng.compute_all()
        for t in range(10):
            np.testing.assert_allclose(vals[t].numpy(), eng.compute(t).numpy(), rtol=1e-6)
