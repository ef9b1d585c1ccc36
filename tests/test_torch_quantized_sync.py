"""The port's quantized sync plane (``torchmetrics_tpu_torch/parallel/quantize.py`` and the
quantized buckets of ``parallel/coalesce.py``) held against the JAX package's, on the CPU.

Each test mirrors one of ``tests/test_quantized_sync.py``: the same numpy-seeded states
go through the JAX plane (its ``QuantWorld`` replay fakes) and through the port's plane
(a port fake of the same design), each simulated rank under its own ``SyncConfig``.

Tolerances: metadata rows (the quant section's scale bit patterns included), integer
and other exact leaves, and the int8/bf16 wire bytes equal the JAX package's. A
dequantized value is ``q * scale + zero`` in float32; XLA may fuse that into one
multiply-add where torch rounds twice, so dequantized values are held within one code
step (the block's ``scale``) of the JAX package's, and within the analytic bounds of
``quantize.py``'s docstring of the exact per-leaf oracle.
"""

from __future__ import annotations

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_quantized_sync import MultiQuantWorld as JaxMultiWorld
from test_quantized_sync import QuantWorld as JaxQuantWorld
from test_quantized_sync import _make_rank_state
from test_quantized_sync import _REDUCTIONS as JAX_REDUCTIONS
from test_torch_sync import as_f64, assert_bitwise, to_torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as tt
from torchmetrics_tpu.parallel import SyncConfig as JSyncConfig
from torchmetrics_tpu.parallel import coalesce as JC
from torchmetrics_tpu.parallel import quantize as JQ
from torchmetrics_tpu_torch import Metric, MetricCollection
from torchmetrics_tpu_torch import metric as metric_mod
from torchmetrics_tpu_torch import observability as obs
from torchmetrics_tpu_torch.parallel import SyncConfig
from torchmetrics_tpu_torch.parallel import coalesce as C
from torchmetrics_tpu_torch.parallel import quantize as Q
from torchmetrics_tpu_torch.parallel import sync as S
from torchmetrics_tpu_torch.reliability import FlakyGather, ReliabilityConfig, RetryPolicy
from torchmetrics_tpu_torch.utilities.exceptions import TransientRuntimeError

pytestmark = pytest.mark.quant

CPU = {"device": "cpu"}
REDUCTIONS = {**JAX_REDUCTIONS, "custom": lambda stacked: torch.sum(stacked * 2.0, dim=0)}
EXACT_LEAVES = ("s_bf16", "s_i32", "custom", "none_t", "tiny")


class QuantWorld:
    """The port's replay fake: call 0 answers the metadata collective, call k bucket
    k-1, each rank's row built by the functions the real rank runs, rank i under its own
    ``SyncConfig`` (``configs[i]``; None = exact)."""

    def __init__(self, states_lists, reductions_list, configs=None):
        self.states_lists = states_lists
        self.reductions_list = reductions_list
        self.configs = configs or [None] * len(states_lists)
        self.calls = 0
        self.metas = None
        self.payload_bytes = []

    def __call__(self, value, group=None):
        k = self.calls
        self.calls += 1
        v = torch.as_tensor(value)
        self.payload_bytes.append(v.numel() * v.element_size())
        if k == 0:
            self.metas = [C.build_local_metadata(sl, self.reductions_list, sync_config=c)
                          for sl, c in zip(self.states_lists, self.configs)]
            return [torch.from_numpy(m) for m in self.metas]
        return [C.build_bucket_payload(sl, self.reductions_list, k - 1, self.metas, sync_config=c)
                for sl, c in zip(self.states_lists, self.configs)]


def single(states, reductions, configs=None):
    return QuantWorld([[s] for s in states], [reductions], configs)


def per_leaf_world(states):
    order = list(states[0])
    counter = {"i": 0}

    def prepared(v):
        if isinstance(v, list):
            return torch.cat([torch.atleast_1d(x) for x in v]) if v else torch.zeros((0,), dtype=torch.float32)
        return v

    def fake(value, group=None):
        name = order[counter["i"] % len(order)]
        counter["i"] += 1
        return [prepared(s[name]) for s in states]

    return fake


def port_state(jax_state):
    return {k: to_torch(v) for k, v in jax_state.items()}


def bound(codec, values):
    x = np.concatenate([as_f64(v).ravel() for v in values]) if values else np.zeros(0)
    if x.size == 0:
        return 0.0
    return float(x.max() - x.min()) / 255.0 / 2.0 if codec == "int8" else float(np.abs(x).max()) * 2.0 ** -8


def leaf_bound(codec, states, name, fx, world):
    per_rank = [bound(codec, v if isinstance(v, list) else [v]) for v in (s[name] for s in states)]
    if fx == "sum":
        return sum(per_rank) + 1e-5
    if fx == "mean":
        return sum(per_rank) / world + 1e-5
    return max(per_rank) + 1e-5


def code_step(codec, values):
    """One quantization step of the widest block (int8), or bf16's relative step: how
    far a twice-rounded dequantization may sit from a fused one."""
    return 2.0 * bound(codec, values) + 1e-6


def jax_sync(states, codec, reductions=JAX_REDUCTIONS):
    configs = [JSyncConfig(codec=codec) for _ in states] if codec else None
    fw = JaxQuantWorld(states, reductions, configs)
    return JC.coalesced_process_sync([dict(states[0])], [reductions], dist_sync_fn=fw,
                                     sync_config=configs[0] if configs else None)[0], configs


def port_sync(states, codec, reductions=REDUCTIONS):
    configs = [SyncConfig(codec=codec) for _ in states] if codec else None
    fw = single(states, reductions, configs)
    return C.coalesced_process_sync([dict(states[0])], [reductions], dist_sync_fn=fw,
                                    sync_config=configs[0] if configs else None)[0], configs, fw


# ------------------------------------------------- (tag x dtype x codec) fuzz


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_all_tags_within_analytic_bounds(codec, world, seed):
    """Every tag and dtype: the port's exact leaves equal its per-leaf oracle and the
    JAX package's bit for bit, its quantized leaves sit within the analytic bound of the
    oracle and within one code step of the JAX package's; the metadata rows and wire
    bytes equal the JAX package's."""
    rng = np.random.default_rng(seed)
    jstates = [_make_rank_state(rng, empty_cat=(r == world - 1 and seed % 2 == 0)) for r in range(world)]
    states = [port_state(s) for s in jstates]
    out, pconfigs, fw = port_sync(states, codec)
    jout, jconfigs = jax_sync(jstates, codec)
    oracle = S._process_sync_per_leaf(dict(states[0]), REDUCTIONS, dist_sync_fn=per_leaf_world(states))
    # the wire: the same metadata rows and the same bytes in every bucket
    jfw = JaxQuantWorld(jstates, JAX_REDUCTIONS, [JSyncConfig(codec=codec) for _ in jstates])
    JC.coalesced_process_sync([dict(jstates[0])], [JAX_REDUCTIONS], dist_sync_fn=jfw,
                              sync_config=jfw.configs[0])
    for pm, jm in zip(fw.metas, jfw.metas):
        np.testing.assert_array_equal(pm, np.asarray(jm))
    assert fw.payload_bytes == jfw.payload_bytes
    ctx = f"codec={codec} world={world} seed={seed}"
    for name in EXACT_LEAVES:
        assert_bitwise(out[name], oracle[name], f"{ctx}:{name} vs oracle")
        assert_bitwise(out[name], jout[name], f"{ctx}:{name} vs jax")
    for name in ("s_f32", "mean_f32", "mx", "mn", "cat_t"):
        tol = leaf_bound(codec, states, name, REDUCTIONS[name], world)
        np.testing.assert_allclose(as_f64(out[name]), as_f64(oracle[name]), atol=tol, rtol=0, err_msg=f"{ctx}:{name}")
        step = code_step(codec, [s[name] for s in states]) * world
        np.testing.assert_allclose(as_f64(out[name]), as_f64(jout[name]), atol=step, rtol=0, err_msg=f"{ctx}:{name}")
        assert out[name].dtype == oracle[name].dtype
    got = np.concatenate([as_f64(g).ravel() for g in out["cat_l"]])
    ref = np.concatenate([as_f64(g).ravel() for g in oracle["cat_l"]])
    np.testing.assert_allclose(got, ref, atol=leaf_bound(codec, states, "cat_l", "cat", world), rtol=0)
    # the same residuals committed, within one code step
    for name in ("s_f32", "mean_f32"):
        r, jr = pconfigs[0].residual(0, name), jconfigs[0].residual(0, name)
        assert (r is None) == (jr is None)
        if r is not None:
            np.testing.assert_allclose(r, jr, atol=code_step(codec, [s[name] for s in states]), rtol=0)


def test_collective_count_unchanged_by_quantization():
    """A quantized sync launches as many collectives as an exact one, and its float
    bucket shrinks on the wire, by the JAX package's byte counts."""
    rng = np.random.default_rng(7)
    jstates = [_make_rank_state(rng) for _ in range(2)]
    states = [port_state(s) for s in jstates]
    exact = single(states, REDUCTIONS)
    S.process_sync(dict(states[0]), REDUCTIONS, dist_sync_fn=exact)
    configs = [SyncConfig(codec="int8") for _ in range(2)]
    quant = single(states, REDUCTIONS, configs)
    S.process_sync(dict(states[0]), REDUCTIONS, dist_sync_fn=quant, sync_config=configs[0])
    assert quant.calls == exact.calls
    assert quant.payload_bytes[1] < exact.payload_bytes[1]
    jcfg = [JSyncConfig(codec="int8") for _ in range(2)]
    jquant = JaxQuantWorld(jstates, JAX_REDUCTIONS, jcfg)
    jtm.parallel.sync.process_sync(dict(jstates[0]), JAX_REDUCTIONS, dist_sync_fn=jquant, sync_config=jcfg[0])
    assert quant.payload_bytes == jquant.payload_bytes
    assert quant.calls == C.collective_counts([states[0]], [REDUCTIONS])["process_coalesced"]


def test_error_budget_forces_exact_bitwise():
    """A zero budget forces every leaf exact: the sync equals the unquantized plane and
    the JAX package's bit for bit, and nothing is owed."""
    rng = np.random.default_rng(3)
    jstates = [_make_rank_state(rng) for _ in range(2)]
    states = [port_state(s) for s in jstates]
    budget = {t: 0.0 for t in Q.ELIGIBLE_TAGS}
    configs = [SyncConfig(codec="int8", error_budget=budget) for _ in range(2)]
    out = C.coalesced_process_sync([dict(states[0])], [REDUCTIONS], dist_sync_fn=single(states, REDUCTIONS, configs),
                                   sync_config=configs[0])[0]
    ref = C.coalesced_process_sync([dict(states[0])], [REDUCTIONS], dist_sync_fn=single(states, REDUCTIONS))[0]
    jref, _ = jax_sync(jstates, None)
    for name in ref:
        if isinstance(ref[name], list):
            for x, y, z in zip(out[name], ref[name], jref[name]):
                assert_bitwise(x, y, name)
                assert_bitwise(x, z, name)
        else:
            assert_bitwise(out[name], ref[name], name)
            assert_bitwise(out[name], jref[name], name)
    assert configs[0].residual_norm() == 0.0


def test_mixed_rank_eligibility_per_rank_decode():
    """Eligibility is per rank: the rank over budget ships exact while its peer
    compresses, each segment decoded under its own rank's codes; as the JAX package."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(64,)).astype(np.float32)
    big = (rng.normal(size=(64,)) * 1e4).astype(np.float32)
    reds = {"v": "sum"}
    expect = base.astype(np.float64) + big.astype(np.float64)
    for budget, tol in (({"sum": 25.0}, bound("int8", [torch.from_numpy(base)])),
                        (None, bound("int8", [torch.from_numpy(base)]) + bound("int8", [torch.from_numpy(big)]))):
        states = [{"v": torch.from_numpy(base)}, {"v": torch.from_numpy(big)}]
        configs = [SyncConfig(codec="int8", error_budget=budget) for _ in range(2)]
        out = C.coalesced_process_sync([dict(states[0])], [reds], dist_sync_fn=single(states, reds, configs),
                                       sync_config=configs[0])[0]
        np.testing.assert_allclose(as_f64(out["v"]), expect, atol=tol + 1e-5, rtol=0)
        jstates = [{"v": jnp.asarray(base)}, {"v": jnp.asarray(big)}]
        jcfg = [JSyncConfig(codec="int8", error_budget=budget) for _ in range(2)]
        jout = JC.coalesced_process_sync([dict(jstates[0])], [reds], dist_sync_fn=JaxQuantWorld(jstates, reds, jcfg),
                                         sync_config=jcfg[0])[0]
        np.testing.assert_allclose(as_f64(out["v"]), as_f64(jout["v"]), atol=2 * tol + 1e-5, rtol=0)


def test_world_of_one_skips_codec_entirely():
    """One process with an enabled codec: the sync is bit for bit, no residual, no quant
    counters, and the byte model ships exact bytes."""
    state = {"v": torch.linspace(0.0, 5.0, 64)}
    reds = {"v": "sum"}
    cfg = SyncConfig(codec="int8")
    with obs.telemetry_session() as rec:
        out = C.coalesced_process_sync([dict(state)], [reds], sync_config=cfg)[0]
        snap = rec.counters.snapshot()
    assert torch.equal(out["v"], state["v"])
    assert cfg.residual_norm() == 0.0
    assert snap["quantized_buckets"] == 0 and snap["sync_bytes_saved"] == 0
    model = C.quantized_payload_model([state], [reds], cfg, world=1)
    assert model["shipped_bytes"] == model["exact_bytes"] and model["quantized_buckets"] == 0
    jmodel = JC.quantized_payload_model([{"v": jnp.asarray(state["v"].numpy())}], [reds], JSyncConfig(codec="int8"),
                                        world=1)
    assert model == jmodel


# ------------------------------------------------------- error feedback

_EF_N = 512


def _two_ranks(x, configs):
    states = [{"v": torch.from_numpy(x)}, {"v": torch.from_numpy(x)}]
    return states, single(states, {"v": "sum"}, configs)


def test_error_feedback_telescopes_over_repeated_syncs():
    """Repeated quantized syncs: the feedback stream's summed drift stays within one
    quantization step (the telescoping bound), never worse than the raw codec's, and
    the residual equals the JAX package's within one code step."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(_EF_N,)).astype(np.float32)
    n_syncs = 24

    def run(feedback):
        cfg0 = SyncConfig(codec="int8", error_feedback=feedback)
        cum = np.zeros((_EF_N,), np.float64)
        for _ in range(n_syncs):
            states, fw = _two_ranks(x, [cfg0, SyncConfig(codec="int8", error_feedback=False)])
            out = C.coalesced_process_sync([dict(states[0])], [{"v": "sum"}], dist_sync_fn=fw, sync_config=cfg0)[0]
            cum += as_f64(out["v"])
        return cum, cfg0

    nb = Q.allocate_blocks([_EF_N], Q.BUCKET_SCALE_SLOTS)[0]
    q, s, z = Q.block_quantize(torch.from_numpy(x), nb)
    rank1 = as_f64(Q.block_dequantize(q, s, z, _EF_N, torch.float32))
    per_sync = bound("int8", [torch.from_numpy(x)]) + 1e-5
    cum_fb, cfg_fb = run(True)
    drift_fb = np.abs(cum_fb - n_syncs * rank1 - n_syncs * x.astype(np.float64))
    assert float(drift_fb.max()) <= 2.0 * per_sync
    assert 0.0 <= cfg_fb.residual_norm() <= np.sqrt(_EF_N) * per_sync * 1.01
    cum_raw, _ = run(False)
    drift_raw = np.abs(cum_raw - n_syncs * rank1 - n_syncs * x.astype(np.float64))
    assert float(drift_fb.max()) <= float(drift_raw.max()) + 2.0 * per_sync
    # one sync's residual against the JAX package's
    cfg = SyncConfig(codec="int8")
    states, fw = _two_ranks(x, [cfg, SyncConfig(codec="int8")])
    C.coalesced_process_sync([dict(states[0])], [{"v": "sum"}], dist_sync_fn=fw, sync_config=cfg)
    jcfg = JSyncConfig(codec="int8")
    jstates = [{"v": jnp.asarray(x)}, {"v": jnp.asarray(x)}]
    JC.coalesced_process_sync([dict(jstates[0])], [{"v": "sum"}], sync_config=jcfg,
                              dist_sync_fn=JaxQuantWorld(jstates, {"v": "sum"}, [jcfg, JSyncConfig(codec="int8")]))
    np.testing.assert_allclose(cfg.residual(0, "v"), jcfg.residual(0, "v"), atol=2 * per_sync, rtol=0)
    # the quantized bytes themselves equal the JAX package's
    jq, js, jz = JQ.block_quantize(jnp.asarray(x), nb)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(z, jz)


def test_flaky_gather_leaves_residuals_uncommitted():
    """A transient failure of the metadata or a bucket collective commits no residual;
    a successful retry commits exactly one step."""
    x = np.random.default_rng(13).normal(size=(64,)).astype(np.float32)
    for fail_times in (1, 2):
        cfg0 = SyncConfig(codec="int8")
        states, fw = _two_ranks(x, [cfg0, SyncConfig(codec="int8")])
        with pytest.raises(TransientRuntimeError):
            C.coalesced_process_sync([dict(states[0])], [{"v": "sum"}], sync_config=cfg0,
                                     dist_sync_fn=FlakyGather(inner=fw, fail_times=fail_times))
        assert cfg0.residual_norm() == 0.0, f"fail_times={fail_times}"
    cfg0 = SyncConfig(codec="int8")
    states, fw = _two_ranks(x, [cfg0, SyncConfig(codec="int8")])
    with pytest.raises(TransientRuntimeError):
        C.coalesced_process_sync([dict(states[0])], [{"v": "sum"}], sync_config=cfg0,
                                 dist_sync_fn=FlakyGather(inner=fw, fail_times=1))
    states2, fw2 = _two_ranks(x, [cfg0, SyncConfig(codec="int8")])
    C.coalesced_process_sync([dict(states2[0])], [{"v": "sum"}], dist_sync_fn=fw2, sync_config=cfg0)
    clean = SyncConfig(codec="int8")
    states3, fw3 = _two_ranks(x, [clean, SyncConfig(codec="int8")])
    C.coalesced_process_sync([dict(states3[0])], [{"v": "sum"}], dist_sync_fn=fw3, sync_config=clean)
    assert cfg0.residual_norm() == pytest.approx(clean.residual_norm())


class _Sum(Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("x", torch.zeros((64,)), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"x": torch.as_tensor(x, dtype=torch.float32)}

    def _compute(self, state):
        return state["x"].sum()


def test_metric_sync_exhausted_retry_restores_residuals():
    """Through ``Metric.sync``'s retry: an exhausted budget keeps the metric at its last
    good state and the residual store untouched."""
    m = _Sum(reliability=ReliabilityConfig(retry=RetryPolicy(max_attempts=2, backoff_base=0.0)), **CPU)
    m.update(torch.linspace(0, 1, 64))
    before = m._state["x"].clone()
    cfg = SyncConfig(codec="int8")
    flaky = FlakyGather(inner=lambda v, g=None: [torch.as_tensor(v)] * 2, fail_times=10)
    with pytest.raises(TransientRuntimeError):
        m.sync(dist_sync_fn=flaky, distributed_available=lambda: True, sync_config=cfg)
    assert torch.equal(m._state["x"], before)
    assert cfg.residual_norm() == 0.0


# ------------------------------------------------ collection + async threading


def _float_collections():
    """The JAX test's float collection in both packages, fed the same batches."""
    rng = np.random.default_rng(17)
    preds = rng.normal(size=(256, 5)).astype(np.float32)
    target = rng.integers(0, 5, 256).astype(np.int32)
    a, b = rng.normal(size=(128,)).astype(np.float32), rng.normal(size=(128,)).astype(np.float32)
    c = rng.normal(size=(128,)).astype(np.float32)
    port = MetricCollection({
        "cal": tt.classification.MulticlassCalibrationError(5, n_bins=512, validate_args=False, **CPU),
        "mse": tt.regression.MeanSquaredError(**CPU),
        "mean": tt.aggregation.MeanMetric(**CPU),
    }, compute_groups=False, **CPU)
    jax = jtm.MetricCollection({
        "cal": jtm.classification.MulticlassCalibrationError(5, n_bins=512, validate_args=False),
        "mse": jtm.regression.MeanSquaredError(),
        "mean": jtm.aggregation.MeanMetric(),
    }, compute_groups=False)
    for coll, conv in ((port, torch.from_numpy), (jax, jnp.asarray)):
        coll["cal"].update(conv(preds), conv(target))
        coll["mse"].update(conv(a), conv(b))
        coll["mean"].update(conv(c))
    return port, jax


def test_collection_sync_threads_sync_config():
    """``MetricCollection.sync(sync_config=...)`` quantizes the one bucketed collective
    set: the quant counters and event tick, the synced calibration bins sit within the
    analytic bound of twice the local ones, and the shipped and raw bytes equal the
    JAX package's."""
    col, jcol = _float_collections()
    states = [dict(m._state) for m in col.values()]
    reds = [dict(m._reductions) for m in col.values()]
    configs = [SyncConfig(codec="int8") for _ in range(2)]
    fw = QuantWorld([states, states], reds, configs)
    with obs.telemetry_session() as rec:
        col.sync(dist_sync_fn=fw, distributed_available=lambda: True, sync_config=configs[0])
        snap = rec.counters.snapshot()
        events = rec.events_of("quant")
    assert snap["quantized_buckets"] >= 1 and snap["sync_bytes_saved"] > 0
    assert len(events) == 1
    payload = events[0].payload
    assert payload["shipped_bytes"] < payload["raw_bytes"] and payload["compression_x"] > 1.5
    assert rec.quant_feedback_norm() == pytest.approx(configs[0].residual_norm())
    cal_synced = as_f64(col["cal"]._state["conf_bin"])
    col.unsync()
    cal_local = as_f64(col["cal"]._state["conf_bin"])
    np.testing.assert_allclose(cal_synced, 2.0 * cal_local, atol=2 * bound("int8", [torch.from_numpy(cal_local)])
                               + 1e-5, rtol=0)
    from torchmetrics_tpu import observability as jobs

    jstates = [dict(m._state) for m in jcol.values()]
    jreds = [dict(m._reductions) for m in jcol.values()]
    jcfg = [JSyncConfig(codec="int8") for _ in range(2)]
    with jobs.telemetry_session() as jrec:
        jcol.sync(dist_sync_fn=JaxMultiWorld([jstates, jstates], jreds, jcfg), distributed_available=lambda: True,
                  sync_config=jcfg[0])
        jpayload = jrec.events_of("quant")[0].payload
    for key in ("buckets", "leaves", "raw_bytes", "shipped_bytes", "bytes_saved"):
        assert payload[key] == jpayload[key], key


def test_async_sync_compresses_in_worker_bitwise_vs_blocking():
    """``sync(async_=True, sync_config=...)`` quantizes in the worker thread; the
    committed states equal the blocking quantized sync's bit for bit."""
    col_a, _ = _float_collections()
    col_b, _ = _float_collections()
    states = [dict(m._state) for m in col_a.values()]
    reds = [dict(m._reductions) for m in col_a.values()]
    cfg_blocking = [SyncConfig(codec="int8") for _ in range(2)]
    col_a.sync(dist_sync_fn=QuantWorld([states, states], reds, cfg_blocking), distributed_available=lambda: True,
               sync_config=cfg_blocking[0])
    cfg_async = [SyncConfig(codec="int8") for _ in range(2)]
    handle = col_b.sync(async_=True, dist_sync_fn=QuantWorld([states, states], reds, cfg_async),
                        distributed_available=lambda: True, sync_config=cfg_async[0])
    handle.commit()
    for (na, ma), (_, mb) in zip(col_a.items(keep_base=True), col_b.items(keep_base=True)):
        for key in ma._state:
            assert torch.equal(ma._state[key], mb._state[key]), f"{na}:{key}"
    assert cfg_async[0].residual_norm() == pytest.approx(cfg_blocking[0].residual_norm())


# ------------------------------------------------------------- payload model


def test_payload_model_hits_acceptance_ratios():
    """The byte model shows >= 1.9x for both codecs on a float-heavy 14-leaf state and
    equals the JAX package's model key for key."""
    rng = np.random.default_rng(23)
    nstate = {f"v{i}": rng.normal(size=(256,)).astype(np.float32) for i in range(12)}
    nstate["counts"] = rng.integers(0, 9, (16,)).astype(np.int32)
    nstate["tiny"] = rng.normal(size=(2,)).astype(np.float32)
    state = {k: torch.from_numpy(v) for k, v in nstate.items()}
    jstate = {k: jnp.asarray(v) for k, v in nstate.items()}
    reds = {k: "sum" for k in state}
    for codec in ("bf16", "int8"):
        model = C.quantized_payload_model([state], [reds], SyncConfig(codec=codec), world=2)
        assert model["quantized_buckets"] == 1 and model["leaves_quantized"] == 12
        assert model["eligible_exact_bytes"] / model["eligible_shipped_bytes"] >= 1.9, codec
        assert model["exact_bytes"] / model["shipped_bytes"] >= 1.9, codec
        assert model == JC.quantized_payload_model([jstate], [reds], JSyncConfig(codec=codec), world=2)
    exact = C.quantized_payload_model([state], [reds], None, world=2)
    assert exact["shipped_bytes"] == exact["exact_bytes"]


# --------------------------------------------------------------- spill codec


def _spill_engine(codec):
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    eng = ServingEngine(tt.classification.MulticlassCalibrationError(5, n_bins=64, validate_args=False, **CPU),
                        ServingConfig(capacity=2, megabatch_size=2, spill_codec=codec))
    rng = np.random.default_rng(29)
    batches = {tid: (rng.normal(size=(64, 5)).astype(np.float32), rng.integers(0, 5, 64).astype(np.int32))
               for tid in ("a", "b", "c")}
    for tid, (p, t) in batches.items():
        eng.update(tid, p, t)
    eng.flush()
    return eng, batches


def test_spill_codec_shrinks_host_bytes_counts_exact():
    """int8 spill: fewer host bytes, values within the block bound on a spilled read
    and after readmission, exact update counts; the exact codec round-trips bit for
    bit; the encoded spill equals the JAX package's codec byte for byte."""
    eng_none, batches = _spill_engine("none")
    eng_q, _ = _spill_engine("int8")
    assert eng_q.tenants()["a"]["spilled"] and eng_none.tenants()["a"]["spilled"]
    assert eng_q.memory()["spilled_host_bytes"] < eng_none.memory()["spilled_host_bytes"]
    assert eng_q.stats["spill_bytes_saved"] > 0 and eng_none.stats["spill_bytes_saved"] == 0
    exact = {k: as_f64(v) for k, v in eng_none._tenant_state(eng_none._tenants["a"]).items()}
    quant = {k: as_f64(v) for k, v in eng_q._tenant_state(eng_q._tenants["a"]).items()}
    for k in exact:
        np.testing.assert_allclose(quant[k], exact[k], atol=bound("int8", [torch.from_numpy(exact[k])]) + 1e-5,
                                   rtol=0, err_msg=k)
    assert eng_q.update_count("a") == eng_none.update_count("a")
    raw = {k: np.asarray(v) for k, v in eng_none._tenants["a"].spilled["state"].items()}
    p, t = batches["a"]
    eng_q.update("a", p, t)
    eng_none.update("a", p, t)
    assert abs(float(eng_q.compute("a")) - float(eng_none.compute("a"))) < 0.05
    sd = eng_none.state_dict("b")
    eng_none.load_state_dict("b", sd)
    for k, v in sd.items():
        assert_bitwise(eng_none.state_dict("b")[k], v, k) if isinstance(v, torch.Tensor) else None
    for codec in ("int8", "bf16"):
        enc = Q.encode_spill_state(raw, codec)
        jenc = JQ.encode_spill_state(raw, codec)
        for k in raw:
            if isinstance(enc[k], dict):
                np.testing.assert_array_equal(np.asarray(enc[k]["q"]).view(np.uint8),
                                              np.asarray(jenc[k]["q"]).view(np.uint8), err_msg=f"{codec}:{k}")
            assert Q.spill_state_bytes({k: enc[k]}) == JQ.spill_state_bytes({k: jenc[k]})
        dec, jdec = Q.decode_spill_state(enc), JQ.decode_spill_state(jenc)
        for k in raw:
            np.testing.assert_array_equal(dec[k], np.asarray(jdec[k]), err_msg=f"{codec}:{k}")


def test_spill_codec_rejected_at_config_time():
    from torchmetrics_tpu_torch.serving import ServingConfig

    with pytest.raises(ValueError, match="spill_codec"):
        ServingConfig(spill_codec="int4")


# ------------------------------------------------------------- misc contracts


def test_residual_prefix_pinned_to_metric_constant():
    assert Q.RESIDUAL_KEY_PREFIX == metric_mod.QUANT_RESIDUAL_KEY == JQ.RESIDUAL_KEY_PREFIX
    assert (Q.CODEC_NAMES, Q.ELIGIBLE_TAGS, Q.FEEDBACK_TAGS, Q.BUCKET_SCALE_SLOTS, Q.MIN_SCALE_SLOTS) == \
        (JQ.CODEC_NAMES, JQ.ELIGIBLE_TAGS, JQ.FEEDBACK_TAGS, JQ.BUCKET_SCALE_SLOTS, JQ.MIN_SCALE_SLOTS)
    assert [str(d).replace("torch.", "") for d in Q.QUANT_SECTION_DTYPES] == \
        [jnp.dtype(d).name for d in JQ.QUANT_SECTION_DTYPES]


def test_sync_config_validation_and_pickle():
    with pytest.raises(ValueError, match="codec"):
        SyncConfig(codec="int4")
    with pytest.raises(ValueError, match="min_leaf_bytes"):
        SyncConfig(min_leaf_bytes=-1)
    cfg = SyncConfig(codec="int8")
    cfg._commit_residuals({"k": np.ones((3,), np.float32)})
    clone = pickle.loads(pickle.dumps(cfg))
    assert clone.codec == "int8" and clone.residual_norm() == 0.0
    assert cfg.residual_norm() == pytest.approx(np.sqrt(3.0))
    cfg.clear_residuals()
    assert cfg.residual_norm() == 0.0


def test_block_quantize_roundtrip_bounds():
    """Round trips within half a block's scale; the codes and scales equal the JAX
    package's; a constant block round-trips exactly."""
    rng = np.random.default_rng(31)
    for n, nb in ((1, 1), (7, 2), (64, 4), (1000, 16)):
        x = (rng.normal(size=(n,)) * 10).astype(np.float32)
        q, s, z = Q.block_quantize(torch.from_numpy(x), nb)
        deq = as_f64(Q.block_dequantize(q, s, z, n, torch.float32))
        assert np.abs(deq - x.astype(np.float64)).max() <= float(np.max(s)) / 2.0 + 1e-6
        jq, js, jz = JQ.block_quantize(jnp.asarray(x), nb)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(z, jz)
        jdeq = np.asarray(JQ.block_dequantize(jq, js, jz, n, jnp.float32), np.float64)
        np.testing.assert_allclose(deq, jdeq, atol=float(np.max(s)), rtol=0)
    x = torch.full((16,), 3.25)
    q, s, z = Q.block_quantize(x, 2)
    assert torch.equal(Q.block_dequantize(q, s, z, 16, torch.float32), x)
    assert torch.equal(Q.from_bytes(Q.to_bytes(x), 16, torch.float32), x)
    b = torch.tensor([True, False, True])
    assert torch.equal(Q.from_bytes(Q.to_bytes(b), 3, torch.bool), b)


def test_trace_report_renders_port_quant_events(tmp_path):
    """``tools/trace_report.py`` renders the port's quant event (a real coalesced sync's,
    exported by the port's JSONL exporter) as it renders the JAX package's."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(os.path.dirname(__file__), "..", "tools", "trace_report.py"))
    trace_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace_report)
    x = np.random.default_rng(3).normal(size=(4096,)).astype(np.float32)
    configs = [SyncConfig(codec="int8"), SyncConfig(codec="int8")]
    states, fw = _two_ranks(x, configs)
    path = tmp_path / "trace.jsonl"
    with obs.telemetry_session(obs.TelemetryConfig(sinks=(obs.JSONLSink(str(path)),))) as rec:
        C.coalesced_process_sync([dict(states[0])], [{"v": "sum"}], dist_sync_fn=fw, sync_config=configs[0])
        saved = rec.counters.snapshot()["sync_bytes_saved"]
    report = trace_report.aggregate(trace_report.load_events(str(path)))
    assert report["totals"]["quant_syncs"] == 1
    assert report["totals"]["quant_bytes_saved"] == saved > 0
    assert report["quant"][0]["codec"] == "int8"
    assert "quantized syncs:" in trace_report.render_table(report)


def test_corrupt_codec_bits_degrade_to_lockstep_fallback():
    """A row with impossible codec announcements (codec bits on an int32 leaf, an
    unknown code on a float32 leaf) falls back to the exact per-leaf plane."""
    state = {"v": torch.linspace(0, 1, 64), "n": torch.arange(8, dtype=torch.int32)}
    reds = {"v": "sum", "n": "sum"}
    meta = C.build_local_metadata([state], [reds], sync_config=SyncConfig(codec="int8"))
    jmeta = JC.build_local_metadata([{k: jnp.asarray(v.numpy()) for k, v in state.items()}], [reds],
                                    sync_config=JSyncConfig(codec="int8"))
    np.testing.assert_array_equal(meta, np.asarray(jmeta))
    for leaf_idx, bad_code in ((1, 2), (0, 3)):
        corrupt = np.array(meta)
        slot = C._HEADER_LEN + leaf_idx * C._LEAF_REC_LEN + 2 + C._MAX_RANK
        corrupt[slot] = (corrupt[slot] & 1) | (bad_code << 1)

        def fake(v, g=None, _c=corrupt):
            a = torch.as_tensor(v)
            if a.dtype == torch.int32 and a.numel() == meta.size:
                return [torch.from_numpy(_c), torch.from_numpy(_c)]
            return [a, a]

        out = S.process_sync(dict(state), reds, dist_sync_fn=fake, sync_config=SyncConfig(codec="int8"))
        np.testing.assert_allclose(as_f64(out["v"]), 2 * as_f64(state["v"]), rtol=1e-6)
        assert torch.equal(out["n"], 2 * state["n"])


def test_fallback_plane_stays_exact():
    cfg = SyncConfig(codec="int8")
    out = S.process_sync({"v": torch.tensor(4.0)}, {"v": "mean"}, sync_config=cfg,
                         dist_sync_fn=lambda v, g=None: [torch.as_tensor(v) + i for i in range(3)])
    assert float(out["v"]) == 5.0
    assert cfg.residual_norm() == 0.0


# ------------------------------------------------------- degraded sync and rejoin


def test_degraded_sync_and_rejoin_write_the_ledger():
    """A tombstoned rank (an all-zero metadata row) completes the sync over the
    survivors, counts in the dead-rank ledger and fires ``degraded_sync``; its rejoin
    clears it and fires ``rank_rejoin``; a bumped epoch rides the row. As the JAX
    package's ledger."""
    state = {"v": torch.linspace(0.0, 1.0, 64), "n": torch.tensor(3, dtype=torch.int32)}
    reds = {"v": "sum", "n": "sum"}
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}

    def world(dead, package):
        build_meta = C.build_local_metadata if package == "port" else JC.build_local_metadata
        build_bucket = C.build_bucket_payload if package == "port" else JC.build_bucket_payload
        st = state if package == "port" else jstate
        calls = {"k": 0, "metas": None}

        def fake(value, group=None):
            k = calls["k"]
            calls["k"] += 1
            if k == 0:
                meta = build_meta([st], [reds])
                calls["metas"] = [meta, np.zeros_like(meta) if dead else meta]
                return [torch.from_numpy(m) if package == "port" else jnp.asarray(m) for m in calls["metas"]]
            row = build_bucket([st], [reds], k - 1, calls["metas"])
            return [row, row * 0 if dead else row]

        return fake

    for package, coalesce in (("port", C), ("jax", JC)):
        coalesce.clear_dead_ranks()
    try:
        with obs.telemetry_session() as rec:
            out = C.coalesced_process_sync([dict(state)], [reds], dist_sync_fn=world(True, "port"))[0]
            assert C.dead_ranks() == {1: 1}
            C.coalesced_process_sync([dict(state)], [reds], dist_sync_fn=world(True, "port"))
            assert C.dead_ranks() == {1: 2}
            rejoined = C.coalesced_process_sync([dict(state)], [reds], dist_sync_fn=world(False, "port"))[0]
            assert C.dead_ranks() == {}
            assert len(rec.events_of("degraded_sync")) == 2 and len(rec.events_of("rank_rejoin")) == 1
        assert torch.equal(out["v"], state["v"]) and int(out["n"]) == 3  # the survivor alone
        assert torch.equal(rejoined["v"], 2 * state["v"]) and int(rejoined["n"]) == 6
        jout = JC.coalesced_process_sync([dict(jstate)], [reds], dist_sync_fn=world(True, "jax"))[0]
        assert JC.dead_ranks() == {1: 1}
        assert_bitwise(out["v"], jout["v"], "v")
        epoch = C.liveness_epoch()
        assert C.bump_liveness_epoch() == epoch + 1
        assert C.build_local_metadata([state], [reds])[5] == epoch + 1
    finally:
        C.clear_dead_ranks()
        JC.clear_dead_ranks()
        C._LIVENESS["epoch"] = 1
