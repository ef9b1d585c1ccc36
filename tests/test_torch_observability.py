"""The port's observability plane against the JAX package's (``torchmetrics_tpu_torch/
observability`` and its wiring into the core, the sync planes and the reliability plane).

The same seeded numpy inputs go through both packages, the port's metrics on
``device="cpu"``. Counts, signature strings, event sequences, byte sizes and strings are
held exact. Left out, and said so where they are: wall-clock fields (``*_us`` counters,
``duration_s``, event timestamps, the duration histograms' buckets and the percentiles
read from them) and the cost records, which are XLA's ``cost_analysis`` in the JAX package
and an eager ``FlopCounterMode`` harvest in the port. The history is driven by an injected
clock, so no wall time decides when it folds.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import observability as jobs
from torchmetrics_tpu import reliability as jrel
from torchmetrics_tpu.detection import IntersectionOverUnion as JIoU
from torchmetrics_tpu.parallel import coalesce as JC
from torchmetrics_tpu_torch import observability as obs
from torchmetrics_tpu_torch import reliability as prel
from torchmetrics_tpu_torch.detection import IntersectionOverUnion as PIoU
from torchmetrics_tpu_torch.metric import HostMetric, Metric
from torchmetrics_tpu_torch.parallel import coalesce as PC

pytestmark = pytest.mark.telemetry

ROOT = os.path.join(os.path.dirname(__file__), "..")
_FAST_RETRY = dict(backoff_base=0.0, jitter=0.0, sleep_fn=lambda s: None)
_NO_HISTORY_CLOCK = dict(history_clock=lambda: 0.0)  # the history never folds on wall time


def _x(n=8, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(n).astype(np.float32))


class _SumState(Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("s", default=np.zeros((), np.float32), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"s": x.sum()}

    def _compute(self, state):
        return state["s"]


class _HostSum(HostMetric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("s", default=np.zeros((), np.float32), dist_reduce_fx="sum")

    def _host_batch_state(self, x):
        return {"s": torch.as_tensor(np.asarray(x).sum(), device=self.device)}

    def _compute(self, state):
        return state["s"]


class _Gram(Metric):
    """A state that a matmul feeds: its cost record counts the product's flops."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("g", default=np.zeros((4, 4), np.float32), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"g": x.T @ x}

    def _compute(self, state):
        return state["g"].sum()


# ------------------------------------------------------------------ (b) scripted run


def _package(port: bool):
    if port:
        return types.SimpleNamespace(tm=ttm, obs=obs, rel=prel, IoU=PIoU, kw={"device": "cpu"},
                                     arr=lambda a: torch.from_numpy(np.asarray(a)))
    return types.SimpleNamespace(tm=jtm, obs=jobs, rel=jrel, IoU=JIoU, kw={},
                                 arr=lambda a: jnp.asarray(np.asarray(a)))


def _scripted_run(P) -> dict:
    """One session over the core: MulticlassAccuracy, a sum-state regression metric, a
    cat state under ``compute_on_cpu``, a HostMetric detection metric, a collection with
    compute groups, a quarantined and a skipped member, a ``FlakyGather`` retry, an
    exhausted budget, a ``state_dict`` and a shape change past the retrace sentinel."""
    rng = np.random.default_rng(7)
    preds, target = rng.random((32, 5)).astype(np.float32), rng.integers(0, 5, 32)
    x, y = rng.random(8).astype(np.float32), rng.random(8).astype(np.float32)
    a, kw, tm = P.arr, P.kw, P.tm
    boxes = [{"boxes": a(np.array([[0.0, 0, 10, 10], [5, 5, 20, 20]], np.float32)), "labels": a(np.array([0, 1]))}]
    truth = [{"boxes": a(np.array([[1.0, 1, 11, 11], [5, 6, 19, 21]], np.float32)), "labels": a(np.array([0, 1]))}]
    with P.obs.telemetry_session(P.obs.TelemetryConfig(retrace_warn_threshold=2, **_NO_HISTORY_CLOCK)) as rec:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            acc = tm.classification.MulticlassAccuracy(5, **kw)
            for _ in range(2):
                acc.update(a(preds), a(target))
            acc.compute()
            mse = tm.regression.MeanSquaredError(**kw)
            mse.update(a(x), a(y))
            mse.forward(a(x), a(y))
            mse.compute()
            cat = tm.CatMetric(compute_on_cpu=True, **kw)
            cat.update(a(x))
            cat.update(a(x))
            cat.compute()
            iou = P.IoU(**kw)
            iou.update(boxes, truth)
            iou.compute()
            coll = tm.MetricCollection({"acc": tm.classification.MulticlassAccuracy(5, **kw),
                                        "f1": tm.classification.MulticlassF1Score(5, **kw),
                                        "prec": tm.classification.MulticlassPrecision(5, **kw)}, **kw)
            coll.update(a(preds), a(target))
            coll.update(a(preds), a(target))
            coll.compute()
            for mode in ("quarantine", "skip"):
                degrading = tm.MetricCollection({"ok": tm.SumMetric(**kw), "bad": tm.MeanMetric(**kw)},
                                                on_error=mode, **kw)
                degrading.update(a(x))
                with P.rel.inject_dispatch_fault(degrading["bad"], fail_on=1, times=5, tag="update"):
                    degrading.update(a(x))
            flaky = P.rel.FlakyGather(inner=lambda v, g: [v, v], fail_times=1)
            synced = tm.SumMetric(reliability=P.rel.ReliabilityConfig(retry=P.rel.RetryPolicy(3, **_FAST_RETRY)),
                                  distributed_available_fn=lambda: True, dist_sync_fn=flaky, **kw)
            synced.update(a(x))
            synced.compute()
            doomed = tm.SumMetric(reliability=P.rel.ReliabilityConfig(retry=P.rel.RetryPolicy(2, **_FAST_RETRY)),
                                  **kw)
            with P.rel.inject_dispatch_fault(doomed, fail_on=1, times=5, tag="update"):
                with pytest.raises(Exception, match="INTERNAL"):
                    doomed.update(a(x))
            acc.persistent(True)
            acc.state_dict()
            churn = tm.SumMetric(**kw)
            for n in (4, 5, 6, 7):
                churn.update(a(x[:n]))
        summary = coll.telemetry_summary()
        memory = coll.state_memory()
        snap = rec.counters.snapshot()
    for member in summary["members"].values():
        member.pop("latency_us", None)  # wall-clock percentiles
    return {
        "counts": {k: v for k, v in snap.counts.items() if not k.endswith("_us")},  # *_us: wall clock
        "per_key": {k: (v["compiles"], v["cache_hits"], list(v["signatures"])) for k, v in snap.per_key.items()},
        "events": [(e.kind, e.metric, e.tag, e.cache_hit) for e in rec.events],
        "signatures": [e.signature for e in rec.events],
        "payloads": [{k: v for k, v in (e.payload or {}).items() if k not in ("delay_s",)}
                     for e in rec.events if e.kind not in ("hist",)],  # hist payloads: duration buckets
        "warnings": [str(w.message) for w in caught if "sentinel" in str(w.message)],
        "summary": summary, "memory": memory,
        "acc_memory": acc.state_memory(), "cat_memory": cat.state_memory(),
    }


@pytest.fixture(scope="module")
def scripted():
    return _scripted_run(_package(False)), _scripted_run(_package(True))


@pytest.mark.parametrize("part", ["counts", "per_key", "events", "signatures", "payloads", "warnings",
                                  "summary", "memory", "acc_memory", "cat_memory"])
def test_scripted_session_equals_the_jax_packages(scripted, part):
    want, got = scripted
    assert got[part] == want[part]


def test_scripted_session_covers_every_boundary(scripted):
    _, got = scripted
    kinds = {e[0] for e in got["events"]}
    assert {"dispatch", "compute", "sync", "retry", "retry_exhausted", "quarantine", "retrace", "d2h",
            "hist"} <= kinds
    counts = got["counts"]
    assert counts["host_dispatches"] == 1 and counts["quarantines"] == 1 and counts["skips"] == 1
    assert counts["retries"] == 2 and counts["retries_exhausted"] == 1 and counts["retraces"] == 3
    # the accuracy's 4 state_dict leaves, two compute_on_cpu appends, the synced sum's finiteness scan
    assert counts["d2h_readbacks"] == 7
    assert got["summary"]["members"]["f1"]["fused_into"] == "acc"
    assert "Retrace sentinel: SumMetric#" in got["warnings"][0]


# ------------------------------------------------------------ (c) disabled telemetry


def test_disabled_telemetry_constructs_no_events(monkeypatch):
    """With no session the boundaries do no telemetry work: no event objects, no
    signature, no clock reads, no histograms, no SLO evaluation, no spans, no cost
    harvest (the JAX package's traps, and the port's harvest)."""

    def boom(*a, **k):
        raise AssertionError("telemetry work performed while disabled")

    assert not obs.enabled()
    monkeypatch.setattr(obs.events.TelemetryEvent, "__init__", boom)
    monkeypatch.setattr(obs.TelemetryRecorder, "_signature", staticmethod(boom))
    monkeypatch.setattr(obs.tracing, "monotonic", boom)
    monkeypatch.setattr(obs.Histogram, "record", boom)
    monkeypatch.setattr(obs.HistogramRegistry, "record", boom)
    monkeypatch.setattr(obs.HistogramRegistry, "record_duration", boom)
    monkeypatch.setattr(obs.SloEngine, "observe", boom)
    monkeypatch.setattr(obs.SloEngine, "evaluate", boom)
    monkeypatch.setattr(obs.spans.SpanContext, "__init__", boom)
    monkeypatch.setattr(obs.spans, "_digest", boom)
    monkeypatch.setattr(obs.costs.DispatchHarvest, "__init__", boom)
    monkeypatch.setattr(obs.memory.StateMemoryTracker, "observe", boom)
    m = _SumState(device="cpu")
    m.update(_x())
    m.forward(_x())
    assert float(m.compute()) > 0
    h = _HostSum(device="cpu")
    h.update(_x())
    h.forward(_x())
    h.compute()
    c = ttm.CatMetric(compute_on_cpu=True, device="cpu")
    c.update(_x())
    c.persistent(True)
    c.state_dict()
    s = _SumState(device="cpu", distributed_available_fn=lambda: True, dist_sync_fn=lambda v, g: [v, v])
    s.update(_x())
    s.compute()
    pol = prel.RetryPolicy(max_attempts=2, **_FAST_RETRY)
    r = _SumState(device="cpu", reliability=prel.ReliabilityConfig(retry=pol))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with prel.inject_dispatch_fault(r, fail_on=1, times=1, tag="update"):
            r.update(_x())
    coll = ttm.MetricCollection({"a": _SumState(device="cpu"), "b": _SumState(device="cpu")}, device="cpu",
                                on_error="skip")
    coll.update(_x())
    coll.update(_x())
    coll.sync(dist_sync_fn=lambda v, g: [v, v], distributed_available=lambda: True)
    coll.unsync()
    assert coll.telemetry_summary() == {"enabled": False}


# ------------------------------------------------------------ (d) the metadata row


def _row_states():
    rng = np.random.default_rng(5)
    return [
        {"a": rng.random((3, 4)).astype(np.float32), "i": rng.integers(0, 9, (5,)).astype(np.int32),
         "cat": [rng.random(3).astype(np.float32), rng.random(2).astype(np.float32)], "none": []},
        {"b": np.asarray(1.5, np.float32), "flags": rng.random(4) > 0.5},
    ], [{"a": "sum", "i": "max", "cat": "cat", "none": "cat"}, {"b": "mean", "flags": "sum"}]


@pytest.mark.parametrize("tails", ["none", "counters", "both"])
def test_metadata_row_equals_the_jax_packages(tails):
    """The port's ``_encode_metadata`` row equals the JAX package's int for int: the
    header with ``len(COUNTER_FIELDS)`` counter fields, the leaf records and the tails as
    31-bit halves (values past 2**31 included), zeros where no vector is given."""
    states, reductions = _row_states()
    counters = [(i * 7919) << (i % 40) for i in range(len(obs.COUNTER_FIELDS))] if tails != "none" else None
    hists = [(i * 104729) << (i % 33) for i in range(obs.histograms.FLEET_VECTOR_LEN)] if tails == "both" else None
    jax_leaves = JC._prepare_leaves([{k: [jnp.asarray(t) for t in v] if isinstance(v, list) else jnp.asarray(v)
                                      for k, v in s.items()} for s in states], reductions)
    port_leaves = PC._prepare_leaves([{k: [torch.from_numpy(t) for t in v] if isinstance(v, list)
                                       else torch.from_numpy(np.asarray(v)) for k, v in s.items()} for s in states],
                                     reductions)
    want = JC._encode_metadata(jax_leaves, counters, hists)
    got = PC._encode_metadata(port_leaves, counters, hists)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    plan = PC._plan_from_rows([got, got], port_leaves)
    assert plan.counter_rows == [counters or [0] * len(obs.COUNTER_FIELDS)] * 2
    assert plan.hist_rows == [hists or [0] * obs.histograms.FLEET_VECTOR_LEN] * 2


def test_metadata_row_of_a_synced_session_carries_its_counters():
    """A coalesced sync in a session ships the session's vectors in its row; an injected
    gather gets none (the JAX package's rule: only the real transport piggybacks)."""
    rows = []

    def gather(v, g=None):
        rows.append(np.asarray(v))
        return [v, v]

    m = _SumState(device="cpu", distributed_available_fn=lambda: True)
    with obs.telemetry_session(obs.TelemetryConfig(**_NO_HISTORY_CLOCK)) as rec:
        m.update(_x())
        m.sync(dist_sync_fn=gather)
        m.unsync()
        m.sync()  # the real transport: a world of one without a process group
        m.unsync()
        (rows_now, local), counters = PC.fleet_counter_rows(), rec.counters.counts_vector()
        assert obs.gather_counters().ranks == 1
    tail_at = PC._HEADER_LEN + PC._LEAF_REC_LEN
    assert not rows[0][tail_at:].any()
    assert local == 0 and rows_now[0][obs.COUNTER_FIELDS.index("dispatches")] == 1
    assert counters[obs.COUNTER_FIELDS.index("sync_calls")] == 2
    assert PC.fleet_counter_rows() is None  # the session is over: its mailbox is stale


# -------------------------------------------------- (e) fleet rollups over a gather


def _gloo_world_rows(vectors):
    """An injected gather playing ``len(vectors)`` ranks of one metadata vector."""
    calls = []

    def gather(v, g=None):
        calls.append(1)
        arr = np.asarray(v)
        out = []
        for vec in vectors:
            halves = np.empty(2 * len(vec), np.int32)
            PC._pack_halves(halves, vec)
            out.append(halves if len(halves) == len(arr) else arr)
        return out

    return gather, calls


def test_gather_counters_and_histograms_through_an_injected_gather():
    """Remote rows ride one gather; the merged fleet view equals the JAX package's over
    the same rows, straggler attribution included."""
    rank_counts = []
    for r in range(3):
        c = obs.Counters()
        for _ in range(r + 1):
            c.record_dispatch("M#0.update", "float32(8,)")
        c.record_sync(4096 * (r + 1))
        c.record_sync_time(0.001 * (r + 2))
        rank_counts.append(c.snapshot().counts_vector())
    gather, calls = _gloo_world_rows(rank_counts)
    got = obs.gather_counters(obs.CountersSnapshot(counts=dict(zip(obs.COUNTER_FIELDS, rank_counts[0])),
                                                   per_key={}), dist_sync_fn=gather)
    jgather, _ = _gloo_world_rows(rank_counts)
    want = jobs.gather_counters(jobs.CountersSnapshot(counts=dict(zip(jobs.COUNTER_FIELDS, rank_counts[0])),
                                                      per_key={}), dist_sync_fn=jgather)
    assert len(calls) == 1 and got.ranks == 3
    assert got.summary() == want.summary()
    regs = []
    for r in range(2):
        reg = obs.HistogramRegistry()
        for v in range(1, 50 * (r + 1)):
            reg.record("sync_payload", f"M#{r}", v * 97)
        regs.append(reg.fleet_vector())
    gather, calls = _gloo_world_rows(regs)
    merged = obs.gather_histograms(regs[0], dist_sync_fn=gather)
    jmerged = jobs.gather_histograms(regs[0], dist_sync_fn=_gloo_world_rows(regs)[0])
    assert len(calls) == 1
    assert {k: h.summary() for k, h in merged.items()} == {k: h.summary() for k, h in jmerged.items()}


def test_fleet_rollup_after_a_coalesced_sync_gathers_nothing(monkeypatch):
    """A sync over the real transport leaves the rows in the mailbox: the rollups read
    them and call no gather; ``prefer_sync_rows=False`` gathers afresh."""
    from torchmetrics_tpu_torch.parallel import sync as PS

    m = _SumState(device="cpu", distributed_available_fn=lambda: True)
    with obs.telemetry_session(obs.TelemetryConfig(**_NO_HISTORY_CLOCK)) as rec:
        m.update(_x())
        m.sync()
        m.unsync()
        calls = []
        real = PS.gather_metadata_vector
        monkeypatch.setattr(PS, "gather_metadata_vector", lambda *a, **k: calls.append(1) or real(*a, **k))
        fleet = obs.gather_counters()
        hists = obs.gather_histograms()
        assert calls == [] and fleet.ranks == 1 and fleet["dispatches"] == 1 and fleet["sync_calls"] == 1
        assert hists["update"].count == 1
        obs.gather_counters(prefer_sync_rows=False)
        assert calls == [1]
        assert PC.fleet_counter_rows()[1] == 0
    with obs.telemetry_session():
        assert PC.fleet_counter_rows() is None  # another session's epoch


_GLOO_WORKER = textwrap.dedent(
    """
    import datetime, json, sys

    import torch
    import torch.distributed as dist

    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from torchmetrics_tpu_torch import MetricCollection, observability as obs
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix

    gathers = []
    real_all_gather = dist.all_gather
    def counted(*a, **k):
        gathers.append(1)
        return real_all_gather(*a, **k)
    dist.all_gather = counted

    gen = torch.Generator().manual_seed(rank)
    coll = MetricCollection({"acc": MulticlassAccuracy(5, device="cpu"),
                             "confmat": MulticlassConfusionMatrix(5, device="cpu")}, device="cpu")
    with obs.telemetry_session(obs.TelemetryConfig(history_clock=lambda: 0.0)) as rec:
        for _ in range(rank + 1):
            coll.update(torch.randn((16, 5), generator=gen), torch.randint(0, 5, (16,), generator=gen))
        before = len(gathers)
        coll.sync()
        sync_gathers = len(gathers) - before
        coll.unsync()
        before = len(gathers)
        fleet = obs.gather_counters()
        hists = obs.gather_histograms()
        piggyback_gathers = len(gathers) - before
        fresh = obs.gather_counters(prefer_sync_rows=False)
        fresh_gathers = len(gathers) - before - piggyback_gathers
        out = {"sync_gathers": sync_gathers, "sync_collectives": rec.counters.value("sync_collectives"),
               "piggyback_gathers": piggyback_gathers, "fresh_gathers": fresh_gathers,
               "ranks": fleet.ranks, "dispatches": fleet["dispatches"], "fresh_dispatches": fresh["dispatches"],
               "update_count": hists["update"].count}
    print("RESULT" + json.dumps(out), flush=True)
    dist.destroy_process_group()
    """
)


def test_fleet_rollup_in_a_two_process_gloo_group(tmp_path):
    """Two real processes: the coalesced sync ships every rank's counters in its metadata
    collective, so the rollups after it launch no collective; a fresh one launches one.
    Rank r dispatches r + 1 updates to each of its 2 leaders."""
    (tmp_path / "worker.py").write_text(_GLOO_WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=os.pathsep.join([ROOT, env.get("PYTHONPATH", "")]), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(r), "2", init],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for proc in procs:
            text, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0, text[-3000:]
            outs.append(json.loads([line for line in text.splitlines() if line.startswith("RESULT")][-1][6:]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    for out in outs:
        # acc and confmat hold different int32 states: the metadata and one dtype bucket
        assert out["sync_gathers"] == out["sync_collectives"] == 2
        assert out["piggyback_gathers"] == 0 and out["fresh_gathers"] == 1
        # the sync's rows are as of each rank's sync: 2 leaders x (1 + 2) updates
        assert out["ranks"] == 2 and out["dispatches"] == out["fresh_dispatches"] == 6
        assert out["update_count"] == 6


# ---------------------------------------------------------------- (f) trace report


def _trace_report():
    spec = importlib.util.spec_from_file_location("trace_report", os.path.join(ROOT, "tools", "trace_report.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _masked(value):
    """Durations and their percentiles masked: keys ending in _s, _ms or _us."""
    if isinstance(value, dict):
        return {k: ("<t>" if k.endswith(("_s", "_ms", "_us")) and not k.endswith("bytes") else _masked(v))
                for k, v in value.items()}
    if isinstance(value, list):
        return [_masked(v) for v in value]
    return value


def test_trace_report_renders_the_ports_trace_as_the_jax_packages(tmp_path):
    report = _trace_report()
    rendered = {}
    for name, P in (("jax", _package(False)), ("port", _package(True))):
        path = tmp_path / f"{name}.jsonl"
        sink = P.obs.JSONLSink(str(path), host="rank0")
        config = P.obs.TelemetryConfig(sinks=(sink, P.obs.RingBufferSink()), **_NO_HISTORY_CLOCK)
        rng = np.random.default_rng(1)
        preds, target = rng.random((16, 5)).astype(np.float32), rng.integers(0, 5, 16)
        with P.obs.telemetry_session(config):
            acc = P.tm.classification.MulticlassAccuracy(5, **P.kw)
            for _ in range(3):
                acc.update(P.arr(preds), P.arr(target))
            acc.compute()
            s = P.tm.SumMetric(distributed_available_fn=lambda: True, dist_sync_fn=lambda v, g: [v, v], **P.kw)
            s.update(P.arr(preds[0]))
            s.compute()
        rendered[name] = report.aggregate(report.load_events(str(path)))
    assert _masked(rendered["port"]) == _masked(rendered["jax"])
    assert {row["metric"] for row in rendered["port"]["rows"]} == {"MulticlassAccuracy#0", "SumMetric#1"}


# ------------------------------------------------------- the port's own boundaries


def test_dispatch_signature_follows_the_jax_rules():
    """int64 signs as int32 and float64 as float32 (JAX with 64-bit types off), scalars
    are weak, None is no leaf, dict keys flatten sorted: the JAX package's strings."""
    from torchmetrics_tpu.aot import keys as jkeys

    from torchmetrics_tpu_torch.aot import keys as pkeys

    rng = np.random.default_rng(0)
    arrays = [rng.random((3, 2)), rng.integers(0, 4, (5,)), rng.random(4).astype(np.float32) > 0.5,
              rng.integers(0, 4, (2, 2)).astype(np.uint8), rng.random(2).astype(np.float16)]
    cases = [
        (tuple(arrays), {}),
        ((arrays[0],), {"z": 1.0, "a": True, "m": None, "k": 3}),
        (([arrays[1], (arrays[2], None)],), {"w": {"y": arrays[3], "b": 2 + 1j}}),
        ((arrays[4], "text"), {}),
    ]
    for args, kwargs in cases:
        want = jkeys.dispatch_signature((jax_tree(args, jnp.asarray), jax_tree(kwargs, jnp.asarray)))
        got = pkeys.dispatch_signature((jax_tree(args, torch.as_tensor), jax_tree(kwargs, torch.as_tensor)))
        assert got == want
    assert pkeys.dispatch_signature(None) == jkeys.dispatch_signature(None) == "()"


def jax_tree(tree, to):
    """``tree`` with its numpy leaves converted by ``to``; scalars, None and strings kept."""
    if isinstance(tree, tuple):
        return tuple(jax_tree(t, to) for t in tree)
    if isinstance(tree, list):
        return [jax_tree(t, to) for t in tree]
    if isinstance(tree, dict):
        return {k: jax_tree(v, to) for k, v in tree.items()}
    return to(tree) if isinstance(tree, np.ndarray) else tree


def test_cost_record_counts_the_dispatchs_matmul_and_bytes():
    """A fresh signature's record: ``FlopCounterMode``'s flops of that one call, argument
    and output bytes from metadata; a repeated signature harvests nothing; the keys equal
    the compile keys."""
    m = _Gram(device="cpu")
    x = torch.ones((10, 4))
    with obs.telemetry_session(obs.TelemetryConfig(**_NO_HISTORY_CLOCK)) as rec:
        m.update(x)
        m.update(x)
        m.update(torch.ones((6, 4)))
        costs = rec.cost_snapshot()
        per_key = rec.counters.snapshot().per_key
    assert set(costs) == set(per_key) == {"_Gram#0.update"}
    records = costs["_Gram#0.update"]
    assert list(records) == ["float32(10, 4)", "float32(6, 4)"]
    first = records["float32(10, 4)"]
    assert first["available"] and first["flops"] == 2 * 10 * 4 * 4
    assert first["argument_bytes"] == 64 + 160 and first["output_bytes"] == 64 and first["alias_bytes"] == 0
    assert first["bytes_accessed"] == first["temp_bytes"] == first["generated_code_bytes"] == 0
    assert records["float32(6, 4)"]["flops"] == 2 * 6 * 4 * 4
    with obs.telemetry_session(obs.TelemetryConfig(cost_accounting=False, **_NO_HISTORY_CLOCK)) as rec:
        m.update(x)
        assert rec.cost_snapshot() == {}


def test_a_ctypes_kernel_adds_its_flops_to_every_open_harvest():
    """``add_flops`` reaches every open harvest (nested ones too) and nothing after they
    close: the hook sepconv7's wrapper calls where it launches."""
    outer = obs.costs.DispatchHarvest({"s": torch.zeros(2)}, None)
    inner = obs.costs.DispatchHarvest({}, None)
    obs.costs.add_flops(5)
    with outer:
        obs.costs.add_flops(7)
        with inner:
            obs.costs.add_flops(11)
            torch.ones((2, 3)) @ torch.ones((3, 2))
        obs.costs.add_flops(13)
    obs.costs.add_flops(17)
    assert inner.record("k", "s").flops == 11 + 2 * 2 * 3 * 2
    assert outer.record("k", "s").flops == 7 + 11 + 13 + 2 * 2 * 3 * 2
    placeholder = obs.costs.harvest_record("k", "s", None)
    assert not placeholder.available and placeholder.error


def test_tracing_is_the_torch_profilers_and_graph_scope_a_no_op():
    """Each boundary opens a ``record_function`` range named like the JAX package's
    annotation; ``graph_scope`` names nothing in eager PyTorch; blocking timing does
    nothing on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    m = _SumState(device="cpu", distributed_available_fn=lambda: True, dist_sync_fn=lambda v, g: [v, v])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.update(_x())
        m.compute()
    names = {e.name for e in prof.events()}
    assert {"_SumState.update", "_SumState.compute", "_SumState.sync", "process_sync"} <= names
    with obs.tracing.graph_scope("x") as scope:
        assert scope is None
    marker = object()
    assert obs.tracing.block_for_timing(marker, torch.device("cpu")) is marker


def test_state_memory_reads_tensor_metadata_and_numpy_names():
    """``numel() * element_size()`` bytes and numpy's dtype names; a fused member points
    at its leader and counts once."""
    m = ttm.CatMetric(device="cpu")
    m.update(torch.tensor([1.0, 2.0, 3.0]))
    m.update(torch.tensor([4.0]))
    assert m.state_memory() == {"states": {"value": {"kind": "list", "nbytes": 16, "elements": 2}},
                                "total_bytes": 16}
    acc = ttm.classification.MulticlassAccuracy(5, device="cpu")
    report = acc.state_memory()["states"]["tp"]
    assert report == {"kind": "tensor", "nbytes": 20, "shape": (5,), "dtype": "int32"}
    assert obs.memory.leaf_nbytes(torch.zeros((2, 3), dtype=torch.bfloat16)) == 12
    assert obs.memory.leaf_nbytes(np.zeros((2, 3), np.float64)) == 48 and obs.memory.leaf_nbytes(3) == 0
    coll = ttm.MetricCollection({"a": ttm.SumMetric(device="cpu"), "b": ttm.SumMetric(device="cpu")}, device="cpu")
    coll.update(_x())
    mem = coll.state_memory()
    assert mem["members"]["b"]["aliased_to"] == "a" and mem["total_bytes"] == mem["members"]["a"]["total_bytes"]


def test_retrace_sentinel_names_offending_shapes():
    m = _SumState(device="cpu")
    cfg = obs.TelemetryConfig(retrace_warn_threshold=2, **_NO_HISTORY_CLOCK)
    with obs.telemetry_session(cfg) as rec:
        with pytest.warns(UserWarning, match=r"Retrace sentinel.*_SumState#\d+\.update"):
            for n in (4, 5, 6, 7):
                m.update(_x(n))
        assert len(rec.events_of("retrace")) == 3
        assert rec.counters.snapshot()["retraces"] == 3
        assert "float32" in rec.events_of("retrace")[0].signature
    with obs.telemetry_session(cfg):
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # stable shapes: the sentinel stays quiet
            m2 = _SumState(device="cpu")
            for _ in range(6):
                m2.update(_x(4))


def test_retry_exhausted_warns_and_emits_event():
    pol = prel.RetryPolicy(max_attempts=2, **_FAST_RETRY)
    m = _SumState(device="cpu", reliability=prel.ReliabilityConfig(retry=pol))
    with obs.telemetry_session() as rec:
        with pytest.warns(UserWarning, match="Retry budget exhausted"):
            with prel.inject_dispatch_fault(m, fail_on=1, times=5, tag="update"):
                with pytest.raises(Exception):
                    m.update(_x())
    snap = rec.counters.snapshot()
    assert snap["retries"] == 1 and snap["retries_exhausted"] == 1
    (ev,) = rec.events_of("retry_exhausted")
    assert ev.metric == "_SumState.update" and ev.payload["attempts"] == 2


@pytest.mark.parametrize("mode,status,counter", [("quarantine", "quarantined", "quarantines"),
                                                 ("skip", "skipped", "skips")])
def test_quarantine_and_skip_events(mode, status, counter):
    col = ttm.MetricCollection({"ok": ttm.SumMetric(device="cpu"), "bad": _SumState(device="cpu")},
                               on_error=mode, device="cpu")
    with obs.telemetry_session() as rec:
        col.update(_x())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with prel.inject_dispatch_fault(col["bad"], fail_on=1, times=5, tag="update"):
                col.update(_x())
    (event,) = rec.events_of("quarantine")
    assert event.metric == "bad" and event.tag == "update" and event.payload["status"] == status
    assert rec.counters.snapshot()[counter] == 1


def test_host_metric_dispatch_recorded():
    h = _HostSum(device="cpu")
    with obs.telemetry_session() as rec:
        h.update(_x())
        h.forward(_x())
    snap = rec.counters.snapshot()
    assert snap["host_dispatches"] == 2 and snap["dispatches"] == 0
    assert all(e.payload.get("jitted") is False for e in rec.events_of("dispatch"))
    assert rec.cost_snapshot() == {}


def test_d2h_at_state_dict_and_compute_on_cpu_appends():
    m = ttm.SumMetric(device="cpu")
    m.persistent(True)
    m.update(_x())
    c = ttm.CatMetric(compute_on_cpu=True, device="cpu")
    with obs.telemetry_session() as rec:
        m.state_dict()
        c.update(_x(4))
        c.update(_x(4))
    snap = rec.counters.snapshot()
    assert snap["d2h_readbacks"] == 3 and snap["d2h_bytes"] == 4 + 32
    assert [e.tag for e in rec.events_of("d2h")] == ["state_dict", "compute_on_cpu_append", "compute_on_cpu_append"]
    # each append's record follows its dispatch's, as the JAX package orders them
    kinds = [e.kind for e in rec.events if e.metric.startswith("CatMetric") and e.kind != "hist"]
    assert kinds == ["dispatch", "d2h", "dispatch", "d2h"]


def test_finiteness_guard_scans_are_counted():
    m = ttm.SumMetric(device="cpu", reliability=prel.ReliabilityConfig(), distributed_available_fn=lambda: True,
                      dist_sync_fn=lambda v, g: [v, v])
    m.update(_x())
    with obs.telemetry_session() as rec:
        m.sync()
    assert [(e.tag, e.payload["nbytes"]) for e in rec.events_of("d2h")] == [("finiteness_guard", 1)]


def test_blocking_timing_mode_records_durations():
    with obs.telemetry_session(obs.TelemetryConfig(block_until_ready=True)) as rec:
        m = _SumState(device="cpu")
        for _ in range(3):
            m.update(_x())
        m.compute()
    spans = rec.events_of("dispatch", "compute")
    assert len(spans) == 4 and all(e.duration_s is not None and e.duration_s >= 0 for e in spans)


def test_fault_injected_run_events_captured():
    flaky = prel.FlakyGather(inner=lambda v, g: [v, v], fail_times=1)
    pol = prel.RetryPolicy(max_attempts=3, **_FAST_RETRY)
    m = _SumState(device="cpu", reliability=prel.ReliabilityConfig(retry=pol), distributed_available_fn=lambda: True,
                  dist_sync_fn=flaky)
    with obs.telemetry_session() as rec:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with prel.inject_dispatch_fault(m, fail_on=1, times=1, tag="update"):
                m.update(_x())
            m.compute()
    snap = rec.counters.snapshot()
    assert snap["retries"] == 2 and snap["sync_calls"] == 2 and flaky.failures == 1
    assert {e.metric for e in rec.events_of("retry")} == {"_SumState.update", "_SumState.sync"}


def test_coalesced_collection_sync_records_once_with_its_collectives():
    coll = ttm.MetricCollection({"a": ttm.SumMetric(device="cpu"), "b": ttm.MaxMetric(device="cpu")}, device="cpu")
    coll.update(_x())
    with obs.telemetry_session() as rec:
        coll.sync(dist_sync_fn=lambda v, g: [v, v], distributed_available=lambda: True)
    (event,) = rec.events_of("sync")
    assert event.metric == "MetricCollection#0"
    assert event.payload == {"payload_bytes": 8, "collectives": 2, "coalesced_leaves": 2}
    snap = rec.counters.snapshot()
    assert snap["sync_calls"] == 1 and snap["gathers_coalesced"] == 2
    assert [h.count for h in [rec.histograms.get("gather_bytes", "coalesced")]] == [1]


def test_per_leaf_fallback_counts_its_gathers():
    """An injected gather that rewrites the metadata sends the sync to the per-leaf
    plane: one gather and one collective a leaf, counted as in the JAX package."""

    def rewriting(v, g=None):
        return [torch.as_tensor(v) + i for i in range(2)]

    m = _SumState(device="cpu", distributed_available_fn=lambda: True, dist_sync_fn=rewriting)
    m.update(_x())
    with obs.telemetry_session() as rec:
        m.sync()
    snap = rec.counters.snapshot()
    assert snap["gather_calls"] == 1 and snap["sync_collectives"] == 2 and snap["gathers_coalesced"] == 0


def test_metric_identity_fresh_per_session():
    survivor = _SumState(device="cpu")
    with obs.telemetry_session() as rec1:
        survivor.update(_x())
    with obs.telemetry_session() as rec2:
        other = _SumState(device="cpu")
        other.update(_x())
        survivor.update(_x())
    assert rec1.counters.snapshot()["dispatches"] == 1
    assert set(rec2.counters.snapshot().per_key) == {"_SumState#0.update", "_SumState#1.update"}
    assert rec2.metric_summary(other)["dispatches"] == rec2.metric_summary(survivor)["dispatches"] == 1


def test_session_lifecycle_and_replacement():
    rec1 = obs.enable()
    assert obs.active() is rec1 and obs.enabled()
    rec2 = obs.enable()  # replaces (closes) rec1
    assert obs.active() is rec2
    out = obs.disable()
    assert out is rec2 and not obs.enabled()
    assert obs.disable() is None
    assert obs.cost_snapshot() == {}
    with pytest.raises(RuntimeError, match="active telemetry session"):
        obs.gather_counters()
