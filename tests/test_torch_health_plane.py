"""The port's health plane against the JAX package's: histograms and quantiles, counters,
spans, events, the recorder's methods (those whose callers are later planes included,
held by direct calls), ``render_prometheus``, the SLO engine, the flight recorder and
``HealthServer`` (``torchmetrics_tpu_torch/observability``).

Both packages take the same calls with the same arguments, so every output must be equal:
text byte for byte, reports key for key. Durations are fixed arguments here, not clock
reads; what still reads the clock is left out and said so where it is (event timestamps,
the SLO engine's evaluation time where no ``now`` is given).
"""

from __future__ import annotations

import http.client
import json
import warnings

import numpy as np
import pytest
import torch

from torchmetrics_tpu import observability as jobs
from torchmetrics_tpu_torch import observability as obs

pytestmark = pytest.mark.slo


def _mod(which):
    return jobs if which == "jax" else obs


class _Acc:
    """A stand-in metric: an identity for the recorder and a state dict of numpy leaves
    (both packages read numpy metadata alike)."""

    def __init__(self):
        self._state = {"tp": np.zeros(5, np.int32), "total": np.zeros((), np.float32),
                       "preds": [np.zeros(3, np.float32), np.zeros(4, np.float32)]}


class _Fid(_Acc):
    pass


def _drive(O, rec) -> None:
    """Every ``record_*`` method of the recorder once or more, with fixed arguments."""
    a, f = _Acc(), _Fid()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec.record_dispatch(a, "update", None, 0.0012, signature="float32(8,)")
        rec.record_dispatch(a, "update", None, 0.0009, signature="float32(8,)")
        rec.record_dispatch(a, "update", None, 0.003, signature="float32(9,)")
        rec.record_aot_load(f, "update", 0.01, 1234, "key-x", "native")
        rec.record_aot_miss()
        rec.record_dispatch(f, "update", None, 0.02, aot_loaded=True, signature="uint8(2, 3)")
        rec.record_host_dispatch(f, "forward", 0.004)
        rec.record_compute(a, 0.0005)
        rec.record_gather_payload("coalesced", 4096)
        rec.record_gather_payload("per_leaf", 12)
        rec.record_state_memory(a)
        with O.spans.scope("serve", "tenant-1", 3) as ctx:
            rec.record_serve_dispatch(a, rows=6, padded=2, links=[ctx.trace_id])
        rec.record_tenant_spill(a, 0.001, 2048)
        rec.record_tenant_spill(a, 0.0015, 2048, readmit=True)
        rec.record_window_roll(a, 8, 8, True, tier="dual", rotated=True)
        rec.record_window_roll(a, 8, 3, False)
        rec.record_async_sync("acc", 0.004, 0.001, 512, collectives=2)
        rec.record_drift("shift", 0.9, True, 0.5)
        rec.record_drift("calm", 0.1, False, 0.5)
        rec.record_quant("coalesced_sync", "int8", 2, 5, 4000, 1100, feedback_norm=0.25)
        rec.record_serve_rejected(a, "tenant-3")
        rec.record_snapshot(a, "write", 0.01, 9999, 3)
        rec.record_snapshot(a, "restore", 0.02, 9999, 3)
        rec.record_journal_replay(a, 12, 0.002)
        rec.record_degraded_sync("coalesced_sync", [1], 4)
        rec.record_rank_rejoin("coalesced_sync", 1, 2)
        rec.record_fleet_heartbeat("h0")
        rec.record_lease_expiry("h1")
        rec.record_migration("fleet", "h0", "h1", 3, 0.05)
        rec.record_host_failover("fleet", "h1", 3, 10, 1, roster=["t1", "t2"])
        rec.record_d2h("state_dict", 64, metric=a)
        rec.record_d2h("finiteness_guard", 1)
        rec.record_retry("Acc.update", 1, RuntimeError("UNAVAILABLE: x"), delay_s=0.25)
        rec.record_retry_exhausted("Acc.update", 3, RuntimeError("UNAVAILABLE: x"))
        rec.record_quarantine("bad", "update", "quarantined", ValueError("boom"), 2)
        rec.record_sync(a, 0.002, 4096, collectives=2, coalesced_leaves=3)


def _driven(which, **config):
    O = _mod(which)
    rules = (O.SloRule(name="dispatch_p99", expr="p99('update') > 1000", window=60.0, cooldown=30.0),
             O.SloRule(name="tripwire", expr="total('dispatches') > 0", window=10.0, severity="critical",
                       cooldown=0.0))
    flight = O.FlightRecorder(auto_dump=False)
    cfg = O.TelemetryConfig(sinks=(O.RingBufferSink(), flight), slo_rules=rules, slo_eval_on_sync=False,
                            cost_accounting=False, history_clock=lambda: 0.0, **config)
    rec = O.enable(cfg)
    try:
        _drive(O, rec)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rec.evaluate_slos(now=100.0)
            rec.evaluate_slos(now=110.0)
        out = {
            "counters": rec.counters.snapshot().summary(),
            "metric": rec.metric_summary(_Acc()),  # a fresh instance: no record of it
            "latency": rec.latency_summary(),
            "histograms": rec.histogram_snapshot(),
            "memory": rec.memory_snapshot(),
            "slo": rec.slo_snapshot(),
            "drift": rec.drift_scores(),
            "quant_norm": rec.quant_feedback_norm(),
            "events": [{k: v for k, v in e.to_dict().items() if k != "timestamp"} for e in rec.events],
            "prometheus": O.render_prometheus(rec),
            "flight": {k: v for k, v in flight.dump("drill", extra={"note": 1}).items() if k != "runtime"},
        }
    finally:
        O.disable()
    return out


@pytest.fixture(scope="module")
def driven():
    return {which: _driven(which) for which in ("jax", "port")}


@pytest.mark.parametrize("part", ["counters", "metric", "latency", "histograms", "memory", "slo", "drift",
                                  "quant_norm", "events", "flight"])
def test_recorder_reports_equal_the_jax_packages(driven, part):
    """Event timestamps are left out (the monotonic clock); every duration here is a
    fixed argument, so latency reports compare exactly."""
    assert driven["port"][part] == driven["jax"][part]


def test_render_prometheus_is_the_jax_packages_byte_for_byte(driven):
    text = driven["port"]["prometheus"]
    assert text == driven["jax"]["prometheus"]
    assert "tpu_metrics_dispatches_total 4" in text and "tpu_metrics_telemetry_enabled 1" in text
    assert 'tpu_metrics_latency_seconds_count{kind="update",key="_Acc#0"} 3' in text


def test_recorder_counts_every_later_plane_record(driven):
    counts = driven["port"]["counters"]
    expect = {"serve_dispatches": 1, "tenant_spills": 1, "tenant_readmits": 1, "window_rolls": 2,
              "window_rotations": 1, "async_syncs": 1, "drift_checks": 2, "drift_breaches": 1,
              "quantized_buckets": 2, "serve_rejected": 1, "snapshot_writes": 1, "snapshot_restores": 1,
              "journal_replays": 1, "degraded_syncs": 1, "rank_rejoins": 1, "fleet_heartbeats": 1,
              "lease_expiries": 1, "host_failovers": 1, "tenant_migrations": 3, "aot_cache_hits": 1,
              "aot_cache_misses": 1, "retries": 1, "retries_exhausted": 1, "quarantines": 1}
    got = {k: counts[k] for k in expect if k in counts}
    assert got == {k: v for k, v in expect.items() if k in counts}
    assert len(got) >= 20


# ------------------------------------------------------------ the stdlib modules


def _histogram_scenario(O):
    H = O.histograms
    values = [0, 1, 2, 3, 1024, (1 << 60), 5, 300, 7, 100_000]
    placement = [H.bucket_index(v) for v in values] + [list(H.bucket_bounds(b)) for b in (0, 5, H.N_BUCKETS - 1)]
    a, b = H.Histogram(), H.Histogram()
    for v in (1, 5, 5, 300):
        a.record(v)
    for v in (7, 100_000):
        b.record(v)
    merged = a.copy().merge(b)
    back = H.Histogram.from_vector(merged.to_vector())
    rng = np.random.default_rng(7)
    samples = (np.exp(rng.normal(7.0, 2.0, 2000)).astype(np.int64) + 1).tolist()
    big = H.Histogram()
    for v in samples:
        big.record(int(v))
    regs = []
    for r in range(3):
        reg = H.HistogramRegistry()
        for i in range(50 * (r + 1)):
            reg.record_duration("update", f"M#{r}", (i + 1) * 1e-5 * (r + 1))
            reg.record("sync_payload", f"M#{r}", (i + 1) * 64)
        regs.append(reg.fleet_vector())
    fleet = O.aggregate_histograms(regs)
    return {"placement": placement, "merged": merged.summary(), "back": back.summary(),
            "percentiles": big.percentiles(), "ladder": [big.percentile(q) for _, q in H.PERCENTILES],
            "fleet_vector": H.merge_vectors(regs), "fleet": {k: h.summary() for k, h in fleet.items()},
            "kinds": list(O.FLEET_HISTOGRAM_KINDS), "vec_len": H.FLEET_VECTOR_LEN}


def _quantile_scenario(O):
    Q = O.histograms
    buckets = {0: 3, 2: 5, 7: 1, 20: 4}
    return [Q.percentile_from_buckets(buckets, sum(buckets.values()), q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)]


def _counters_scenario(O):
    c = O.Counters()
    c.record_dispatch("A#0.update", "float32(8,)")
    early = c.snapshot()
    c.record_dispatch("A#0.update", "float32(8,)")
    c.record_dispatch("A#0.update", "float32(9,)")
    c.record_dispatch("B#1.forward", "int32(2,)", aot_loaded=True)
    c.record_sync(4096)
    c.record_sync_time(0.0123)
    c.record_d2h(64)
    c.record_quarantine("skipped")
    late = c.snapshot()
    ranks = [late, early.counts, early.counts_vector()]
    return {"late": late.summary(), "brief": late.summary(brief=True), "diff": late.diff(early).summary(),
            "vector": late.counts_vector(), "fields": list(O.COUNTER_FIELDS),
            "fleet": O.aggregate_counters(ranks).summary(), "fleet_brief": O.aggregate_counters(ranks).summary(True),
            "signatures": c.signatures("A#0.update")}


def _spans_scenario(O):
    S = O.spans
    t1 = S.derive_trace_id("serve", "7", 3)
    out = [t1, S.derive_trace_id("serve", "7", 4), S.derive_span_id(t1, None, "a"),
           S.derive_span_id(t1, S.derive_span_id(t1, None, "a"), "a")]
    root = S.enter("root", 1)
    child = S.enter("child")
    out += [root.trace_id, root.span_id, child.span_id, child.parent_id]
    S.exit(root)
    with S.scope("scoped", 9) as ctx:
        out += [ctx.trace_id, ctx.span_id]
    return out


def _events_scenario(O):
    ev = O.TelemetryEvent(kind="dispatch", metric="A#0", tag="update", timestamp=1.5, duration_s=0.25,
                          signature="float32(8,)", cache_hit=True, payload={"x": 1})
    ring = O.RingBufferSink(3)
    for i in range(5):
        ring.emit(O.TelemetryEvent(kind="d2h", metric=f"M#{i}", tag="state_dict", timestamp=float(i)))
    return {"event": ev.to_dict(), "ring": [e.to_dict() for e in ring.events], "kinds": list(O.EVENT_KINDS)}


@pytest.mark.parametrize("scenario", [_histogram_scenario, _quantile_scenario, _counters_scenario,
                                      _spans_scenario, _events_scenario], ids=lambda f: f.__name__[1:-9])
def test_stdlib_modules_give_the_jax_packages_outputs(scenario):
    assert scenario(obs) == scenario(jobs)


def test_jsonl_sink_writes_the_jax_packages_lines(tmp_path):
    """Line for line, timestamps aside."""
    lines = {}
    for which in ("jax", "port"):
        O = _mod(which)
        path = tmp_path / f"{which}.jsonl"
        sink = O.JSONLSink(str(path), host="rank0")
        with O.telemetry_session(O.TelemetryConfig(sinks=(sink,), cost_accounting=False,
                                                   history_clock=lambda: 0.0)) as rec:
            _drive(O, rec)
        lines[which] = [{k: v for k, v in json.loads(line).items() if k != "timestamp"}
                        for line in path.read_text().splitlines()]
    assert lines["port"] == lines["jax"] and len(lines["port"]) > 40


def test_callback_sink_and_flight_recorder_auto_dump(tmp_path):
    """The auto-dump on a terminal event writes the same artifact, runtime block aside."""
    arts = {}
    for which in ("jax", "port"):
        O = _mod(which)
        seen = []
        flight = O.FlightRecorder(dump_dir=str(tmp_path / which))
        cfg = O.TelemetryConfig(sinks=(O.RingBufferSink(), O.CallbackSink(seen.append), flight),
                                history_clock=lambda: 0.0)
        with O.telemetry_session(cfg) as rec:
            with O.spans.scope("collection", "acc"):
                rec.record_quarantine("acc", "update", "frozen", ValueError("boom"), 7)
        files = sorted(p.name for p in (tmp_path / which).iterdir())
        art = json.loads((tmp_path / which / files[0]).read_text())
        art.pop("runtime")
        arts[which] = (files, art, [e.kind for e in seen])
    assert arts["port"] == arts["jax"]
    assert arts["port"][0] == ["flightrec-quarantine-0001.json"]


def test_slo_engine_under_an_injected_clock_trips_and_cools_down():
    """The JAX package's breach, cooldown and re-fire sequence, alert for alert."""
    runs = {}
    for which in ("jax", "port"):
        O = _mod(which)
        rule = O.SloRule(name="update_p99", expr="p99('update') > 1000", window=60.0, cooldown=30.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with O.telemetry_session(O.TelemetryConfig(slo_rules=(rule,), history_clock=lambda: 0.0)) as rec:
                for _ in range(10):
                    rec.histograms.record_duration("update", "M#0", 0.050)
                fired = [rec.slo.evaluate(rec, now=t) for t in (100.0, 110.0, 131.0)]
                runs[which] = (fired, rec.slo.snapshot(), rec.counters.snapshot()["alerts"])
    assert runs["port"] == runs["jax"]
    assert [len(f) for f in runs["port"][0]] == [1, 0, 1] and runs["port"][2] == 2


def test_default_rules_are_the_jax_packages():
    assert [vars(r) if hasattr(r, "__dict__") else r for r in obs.default_rules()] == \
        [vars(r) if hasattr(r, "__dict__") else r for r in jobs.default_rules()]


# -------------------------------------------------------------- (g) HealthServer


def _get(server, path):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode("utf-8")
    conn.close()
    return resp.status, resp.getheader("Content-Type", ""), body


_ENDPOINTS = ("/healthz", "/metricsz", "/costz", "/sloz", "/fleetz", "/historyz", "/historyz?level=0",
              "/historyz?at=yesterday", "/nothing")


def _serve_all(which):
    O = _mod(which)
    rule = O.SloRule(name="tripwire", expr="total('dispatches') > 0", window=10.0, severity="critical",
                     cooldown=0.0)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with O.telemetry_session(O.TelemetryConfig(slo_rules=(rule,), cost_accounting=False,
                                                   history_clock=lambda: 0.0)) as rec:
            _drive(O, rec)
            with O.HealthServer(host="127.0.0.1", port=0) as server:
                for path in _ENDPOINTS:
                    status, ctype, body = _get(server, path)
                    doc = body if path == "/metricsz" else json.loads(body)
                    if path == "/sloz":  # each request evaluates on the monotonic clock: the
                        # alert times, their windows and the ring's thinned sample count follow it
                        doc.pop("samples")
                        for alert in doc.get("recent_alerts", ()):
                            alert.pop("at")
                            alert.pop("window")
                    out[path] = (status, ctype.split(";")[0], doc)
        with O.HealthServer(host="127.0.0.1", port=0) as server:
            out["no session"] = _get(server, "/healthz")[:2] + (json.loads(_get(server, "/healthz")[2]),)
    return out


def test_health_server_answers_the_jax_packages_endpoints():
    """On 127.0.0.1 at port 0: every endpoint's status, content type and body equal the
    JAX package's for the same recorder; ``/healthz`` is 503 while the critical rule is
    breached; no session answers ok."""
    got, want = _serve_all("port"), _serve_all("jax")
    for path in want:
        assert got[path] == want[path], path
    assert got["/healthz"][0] == 503 and got["/healthz"][2]["breached_rules"] == ["tripwire"]
    assert got["/nothing"][0] == 404 and got["/historyz?at=yesterday"][0] == 400
    assert got["/fleetz"][2] == {"fleet": False}
    assert got["no session"] == (200, "application/json", {"status": "ok", "telemetry": False})


def test_metrics_flusher_writes_the_rendered_text_atomically(tmp_path):
    path = tmp_path / "metrics.prom"
    m = torch.zeros(1)
    with obs.telemetry_session(obs.TelemetryConfig(history_clock=lambda: 0.0)) as rec:
        rec.record_dispatch(_Acc(), "update", (m,), 0.001)
        flusher = obs.MetricsFlusher(str(path), interval_s=60.0)
        text = flusher.flush_now()
    assert path.read_text() == text and "tpu_metrics_dispatches_total 1" in text
    assert not (tmp_path / "metrics.prom.tmp").exists()
    flusher.flush_now()
    assert "tpu_metrics_telemetry_enabled 0" in path.read_text()
    with pytest.raises(ValueError, match="interval_s"):
        obs.MetricsFlusher(str(path), interval_s=0)
