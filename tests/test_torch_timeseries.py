"""The port's telemetry history against the JAX package's: ``streaming/telescope.py``'s
``TelescopingFold``, ``observability/timeseries.py``'s ``TelemetryHistory``, the
burn-rate and delta rule helpers and ``/historyz`` (``torchmetrics_tpu_torch``).

Every clock here is injected, so both packages see the same instants and must retain
the same blocks, answer the same queries and page the same alerts.
"""

from __future__ import annotations

import http.client
import json
import warnings

import pytest

from torchmetrics_tpu import observability as jobs
from torchmetrics_tpu.streaming.telescope import TelescopingFold as JFold
from torchmetrics_tpu_torch import observability as obs
from torchmetrics_tpu_torch.streaming.telescope import TelescopingFold as PFold

pytestmark = pytest.mark.timeseries


def _fold_run(Fold):
    f = Fold(spans=(1.0, 10.0, 60.0))
    out = []
    for i in range(400):
        f.feed(i * 0.7, [i % 3, 1])
        if i % 97 == 0:
            out.append([f.blocks(level) for level in range(3)])
    f.feed(3.0, [100, 100])  # out of order: kept in the open block
    out.append([f.blocks(level) for level in range(3)])
    return out, f.folds, f.block_count(), Fold().spans, Fold().keep


def test_telescoping_fold_equals_the_jax_packages():
    assert _fold_run(PFold) == _fold_run(JFold)


@pytest.mark.parametrize("spans", [(10.0, 1.0), ()])
def test_telescoping_fold_refuses_the_same_spans(spans):
    with pytest.raises(ValueError) as jax_err:
        JFold(spans=spans)
    with pytest.raises(ValueError) as port_err:
        PFold(spans=spans)
    assert str(port_err.value) == str(jax_err.value)


def _history_run(O):
    clock = {"t": 0.0}
    with O.telemetry_session(O.TelemetryConfig(history_clock=lambda: clock["t"])) as rec:
        for i in range(150):
            clock["t"] += 1.5
            rec.counters.record_dispatch("m", f"sig{i % 4}")
            rec.counters.record_sync_time(0.000123 * (i + 1))  # wall-clock-tainted: dropped from exports
            rec.histograms.record_duration("update", "M#0", 0.001 * (1 + i % 5))
            rec.observe_history()
        t = clock["t"]
        out = {
            "at_end": rec.history.at(t - 0.5), "at_early": rec.history.at(2.0), "before": rec.history.at(-5.0),
            "range": rec.history.range(0.0, t + 1.0, level=1), "levels": rec.history.levels(),
            "block": rec.history_block(last_n=6), "folds": rec.history.folds,
            "fold_counter": rec.counters.snapshot().counts["history_folds"],
            "events": [(e.kind, e.payload) for e in rec.events_of("history")],
        }
    return json.loads(json.dumps(out))


def test_history_retains_and_answers_as_the_jax_packages():
    got, want = _history_run(obs), _history_run(jobs)
    assert got == want
    assert got["at_end"] is not None and got["at_early"]["level"] >= 1 and got["before"] is None
    assert got["folds"] == got["fold_counter"] > 0
    assert all("sync_time_us" not in b["counters"] for lv in got["block"]["levels"] for b in lv["blocks"])


def test_history_validates_vector_lengths_as_the_jax_package():
    for O in (obs, jobs):
        h = O.TelemetryHistory(clock=lambda: 0.0)
        with pytest.raises(ValueError, match="history sample"):
            h.observe([0, 1], [0] * O.histograms.FLEET_VECTOR_LEN)
    with obs.telemetry_session(obs.TelemetryConfig(history_spans=None)) as rec:
        assert rec.history is None and rec.observe_history() == 0 and rec.history_block() is None


_SINGLE = dict(name="single_window_d2h", expr="d2h_readbacks / window > 0.04", window=60.0, cooldown=120.0,
               severity="warning")
_BURN = dict(name="burn_d2h", expr="burn('d2h_readbacks / window > 0.04', 60.0, 600.0)", window=60.0,
             cooldown=1800.0, severity="critical")


def _burn_run(O, sustained=True):
    clock = {"t": 0.0}
    rules = (O.SloRule(**_SINGLE), O.SloRule(**_BURN))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with O.telemetry_session(O.TelemetryConfig(slo_rules=rules, slo_eval_on_sync=False,
                                                   history_clock=lambda: clock["t"])) as rec:
            while clock["t"] < 1200.0:
                clock["t"] += 10.0
                if clock["t"] == 100.0:
                    for _ in range(3):  # the transient spike
                        rec.counters.record_d2h(64)
                if sustained and clock["t"] >= 600.0:
                    rec.counters.record_d2h(64)
                rec.evaluate_slos(now=clock["t"])
            pages = [(e.kind, e.metric, e.tag, e.payload) for e in rec.events_of("burn_alert", "alert")]
            counts = rec.counters.snapshot().counts
    return pages, counts["burn_alerts"], counts["alerts"]


@pytest.mark.parametrize("sustained", [True, False])
def test_burn_rate_rule_pages_as_the_jax_packages(sustained):
    got, want = _burn_run(obs, sustained), _burn_run(jobs, sustained)
    assert got == want
    assert got[1] == (1 if sustained else 0)


def test_rate_and_delta_helpers_evaluate_as_the_jax_packages():
    runs = []
    for O in (obs, jobs):
        rule = O.SloRule(name="rate_rule", expr="rate('d2h_readbacks', 10.0) > 0.5 and "
                         "delta('d2h_readbacks', 10.0) >= 6", window=10.0, cooldown=1e9)
        bad = O.SloRule(name="bad", expr="delta('nope', 5.0) > 0", window=5.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with O.telemetry_session(O.TelemetryConfig(slo_rules=(rule, bad), slo_eval_on_sync=False,
                                                       history_clock=lambda: 0.0)) as rec:
                first = rec.evaluate_slos(now=1.0)
                for _ in range(8):
                    rec.counters.record_d2h(1)
                second = rec.evaluate_slos(now=11.0)
                runs.append((first, second, rec.slo.snapshot()["rules"]))
    assert runs[0] == runs[1]
    assert runs[0][2]["rate_rule"]["breached"] and runs[0][2]["bad"]["error"]


def _historyz(O):
    clock = {"t": 0.0}
    docs = {}
    with O.telemetry_session(O.TelemetryConfig(history_clock=lambda: clock["t"])) as rec:
        for i in range(120):
            clock["t"] += 2.0
            rec.counters.record_dispatch("m", f"sig{i % 3}")
            rec.observe_history()
        with O.HealthServer(host="127.0.0.1", port=0) as server:
            for path in ("/historyz", f"/historyz?at={clock['t'] - 1.0}", "/historyz?level=1",
                         "/historyz?at=yesterday"):
                conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
                conn.request("GET", path)
                resp = conn.getresponse()
                docs[path] = (resp.status, json.loads(resp.read().decode("utf-8")))
                conn.close()
        in_process = json.loads(json.dumps(rec.history.at(clock["t"] - 1.0)))
    return docs, in_process


def test_historyz_answers_as_the_jax_packages_and_as_in_process_queries():
    (got, at), (want, _) = _historyz(obs), _historyz(jobs)
    assert got == want
    (status, doc), = [v for k, v in got.items() if "at=2" in k]
    assert status == 200 and doc["block"] == at
    assert got["/historyz?at=yesterday"][0] == 400


def test_flight_recorder_carries_the_jax_packages_history_block(tmp_path):
    blocks = {}
    for name, O in (("port", obs), ("jax", jobs)):
        clock = {"t": 0.0}
        flight = O.FlightRecorder(dump_dir=str(tmp_path / name))
        with O.telemetry_session(O.TelemetryConfig(sinks=(O.RingBufferSink(), flight),
                                                   history_clock=lambda: clock["t"])) as rec:
            for i in range(60):
                clock["t"] += 1.0
                rec.counters.record_dispatch("m", f"sig{i % 2}")
                rec.observe_history()
            artifact = flight.dump("drill")
            assert artifact["history"] == rec.history_block()
        blocks[name] = json.dumps(artifact["history"], sort_keys=True)
    assert blocks["port"] == blocks["jax"]
