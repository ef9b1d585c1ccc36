"""The port's chaos plane (``torchmetrics_tpu_torch/chaos``) held against the JAX
package's (``torchmetrics_tpu/chaos``) on the CPU, from the same seeds. Mirrors
``tests/test_chaos.py`` and the soak drills of ``tests/test_durability.py``.

- **traffic**: one seed is one stream, schedule and batches, equal to the JAX model's;
  ``trace_bytes()`` equal byte for byte; a trace written by either package loads in
  the other;
- **schedules**: ``FaultSchedule`` JSON and ``default_fault_schedule`` equal;
- **soaks**: ``bench.py``'s ``production_soak`` and ``durable_failover`` configs at
  their published sizes give the JAX package's ``SoakReport.counters``, ``history``,
  ``faults``, ``reconciliation`` and ``config`` (its ``state_digest`` included), key
  for key: no key differs, so none is set apart. The port's soak repeats itself, a
  JAX-recorded trace replays in it, and every fault kind ends at its designed outcome;
- **digests**: ``_engine_digest`` is the JAX hex digest on the same states.

Tolerances: none. Counters are integers, digests sha256 over exact bytes.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import pytest

from torchmetrics_tpu import chaos as jchaos
from torchmetrics_tpu import serving as jserving
from torchmetrics_tpu.chaos import soak as jsoak
from torchmetrics_tpu.classification import MulticlassAccuracy as JAccuracy
from torchmetrics_tpu_torch import chaos as pchaos
from torchmetrics_tpu_torch import serving as pserving
from torchmetrics_tpu_torch.chaos import (
    FAULT_KINDS,
    FaultSchedule,
    FaultSpec,
    SoakConfig,
    TrafficConfig,
    TrafficModel,
    default_fault_schedule,
    run_soak,
    soak_rules,
)
from torchmetrics_tpu_torch.chaos import soak as psoak
from torchmetrics_tpu_torch.classification import MulticlassAccuracy as PAccuracy
from torchmetrics_tpu_torch.fleet.controller import _tenant_host_states
from torchmetrics_tpu_torch.parallel import coalesce as C
from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine, TrafficJournal
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

pytestmark = pytest.mark.chaos

CPU = {"device": "cpu"}
TRAFFIC_CONFIGS = {
    "default": {},
    "production": {"seed": 23, "tenants": 24, "steps": 120},
    "churn": {"seed": 9, "tenants": 8, "steps": 90, "churn_every": 20, "churn_count": 3},
    "serving_scale": {"seed": 23, "tenants": 8000, "steps": 120, "base_rate": 64.0, "shape_classes": (32,),
                      "num_classes": 10, "churn_every": 30, "churn_count": 256},
}


def _quiet(call):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # SLO breach and retry warnings are the point
        return call()


# ------------------------------------------------------------------ traffic


@pytest.mark.parametrize("name", sorted(TRAFFIC_CONFIGS))
def test_traffic_schedule_and_batches_equal_the_jax_model(name):
    kw = TRAFFIC_CONFIGS[name]
    got, want = TrafficModel(TrafficConfig(**kw)), jchaos.TrafficModel(jchaos.TrafficConfig(**kw))
    for a, b in zip(got.schedule(), want.schedule()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32
    assert got.num_events == want.num_events > 0
    for ea, eb in zip(got.events(), want.events()):
        assert (ea.index, ea.step, ea.tenant_id, ea.shape_class) == (eb.index, eb.step, eb.tenant_id, eb.shape_class)
        for x, y in zip(ea.batch, eb.batch):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        if ea.index >= 64:
            break
    assert got.trace_bytes() == want.trace_bytes()


def test_traces_cross_load_byte_for_byte(tmp_path):
    cfg = dict(seed=11, tenants=10, steps=40)
    port, jax_model = TrafficModel(TrafficConfig(**cfg)), jchaos.TrafficModel(jchaos.TrafficConfig(**cfg))
    assert port.save_trace(str(tmp_path / "port.trace")) == jax_model.save_trace(str(tmp_path / "jax.trace"))
    assert (tmp_path / "port.trace").read_bytes() == (tmp_path / "jax.trace").read_bytes()
    back = TrafficModel.load_trace(str(tmp_path / "jax.trace"))
    jback = jchaos.TrafficModel.load_trace(str(tmp_path / "port.trace"))
    assert back.replayed and jback.replayed and not port.replayed
    assert back.config == port.config and back.trace_bytes() == jback.trace_bytes() == port.trace_bytes()
    for ea, eb in zip(back.events(), port.events()):
        assert ea.tenant_id == eb.tenant_id and ea.step == eb.step
        np.testing.assert_array_equal(ea.batch[0], eb.batch[0])


def test_same_seed_same_stream_skew_and_churn():
    a, b = TrafficModel(TrafficConfig(seed=5)), TrafficModel(TrafficConfig(seed=5))
    for x, y in zip(a.schedule(), b.schedule()):
        np.testing.assert_array_equal(x, y)
    c = TrafficModel(TrafficConfig(seed=6))
    assert c.num_events != a.num_events or not np.array_equal(c.schedule()[1], a.schedule()[1])
    _, tenants = TrafficModel(TrafficConfig(seed=3, tenants=16, steps=200, churn_every=0)).schedule()
    counts = np.bincount(tenants, minlength=16)
    assert counts[0] > counts[8] and counts[0] > counts[15] and counts[:4].sum() > counts[8:].sum()
    model = TrafficModel(TrafficConfig(seed=9, tenants=8, steps=90, churn_every=20, churn_count=3))
    assert int(model.schedule()[1].max()) >= 8  # churn brought new ids
    ev = next(e for e in model.events() if e.index == 7)  # batches key on (seed, index) alone
    preds, target = model._batch(7, ev.tenant_id)
    np.testing.assert_array_equal(ev.batch[0], preds)
    np.testing.assert_array_equal(ev.batch[1], target)
    assert repr(model).startswith("TrafficModel(seed=9")


def test_trace_rejects_garbage_and_saves_atomically(tmp_path):
    bad = tmp_path / "bad.trace"
    bad.write_bytes(b"NOTATRACE-at-all")
    with pytest.raises(TorchMetricsUserError, match="bad magic"):
        TrafficModel.load_trace(str(bad))
    model = TrafficModel(TrafficConfig(seed=1, tenants=4, steps=20))
    cut = tmp_path / "cut.trace"
    cut.write_bytes(model.trace_bytes()[:-8])
    with pytest.raises(TorchMetricsUserError, match="truncated"):
        TrafficModel.load_trace(str(cut))
    trace = tmp_path / "soak.trace"
    trace.write_bytes(b"TORN-GARBAGE-FROM-A-CRASHED-WRITER")
    model.save_trace(str(trace))
    assert TrafficModel.load_trace(str(trace)).trace_bytes() == model.trace_bytes()
    sched = default_fault_schedule(30)
    faults = tmp_path / "faults.json"
    faults.write_text('{"version": 1, "faults": [{"torn')
    with pytest.raises(TorchMetricsUserError):
        FaultSchedule.load(str(faults))
    sched.save(str(faults))
    assert FaultSchedule.load(str(faults)).specs == sched.specs
    assert not any(".tmp-" in name for name in os.listdir(tmp_path))


def test_traffic_config_and_fault_spec_validate():
    for kw, match in (({"seed": -1}, "seed"), ({"tenants": 0}, "tenants"), ({"burst_prob": 1.5}, "burst_prob"),
                      ({"shape_classes": ()}, "shape_classes"), ({"num_classes": 1}, "num_classes")):
        with pytest.raises(ValueError, match=match):
            TrafficConfig(**kw)
    for kw, match in (({"kind": "meteor_strike"}, "kind"), ({"kind": "tenant_fault"}, "tenant_fault"),
                      ({"kind": "clock_skew", "target": "sideways"}, "clock_skew"),
                      ({"kind": "dispatch_transient", "count": 0}, "count"),
                      ({"kind": "host_loss"}, "host_loss")):
        with pytest.raises(ValueError, match=match):
            FaultSpec(step=0, **kw)
    with pytest.raises(ValueError, match="step"):
        FaultSpec(step=-1, kind="dispatch_transient")


# ----------------------------------------------------------------- schedule


@pytest.mark.parametrize("steps, tenant", [(10, 1), (60, 2), (120, 1), (121, 7)])
def test_fault_schedule_json_equals_the_jax_schedule(steps, tenant):
    sched = default_fault_schedule(steps, tenant=tenant)
    want = jchaos.default_fault_schedule(steps, tenant=tenant)
    assert sched.to_json() == want.to_json()
    assert [dataclasses.astuple(s) for s in sched] == [dataclasses.astuple(s) for s in want]
    assert FaultSchedule.from_json(want.to_json()).specs == sched.specs
    assert jchaos.FaultSchedule.from_json(sched.to_json()).specs == want.specs
    assert repr(sched) == repr(want) and sched.last_step == want.last_step < steps
    # every single-host kind; the host kinds are the fleet soak's alone
    assert {s.kind for s in sched} == set(FAULT_KINDS) - {"host_loss", "host_join"}


def test_fault_kinds_schedule_rules_and_round_trip(tmp_path):
    assert FAULT_KINDS == jchaos.FAULT_KINDS
    mixed = [FaultSpec(step=8, kind="host_loss", target="host-1"), FaultSpec(step=2, kind="clock_skew", target="-1.5"),
             FaultSpec(step=8, kind="host_join"), FaultSpec(step=2, kind="tenant_fault", target="4", count=2)]
    sched = FaultSchedule(mixed)
    want = jchaos.FaultSchedule([jchaos.FaultSpec(**dataclasses.asdict(s)) for s in mixed])
    assert sched.to_json() == want.to_json()
    assert sched.due(2) == list(sched.specs[:2]) and not sched.due(3) and len(sched) == 4
    path = str(tmp_path / "faults.json")
    sched.save(path)
    assert FaultSchedule.load(path).specs == sched.specs
    with pytest.raises(TorchMetricsUserError, match="malformed"):
        FaultSchedule.from_json('{"version": 1, "faults": [{"bogus": true}]}')
    with pytest.raises(TorchMetricsUserError, match="FaultSpec"):
        FaultSchedule([{"step": 1}])
    with pytest.raises(ValueError, match="10 steps"):
        default_fault_schedule(9)
    assert [(r.name, r.expr, r.window, r.severity) for r in soak_rules(0.25, 0.5)] == [
        (r.name, r.expr, r.window, r.severity) for r in jsoak.soak_rules(0.25, 0.5)]


# --------------------------------------------------------------------- soak


def _published(lib, name, root=None):
    """``bench.py``'s configs, as published (``bench.py:1318-1347``, ``:1372-1410``)."""
    if name == "production_soak":
        return lib.SoakConfig(traffic=lib.TrafficConfig(seed=23, tenants=24, steps=120), capacity=8,
                              megabatch_size=4, spill_codec="int8", sync_codec="bf16", max_tenants_per_sec=40.0)
    return lib.SoakConfig(traffic=lib.TrafficConfig(seed=31, tenants=24, steps=120), capacity=8, megabatch_size=4,
                          spill_codec="none", max_tenants_per_sec=40.0, durability_dir=str(root),
                          snapshot_every=30, failover_at=70, journal_fsync_every=1)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Each published config once in the JAX package and once in the port; the
    production soak a second time in the port (determinism), and the durable one's
    uninterrupted reference in the port (``bench.py``'s recovery parity)."""
    root = tmp_path_factory.mktemp("soaks")
    out = {}
    for name in ("production_soak", "durable_failover"):
        out[name] = {
            "jax": _quiet(lambda: jchaos.run_soak(_published(jchaos, name, root / f"jax_{name}"))),
            "port": _quiet(lambda: run_soak(_published(pchaos, name, root / f"port_{name}"), **CPU)),
        }
    out["production_soak"]["again"] = _quiet(lambda: run_soak(_published(pchaos, "production_soak"), **CPU))
    out["durable_failover"]["reference"] = _quiet(lambda: run_soak(dataclasses.replace(
        _published(pchaos, "durable_failover", root / "unused"), durability_dir=None, snapshot_every=None,
        failover_at=None), **CPU))
    return out


@pytest.mark.parametrize("block", ["counters", "history", "faults", "reconciliation", "config"])
@pytest.mark.parametrize("name", ["production_soak", "durable_failover"])
def test_published_soak_blocks_equal_the_jax_package(reports, name, block):
    """Key for key, the state digest included (``config``); no key is set apart."""
    got, want = getattr(reports[name]["port"], block), getattr(reports[name]["jax"], block)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        assert {k: v for k, v in got.items() if v != want[k]} == {}
    assert got == want


def test_soak_is_deterministic(reports):
    r1, r2 = reports["production_soak"]["port"], reports["production_soak"]["again"]
    assert r1.counters == r2.counters and r1.faults == r2.faults and r1.history == r2.history
    assert r1.config["state_digest"] == r2.config["state_digest"]
    assert r1.reconciliation["exact"] and r2.reconciliation["exact"]


def test_soak_recovers_every_fault_kind(reports):
    r1 = reports["production_soak"]["port"]
    assert {rec["kind"]: rec["outcome"] for rec in r1.faults} == {
        "rank_loss": "recovered",
        "dispatch_transient": "recovered",
        "tenant_fault": "quarantined",
        "state_poison": "recovered",
        "gather_flaky": "recovered",
        "clock_skew": "recovered",
        "coordination_outage": "recovered",
    }
    c = r1.counters
    assert c["unrecovered_faults"] == 0 and c["quarantined_faults"] == 1 and c["recovered_faults"] >= 6
    assert c["degraded_syncs"] >= 1 and c["rank_rejoins"] >= 1 and c["degraded_sync_parity"] == 1.0
    assert c["faults_injected"] >= c["recovered_faults"] + c["quarantined_faults"]
    assert C.dead_ranks() == {}  # the ledger drained


def test_soak_reconciles_and_exercises_every_plane(reports):
    r1 = reports["production_soak"]["port"]
    rec = r1.reconciliation
    assert rec["jit_compiles"] + rec["jit_cache_hits"] + rec["aot_cache_hits"] == rec["dispatches"]
    c = r1.counters
    assert c["admitted"] > 0 and c["events"] == c["admitted"] + c["shed"] + c["dropped_quarantined"]
    assert c["shed"] > 0 and c["engine_rejected_batches"] == c["shed"]
    assert c["engine_spills"] > 0 and c["engine_readmissions"] > 0
    assert c["drift_evals"] > 0 and c["epochs"] > 0 and 0.0 < c["shed_rate"] < 1.0
    assert r1.timing["tenants_per_sec"] > 0 and r1.timing["update_p99_us"] >= r1.timing["update_p50_us"] > 0
    assert "unrecovered=0" in r1.summary() and r1.to_dict()["counters"] == r1.counters


def test_durable_failover_recovers_to_the_uninterrupted_run(reports):
    r = reports["durable_failover"]["port"]
    c = r.counters
    assert c["failovers"] == 1 and c["failover_state_parity"] == 1.0 and c["failover_rpo_records"] == 0
    assert c["degraded_sync_parity"] == 1.0 and c["unrecovered_faults"] == 0
    assert c["journal_records"] == c["journal_fsyncs"] > 0 and c["snapshot_restores"] == 1
    assert r.config["state_digest"] == reports["durable_failover"]["reference"].config["state_digest"]
    assert r.timing["failover_rto_ms"] > 0.0


def test_jax_recorded_trace_replays_in_the_port(reports, tmp_path):
    cfg = _published(pchaos, "production_soak")
    path = str(tmp_path / "soak.trace")
    jchaos.TrafficModel(jchaos.TrafficConfig(**dataclasses.asdict(cfg.traffic))).save_trace(path)
    replay = _quiet(lambda: run_soak(cfg, traffic_model=TrafficModel.load_trace(path), **CPU))
    want = reports["production_soak"]["jax"]
    assert replay.config["replayed"] is True
    assert replay.counters == want.counters and replay.faults == want.faults and replay.history == want.history
    assert replay.config["state_digest"] == want.config["state_digest"]


def test_soak_rejects_out_of_range_and_fleet_only_schedules():
    with pytest.raises(TorchMetricsUserError, match="step 500"):
        run_soak(SoakConfig(traffic=TrafficConfig(seed=1, tenants=4, steps=20),
                            faults=FaultSchedule([FaultSpec(step=500, kind="dispatch_transient")])), **CPU)
    for kw, match in (({"sync_every": 0}, "sync_every"), ({"snapshot_every": 5}, "durability_dir"),
                      ({"seconds_per_step": 0.0}, "seconds_per_step"), ({"shed_rate_max": 0.0}, "shed_rate_max"),
                      ({"retry_attempts": 0}, "retry_attempts"),
                      ({"fleet_suspect_after": 2.0, "fleet_dead_after": 1.0}, "fleet_dead_after")):
        with pytest.raises(ValueError, match=match):
            SoakConfig(**kw)


def test_soak_opens_a_profiler_range_per_sync_epoch_and_per_dispatch():
    """Under ``torch.profiler`` a soak shows one ``SYNC_EPOCH_RANGE`` a sync epoch and one
    ``DISPATCH_RANGE`` a megabatch dispatch (no fault armed, so no quarantine re-drive
    splits a dispatch); the ranges change no block of the report."""
    from torch.profiler import ProfilerActivity, profile

    from torchmetrics_tpu_torch.serving.engine import DISPATCH_RANGE

    config = SoakConfig(traffic=TrafficConfig(seed=5, tenants=12, steps=45), faults=FaultSchedule([]), capacity=6,
                        megabatch_size=3, max_tenants_per_sec=40.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _quiet(lambda: run_soak(config, **CPU))
    names = [e.name for e in prof.events()]
    assert names.count(psoak.SYNC_EPOCH_RANGE) == traced.counters["epochs"] == 3
    assert names.count(DISPATCH_RANGE) == traced.counters["engine_dispatches"] > 0
    plain = _quiet(lambda: run_soak(config, **CPU))
    assert traced.counters == plain.counters and traced.history == plain.history
    assert traced.config["state_digest"] == plain.config["state_digest"]


# ------------------------------------------------------------------- digests


def _engine(lib, metric, codec="int8"):
    e = lib.ServingEngine(metric, lib.ServingConfig(capacity=4, megabatch_size=3, spill_codec=codec,
                                                    on_error="quarantine"))

    def hook(tids):
        if 5 in tids:
            raise RuntimeError("injected poison for tenant 5")

    e._fault_hook = hook
    model = TrafficModel(TrafficConfig(seed=4, tenants=9, steps=30, num_classes=4))
    for ev in model.events():
        if not e.tenants().get(ev.tenant_id, {}).get("quarantined"):
            e.update(ev.tenant_id, *ev.batch)
    return e


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_engine_digest_is_the_jax_hex_digest(codec):
    """Resident, spilled and quarantined tenants, with queued traffic at the read: the
    port's ``_engine_digest`` equals the JAX package's on the same states."""
    port = _engine(pserving, PAccuracy(4, average="micro", validate_args=False, **CPU), codec)
    jax_engine = _engine(jserving, JAccuracy(4, average="micro", validate_args=False), codec)
    roster = port.tenants()
    assert any(i["quarantined"] for i in roster.values()) and any(i["spilled"] for i in roster.values())
    assert any(i["pending"] for i in roster.values())
    assert psoak._engine_digest(port) == jsoak._engine_digest(jax_engine)
    assert port.stats == jax_engine.stats | {"spill_ns": port.stats["spill_ns"]}


# ------------------------------------------------------- the soak drills


def test_durable_failover_soak_parity(tmp_path):
    """A seeded soak with rank_loss and coordination_outage scheduled and a mid-run
    kill and failover: no unrecovered fault, exact reconciliation, both parity gates
    at 1.0, RPO zero at ``fsync_every=1``; the counters are the JAX package's."""
    def config(lib, root):
        return lib.SoakConfig(
            traffic=lib.TrafficConfig(seed=7, tenants=12, steps=40, base_rate=3.0, churn_every=14, churn_count=3),
            capacity=6, megabatch_size=3, sync_every=10, max_tenants_per_sec=30.0, spill_codec="int8",
            sync_codec="bf16", durability_dir=str(root), snapshot_every=12, failover_at=26)

    r = _quiet(lambda: run_soak(config(pchaos, tmp_path / "port"), **CPU))
    want = _quiet(lambda: jchaos.run_soak(config(jchaos, tmp_path / "jax")))
    assert r.counters == want.counters and r.faults == want.faults
    c = r.counters
    assert c["unrecovered_faults"] == 0 and r.reconciliation["exact"]
    assert c["failovers"] == 1 and c["failover_state_parity"] == 1.0 and c["degraded_sync_parity"] == 1.0
    assert c["failover_rpo_records"] == 0
    assert c["snapshots"] >= 2 and c["snapshot_restores"] == 1 and c["replayed_records"] > 0
    assert c["journal_records"] == c["journal_fsyncs"] > 0
    assert c["degraded_syncs"] >= 1 and c["rank_rejoins"] >= 1
    assert r.timing["failover_rto_ms"] > 0.0
    outcomes = {rec["kind"]: rec["outcome"] for rec in r.faults}
    assert outcomes["rank_loss"] == "recovered" and outcomes["coordination_outage"] == "recovered"


def test_quarantine_transition_survives_failover_replay(tmp_path):
    """A quarantine after the last snapshot comes back on the standby: the journal
    carries the transition (error text and the rolled-back admissions) and replay
    re-applies the flag while skipping the folds the primary rolled back."""
    rng = np.random.default_rng(11)
    config = ServingConfig(capacity=4, megabatch_size=2, on_error="quarantine",
                           journal=str(tmp_path / "journal"))
    snap_dir = str(tmp_path / "snaps")
    tenants = [f"t{i}" for i in range(6)]
    metric = lambda: PAccuracy(3, average="micro", validate_args=False, **CPU)  # noqa: E731
    primary = ServingEngine(metric(), config)
    poison = {"armed": False}

    def hook(tids):
        if poison["armed"] and "t3" in tids:
            raise RuntimeError("injected poison for t3")

    primary._fault_hook = hook
    retained = {}
    for i in range(40):
        tid = tenants[i % len(tenants)]
        if tid == "t3" and primary.tenants().get("t3", {}).get("quarantined"):
            continue
        b = (rng.normal(size=(4, 3)).astype(np.float32), rng.integers(0, 3, 4).astype(np.int32))
        assert primary.update(tid, *b)
        retained[primary._applied_seq] = (b, {})
        if i == 14:
            primary.snapshot(snap_dir)
        if i == 16:
            poison["armed"] = True  # the quarantine lands inside the replay window
        if i == 22:
            poison["armed"] = False
    primary.flush()
    info_p = primary.tenants()
    assert info_p["t3"]["quarantined"]
    live = [t for t in tenants if not info_p[t]["quarantined"]]
    want = _tenant_host_states(primary, live)
    primary.close()
    records = TrafficJournal.read(str(tmp_path / "journal"))
    quar = [r for r in records if r.kind == "quarantine"]
    assert len(quar) == 1 and quar[0].tenant_id == "t3" and quar[0].rolled_back
    standby = ServingEngine(metric(), config)
    standby.restore(snap_dir)
    assert standby.replay_journal(records, lambda r: retained[r.seq]) > 0
    standby.flush()
    info_s = standby.tenants()
    assert info_s["t3"]["quarantined"] and info_s["t3"]["update_count"] == info_p["t3"]["update_count"]
    assert standby._tenants["t3"].error == primary._tenants["t3"].error and standby.stats["quarantined"] == 1
    for t in live:
        assert info_s[t]["update_count"] == info_p[t]["update_count"]
        got = standby.state_dict(t)
        for name, v in want[t].items():
            if not name.startswith("_"):
                np.testing.assert_array_equal(got[name].numpy(), v, err_msg=f"{t}/{name}")
    assert standby.replay_journal(records, lambda r: retained[r.seq]) == 0  # idempotent
    standby.close()


def test_soak_parity_with_quarantine_in_replay_window(tmp_path):
    """The tenant_fault quarantine (step 12) lands between the last snapshot (step 10)
    and the kill (step 16): the standby reaches parity only by honouring the journaled
    transition, and reports the quarantine it inherited."""
    def config(lib, root):
        return lib.SoakConfig(traffic=lib.TrafficConfig(seed=3, tenants=8, steps=30), capacity=6, megabatch_size=3,
                              spill_codec="int8", max_tenants_per_sec=40.0, durability_dir=str(root),
                              snapshot_every=10, failover_at=16)

    r = _quiet(lambda: run_soak(config(pchaos, tmp_path / "port"), **CPU))
    want = _quiet(lambda: jchaos.run_soak(config(jchaos, tmp_path / "jax")))
    assert r.counters == want.counters and r.config["state_digest"] == want.config["state_digest"]
    c = r.counters
    assert c["unrecovered_faults"] == 0 and r.reconciliation["exact"]
    assert c["failovers"] == 1 and c["failover_state_parity"] == 1.0 and c["degraded_sync_parity"] == 1.0
    assert c["failover_rpo_records"] == 0 and c["quarantined_faults"] == 1
    assert {rec["kind"]: rec["outcome"] for rec in r.faults}["tenant_fault"] == "quarantined"
