"""The port's fleet plane (``torchmetrics_tpu_torch/fleet``) held against the JAX
package's (``torchmetrics_tpu/fleet``) on the CPU, from the same ids, clocks and numpy
batches. Mirrors ``tests/test_fleet.py``.

- **placement**: ``place_all`` over 10,000 tenant ids and weighted hosts is the JAX
  map; ``rebalance_plan`` gives the JAX moves on a join and on a leave;
- **membership**: the lease state machine steps identically on one virtual clock;
- **the controller**: the same traffic seats, migrates and fails over every tenant as
  the JAX controller does, and every ``tenant_state_digest`` is the JAX hex digest;
  the migration kill-point fuzz, the torn artifact, the post-commit kill, failover at
  RPO 0 with no double count on a rejoin, and pruned stores, as the JAX tests pin them;
- **the fleet soak**: ``bench.py``'s ``fleet_failover`` config gives the JAX
  counters, history, fault ledger and state digest, key for key (no key differs), and
  repeats itself;
- **the read side**: ``/fleetz`` and the flight recorder's ``seating`` block equal the
  JAX package's for the same seeded fleet.

Tolerances: none. Digests are sha256 over the exact bytes.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import warnings

import numpy as np
import pytest

from torchmetrics_tpu import chaos as jchaos
from torchmetrics_tpu import fleet as jfleet
from torchmetrics_tpu import observability as jobs
from torchmetrics_tpu import serving as jserving
from torchmetrics_tpu.classification import MulticlassAccuracy as JAccuracy
from torchmetrics_tpu_torch import chaos as pchaos
from torchmetrics_tpu_torch import fleet as pfleet
from torchmetrics_tpu_torch import observability as pobs
from torchmetrics_tpu_torch import serving as pserving
from torchmetrics_tpu_torch.classification import MulticlassAccuracy as PAccuracy
from torchmetrics_tpu_torch.fleet import (
    MIGRATION_STAGES,
    LeaseConfig,
    Membership,
    MigrationAborted,
    Move,
    place,
    place_all,
    placement_score,
    rebalance_plan,
    tenant_state_digest,
)
from torchmetrics_tpu_torch.serving import ServingEngine, SnapshotStore, TrafficJournal
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

pytestmark = pytest.mark.fleet

NUM_CLASSES = 3
BATCH = 4
PKG = {
    "jax": {"fleet": jfleet, "chaos": jchaos, "serving": jserving, "obs": jobs,
            "metric": lambda: JAccuracy(NUM_CLASSES, average="micro", validate_args=False)},
    "port": {"fleet": pfleet, "chaos": pchaos, "serving": pserving, "obs": pobs,
             "metric": lambda: PAccuracy(NUM_CLASSES, average="micro", validate_args=False, device="cpu")},
}


def _metric():
    return PKG["port"]["metric"]()


def _batch(i: int):
    rng = np.random.default_rng(1000 + i)
    preds = rng.normal(size=(BATCH, NUM_CLASSES)).astype(np.float32)
    target = rng.integers(0, NUM_CLASSES, BATCH, dtype=np.int32)
    return preds, target


def _serving(which="port", **kw):
    base = dict(capacity=16, megabatch_size=4, journal_fsync_every=1)
    base.update(kw)
    return PKG[which]["serving"].ServingConfig(**base)


def _fleet(root, hosts=3, clock=None, lease=None, which="port", **serving_kw):
    F = PKG[which]["fleet"]
    return F.FleetController(
        PKG[which]["metric"],
        root=str(root),
        hosts=hosts,
        serving=_serving(which, **serving_kw),
        lease=lease if lease is None else F.LeaseConfig(**dataclasses.asdict(lease)),
        clock=clock,
    )


def _expire(fc, clock, until=7.0, step=1.0):
    """Advance the virtual clock in heartbeat-sized ticks (live hosts renew, killed
    hosts stay silent) until the victim's lease expires; returns every host poll()
    failed over along the way."""
    failed = []
    while clock["t"] < until:
        clock["t"] += step
        fc.heartbeat_all()
        failed += fc.poll()
    return failed


def _roster_count(controller, tid) -> int:
    """On how many live engines does ``tid`` hold state? (exactly-one gate)"""
    return sum(1 for h in controller._hosts.values() if not h.killed and tid in h.engine.tenants())


# ------------------------------------------------------------------ placement


def test_place_all_over_10000_tenants_is_the_jax_map():
    """Ints and strings (``repr`` keeps them apart), weighted hosts: every seat and
    every score equal the JAX package's."""
    hosts = {"host-0": 1.0, "host-1": 2.0, "host-2": 0.5, "edge-a": 3.0}
    tenants = list(range(7000)) + [f"user-{i}" for i in range(3000)]
    got = place_all(tenants, hosts)
    assert got == jfleet.place_all(tenants, hosts)
    assert set(got.values()) == set(hosts)
    for tid in (0, 1, "1", "user-7"):
        for host, w in hosts.items():
            assert placement_score(host, tid, w) == jfleet.placement_score(host, tid, w)


def test_placement_deterministic_weighted_and_total():
    hosts = {"a": 1.0, "b": 1.0, "c": 1.0}
    for tid in range(50):
        first = place(tid, hosts)
        assert first in hosts and all(place(tid, hosts) == first for _ in range(3))
    assignment = place_all(range(50), hosts)
    assert set(assignment.values()) == set(hosts)
    assert placement_score("a", 7) > 0
    counts = {"light": 0, "heavy": 0}
    for tid in range(400):
        counts[place(tid, {"light": 1.0, "heavy": 3.0})] += 1
    assert counts["heavy"] > counts["light"]
    with pytest.raises(TorchMetricsUserError):
        place(0, {})
    with pytest.raises(TorchMetricsUserError, match="weight"):
        placement_score("a", 0, 0.0)


@pytest.mark.parametrize("change", ["join", "leave", "reweight"])
def test_rebalance_plan_moves_equal_the_jax_plan(change):
    hosts = {"a": 1.0, "b": 1.0, "c": 1.0}
    assignment = place_all(range(600), hosts)
    new = {"join": dict(hosts, d=1.0), "leave": {"a": 1.0, "b": 1.0}, "reweight": dict(hosts, a=2.0)}[change]
    plan = rebalance_plan(assignment, new)
    want = jfleet.rebalance_plan(assignment, new)
    assert [dataclasses.astuple(m) for m in plan] == [dataclasses.astuple(m) for m in want]
    assert plan and all(isinstance(m, Move) for m in plan)
    if change == "join":  # a join moves only onto the joiner, nothing else relocates
        assert {m.dst for m in plan} == {"d"}
        assert all(m.src == assignment[m.tenant_id] for m in plan)
        moved = {m.tenant_id for m in plan}
        assert all(place(t, new) == h for t, h in assignment.items() if t not in moved)
    if change == "leave":  # exactly the leaver's roster, as adoptions (src None)
        assert {m.tenant_id for m in plan} == {t for t, h in assignment.items() if h == "c"}
        assert all(m.src is None and m.dst in new for m in plan)


# ----------------------------------------------------------------- membership


def _lease_script(M):
    """One scripted walk of a lease table on a virtual clock: every verdict in order."""
    clock = {"t": 0.0}
    m = M.Membership(lambda: clock["t"], M.LeaseConfig(heartbeat_interval=1.0, suspect_after=3.0, dead_after=6.0))
    out = []
    m.join("h0")
    m.join("h1", weight=2.0)
    for t, beats in ((1.0, ["h0", "h1"]), (2.5, ["h1"]), (4.0, []), (5.0, ["h0"]), (8.0, ["h0"]), (9.0, []),
                     (12.5, ["h1"]), (16.0, [])):
        clock["t"] = t
        for h in beats:
            m.heartbeat(h)
        out.append((t, {h: m.state(h) for h in ("h0", "h1")}, m.expire(), m.hosts(), m.hosts(("alive",))))
    member = m.join("h1")
    out.append(("rejoin", member.epoch, m.state("h1"), sorted((h, x.epoch, x.heartbeats, x.expired)
                                                              for h, x in m.members().items())))
    m.leave("h0")
    out.append(("leave", sorted(m.members())))
    return out


def test_lease_state_machine_steps_as_the_jax_one():
    got = _lease_script(pfleet)
    assert got == _lease_script(jfleet)
    assert got[2][1] == {"h0": "suspect", "h1": "alive"} and got[-2][1] == 2


def test_lease_state_machine_and_flap():
    clock = {"t": 0.0}
    m = Membership(lambda: clock["t"], LeaseConfig(heartbeat_interval=1.0, suspect_after=3.0, dead_after=6.0))
    m.join("h0")
    assert m.state("h0") == "alive"
    clock["t"] = 4.0
    assert m.state("h0") == "suspect"
    m.heartbeat("h0")  # the flap: a suspect that heartbeats revives with no expiry
    assert m.state("h0") == "alive" and m.expire() == []
    clock["t"] = 11.0
    assert m.state("h0") == "dead"
    assert m.expire() == ["h0"] and m.expire() == []
    assert "h0" not in m.hosts()
    m.heartbeat("h0")  # heartbeats cannot resurrect
    assert m.state("h0") == "dead"
    assert m.join("h0").epoch == 2 and m.state("h0") == "alive"


def test_lease_config_validation():
    with pytest.raises(ValueError):
        LeaseConfig(suspect_after=5.0, dead_after=4.0)
    with pytest.raises(ValueError):
        LeaseConfig(heartbeat_interval=0.0)
    with pytest.raises(TorchMetricsUserError):
        Membership(clock=None)  # type: ignore[arg-type]


# ------------------------------------------------------- the controller, JAX against port


def _drive_fleet(which, root):
    """A seeded fleet life: traffic, a snapshot, a migration, more traffic, a kill with
    parked traffic, the lease run out, a rejoin with its rebalance. Returns the routing
    table and the digests after each act, and the stats."""
    clock = {"t": 0.0}
    F = PKG[which]["fleet"]
    fc = _fleet(root, hosts=3, clock=lambda: clock["t"], lease=LeaseConfig(suspect_after=2.0, dead_after=5.0),
                which=which)
    acts = []
    for i in range(30):
        fc.serve(i % 11, *_batch(i))
    fc.flush()
    fc.snapshot_all()
    acts.append((fc.tenants(), fc.tenant_digests()))
    movers = sorted(t for t, h in fc.tenants().items() if h == "host-0")[:3]
    out = fc.migrate(movers, "host-2")
    acts.append((out, fc.tenants(), fc.tenant_digests()))
    for i in range(30, 45):
        fc.serve(i % 11, *_batch(i))
    fc.kill_host("host-1")
    for i in range(45, 50):
        fc.serve(i % 11, *_batch(i))
    for i, tid in enumerate(sorted(t for t, h in fc.tenants().items() if h == "host-1")[:2]):
        fc.serve(tid, *_batch(50 + i))  # parks: its owner is down, the lease not out
    failed = _expire(fc, clock)
    acts.append((failed, fc.tenants(), fc.tenant_digests()))
    fc.add_host("host-1")
    acts.append((fc.tenants(), fc.tenant_digests(), fc.hosts()))
    engine = fc.engines()["host-0"]
    acts.append({tid: F.tenant_state_digest(engine, tid) for tid in engine.tenants()})
    stats = dict(fc.stats)
    fc.close()
    return acts, stats


def test_fleet_controller_seats_migrates_and_fails_over_as_the_jax_one(tmp_path):
    """Every act's routing table and every tenant's digest (hex) equal the JAX
    controller's; the stats too."""
    got, got_stats = _drive_fleet("port", tmp_path / "port")
    want, want_stats = _drive_fleet("jax", tmp_path / "jax")
    assert got == want
    assert got_stats == want_stats
    assert got_stats["failovers"] == 1 and got_stats["migrated_tenants"] >= 3 and got_stats["parked"] >= 1
    assert got_stats["rpo_records"] == 0 and got_stats["migration_parity_failures"] == 0


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_tenant_state_digest_is_the_jax_hex_digest(codec):
    """Resident, spilled (raw and int8-encoded) and restored tenants, quarantined
    peers aside: ``tenant_state_digest`` equals the JAX package's for the same states,
    one tenant at a time and through the controller's one-read-per-leaf path."""
    from torchmetrics_tpu_torch.fleet.controller import _state_digest, _tenant_host_states

    engines = {}
    for which in ("jax", "port"):
        S = PKG[which]["serving"]
        e = S.ServingEngine(PKG[which]["metric"](), S.ServingConfig(capacity=3, megabatch_size=2, spill_codec=codec))
        for i in range(40):
            e.update(i % 7, *_batch(i))
        e.update("late", *_batch(99))  # pending at the read: the digest flushes first
        engines[which] = e
    port, jax_engine = engines["port"], engines["jax"]
    assert any(info["spilled"] for info in port.tenants().values())
    assert any(info["pending"] for info in port.tenants().values())
    flushes = port.stats["flushes"]
    bulk = _tenant_host_states(port, list(port.tenants()))
    assert port.stats["flushes"] == flushes + 1
    for tid in port.tenants():
        want = jfleet.tenant_state_digest(jax_engine, tid)
        assert tenant_state_digest(port, tid) == want
        assert _state_digest(bulk[tid]) == want
    port.load_state_dict("moved", {k: v for k, v in port.state_dict(3).items()})
    jax_engine.load_state_dict("moved", jax_engine.state_dict(3))
    assert tenant_state_digest(port, "moved") == jfleet.tenant_state_digest(jax_engine, "moved")


def test_suspect_keeps_tenants_no_spurious_failover(tmp_path):
    """A host that merely misses heartbeats keeps serving its tenants, and poll() does
    not fail it over before the lease expires."""
    clock = {"t": 0.0}
    fc = _fleet(tmp_path, hosts=2, clock=lambda: clock["t"], lease=LeaseConfig(suspect_after=2.0, dead_after=5.0))
    for i in range(8):
        fc.serve(i, *_batch(i))
    fc.flush()
    before = fc.tenant_digests()
    clock["t"] = 3.0
    fc.membership.heartbeat("host-0")
    assert fc.hosts()["host-1"] == "suspect"
    assert fc.poll() == []
    suspect_tenants = [t for t, h in fc.tenants().items() if h == "host-1"]
    assert suspect_tenants
    assert fc.serve(suspect_tenants[0], *_batch(99))
    fc.membership.heartbeat("host-1")
    assert fc.hosts()["host-1"] == "alive" and fc.stats["failovers"] == 0
    after = fc.tenant_digests()
    assert all(after[t] == before[t] for t in before if t != suspect_tenants[0])
    fc.close()


# ------------------------------------------------------- migration kill fuzz


class _Boom(RuntimeError):
    pass


def test_migration_stages_are_the_contract():
    assert MIGRATION_STAGES == ("drain", "snapshot", "transfer", "restore", "cutover") == jfleet.MIGRATION_STAGES


@pytest.mark.parametrize("stage", [s for s in MIGRATION_STAGES if s != "cutover"])
def test_migration_kill_point_fuzz(tmp_path, stage):
    """A kill at every pre-commit stage boundary aborts cleanly: ownership never flips,
    the destination holds nothing, digests are untouched, no transfer artifact survives;
    then the same migration commits, bit for bit."""
    fc = _fleet(tmp_path, hosts=2)
    for i in range(10):
        fc.serve(i, *_batch(i))
    fc.flush()
    victims = [t for t, h in fc.tenants().items() if h == "host-0"][:3]
    assert victims
    before_digests = fc.tenant_digests()
    before_owner = dict(fc.tenants())

    def hook(s):
        if s == stage:
            raise _Boom(f"killed at {s}")

    with pytest.raises(MigrationAborted) as err:
        fc.migrate(victims, "host-1", _stage_hook=hook)
    assert isinstance(err.value.__cause__, _Boom)
    assert fc.tenants() == before_owner
    assert fc.tenant_digests() == before_digests
    assert all(_roster_count(fc, tid) == 1 for tid in victims)
    for h in fc._hosts.values():
        for box in (h.outbox_dir, h.inbox_dir):
            assert not (os.path.isdir(box) and SnapshotStore(box).generations()), (stage, box)
    assert fc.stats["aborted_migrations"] == 1 and fc.stats["migrated_tenants"] == 0
    out = fc.migrate(victims, "host-1")
    assert out["moved"] == len(victims) and out["parity_failures"] == 0
    after = fc.tenant_digests()
    for tid in victims:
        assert fc.tenants()[tid] == "host-1" and after[tid] == before_digests[tid]
        assert _roster_count(fc, tid) == 1
    fc.close()


def test_migration_torn_transfer_artifact_aborts(tmp_path):
    """A transfer torn mid-copy is caught by the artifact's sha256 at restore on the
    destination: the migration aborts with the source authoritative."""
    fc = _fleet(tmp_path, hosts=2)
    for i in range(8):
        fc.serve(i, *_batch(i))
    fc.flush()
    victims = [t for t, h in fc.tenants().items() if h == "host-0"][:2]
    before = fc.tenant_digests()
    inbox = fc._hosts["host-1"].inbox_dir

    def tear(stage):
        if stage == "transfer":
            path = SnapshotStore(inbox).path_for(SnapshotStore(inbox).generations()[-1])
            with open(path, "r+b") as fh:
                fh.truncate(os.path.getsize(path) // 2)

    with pytest.raises(MigrationAborted):
        fc.migrate(victims, "host-1", _stage_hook=tear)
    assert fc.tenant_digests() == before
    for tid in victims:
        assert fc.tenants()[tid] == "host-0" and _roster_count(fc, tid) == 1
    assert not SnapshotStore(inbox).generations()
    fc.close()


def test_migration_kill_after_cutover_is_post_commit(tmp_path):
    fc = _fleet(tmp_path, hosts=2)
    for i in range(8):
        fc.serve(i, *_batch(i))
    fc.flush()
    victims = [t for t, h in fc.tenants().items() if h == "host-0"][:2]
    before = fc.tenant_digests()

    def hook(stage):
        if stage == "cutover":
            raise _Boom("killed after commit")

    with pytest.raises(_Boom):
        fc.migrate(victims, "host-1", _stage_hook=hook)
    after = fc.tenant_digests()
    for tid in victims:
        assert fc.tenants()[tid] == "host-1" and after[tid] == before[tid] and _roster_count(fc, tid) == 1
    fc.close()


def test_a_zero_dim_leaf_migrates_bit_for_bit_where_jax_reshapes_it(tmp_path):
    """A 0-d state leaf (``SumMetric``'s; FID's sample counts) crosses the snapshot
    container 0-d in the port, so the migrated tenant lands bit for bit. The JAX
    package's container writes it as shape ``(1,)`` (``np.ascontiguousarray``), and its
    controller counts the move a parity failure: a JAX-side fault kept out of the port."""
    from torchmetrics_tpu.aggregation import SumMetric as JSum

    from torchmetrics_tpu_torch.aggregation import SumMetric as PSum

    outs = {}
    for which, make in (("jax", lambda: JSum()), ("port", lambda: PSum(device="cpu"))):
        F = PKG[which]["fleet"]
        fc = F.FleetController(make, root=str(tmp_path / which), hosts=2, serving=_serving(which))
        for i in range(6):
            fc.serve(i, np.float32(i + 0.5))
        fc.flush()
        movers = [t for t, h in fc.tenants().items() if h == "host-0"][:2]
        before = fc.tenant_digests()
        outs[which] = (fc.migrate(movers, "host-1"), before, fc.tenant_digests(), movers)
        if which == "port":
            assert fc.engines()["host-1"].state_dict(movers[0])["sum_value"].shape == ()
        fc.close()
    out, before, after, movers = outs["port"]
    assert out["parity_failures"] == 0 and all(after[t] == before[t] for t in movers)
    assert before == outs["jax"][1]  # the same states digest alike before the move
    assert outs["jax"][0]["parity_failures"] == len(movers)


def test_migration_guard_rails(tmp_path):
    fc = _fleet(tmp_path, hosts=2)
    fc.serve(0, *_batch(0))
    with pytest.raises(TorchMetricsUserError):
        fc.migrate([999], "host-1")  # unknown tenant
    with pytest.raises(TorchMetricsUserError, match="already"):
        fc.add_host("host-0")
    fc.kill_host("host-1")
    with pytest.raises(TorchMetricsUserError):
        fc.migrate([0], "host-1")  # dead destination
    fc.close()


# ------------------------------------------------------------------ failover


def test_failover_bitwise_parity_and_rpo_zero(tmp_path):
    """Lease expiry: survivors adopt from snapshot + journal tail, bit for bit, RPO 0 at
    fsync-per-record; parked suspicion-window traffic replays to the adopter."""
    clock = {"t": 0.0}
    fc = _fleet(tmp_path, hosts=3, clock=lambda: clock["t"], lease=LeaseConfig(suspect_after=2.0, dead_after=5.0))
    for i in range(18):
        fc.serve(i % 9, *_batch(i))
    fc.flush()
    fc.snapshot_all()
    for i in range(18, 27):
        fc.serve(i % 9, *_batch(i))
    fc.flush()
    pre = fc.tenant_digests()
    victim_tenants = {t for t, h in fc.tenants().items() if h == "host-1"}
    assert victim_tenants
    fc.kill_host("host-1")
    parked_tid = sorted(victim_tenants)[0]
    assert fc.serve(parked_tid, *_batch(777))
    assert fc.stats["parked"] == 1
    assert _expire(fc, clock) == ["host-1"]
    assert fc.stats["failovers"] == 1 and fc.stats["rpo_records"] == 0 and fc.stats["replayed_parked"] == 1
    assert "host-1" not in fc.hosts()
    post = fc.tenant_digests()
    for tid in pre:
        if tid != parked_tid:
            assert post[tid] == pre[tid] and _roster_count(fc, tid) == 1
    ref = ServingEngine(_metric(), dataclasses.replace(_serving(), journal=None))
    for i in range(27):
        if i % 9 == parked_tid:
            ref.update(parked_tid, *_batch(i))
    ref.update(parked_tid, *_batch(777))
    ref.flush()
    assert post[parked_tid] == tenant_state_digest(ref, parked_tid)
    fc.close()


def test_failover_rejoin_no_double_count(tmp_path):
    clock = {"t": 0.0}
    fc = _fleet(tmp_path, hosts=2, clock=lambda: clock["t"], lease=LeaseConfig(suspect_after=2.0, dead_after=5.0))
    log = []
    for i in range(12):
        fc.serve(i % 6, *_batch(i))
        log.append((i % 6, i))
    fc.flush()
    fc.snapshot_all()
    fc.kill_host("host-1")
    assert _expire(fc, clock) == ["host-1"]
    fc.add_host("host-1")  # rejoin: a new incarnation of the same id
    assert fc.membership.members()["host-1"].epoch == 2
    for i in range(12, 24):
        fc.serve(i % 6, *_batch(i))
        log.append((i % 6, i))
    fleet_digests = fc.tenant_digests()
    ref = ServingEngine(_metric(), dataclasses.replace(_serving(), journal=None))
    for tid, i in log:
        ref.update(tid, *_batch(i))
    ref.flush()
    for tid in {t for t, _ in log}:
        assert fleet_digests[tid] == tenant_state_digest(ref, tid)
    fc.close()


def test_failover_replaces_stateless_suspicion_window_tenant(tmp_path):
    clock = {"t": 0.0}
    fc = _fleet(tmp_path, hosts=2, clock=lambda: clock["t"], lease=LeaseConfig(suspect_after=2.0, dead_after=5.0))
    fc.kill_host("host-1")
    fresh = next(t for t in range(1000) if fc.owner(t) == "host-1")
    assert fc.serve(fresh, *_batch(0))
    assert _expire(fc, clock) == ["host-1"]
    assert fc.tenants()[fresh] == "host-0"
    fc.flush()
    ref = ServingEngine(_metric(), dataclasses.replace(_serving(), journal=None))
    ref.update(fresh, *_batch(0))
    ref.flush()
    assert fc.tenant_digests()[fresh] == tenant_state_digest(ref, fresh)
    fc.close()


def test_failover_with_no_survivor_raises(tmp_path):
    clock = {"t": 0.0}
    fc = _fleet(tmp_path, hosts=2, clock=lambda: clock["t"], lease=LeaseConfig(suspect_after=2.0, dead_after=5.0))
    fc.serve(0, *_batch(0))
    fc.kill_host("host-0")
    fc.kill_host("host-1")
    with pytest.raises(TorchMetricsUserError, match="no live host"):
        _expire(fc, clock)
    fc.close()


# ----------------------------------------------- bounded retention


def test_snapshot_prune_keeps_newest(tmp_path):
    engine = ServingEngine(_metric(), _serving())
    store_dir = str(tmp_path / "snaps")
    for i in range(4):
        engine.update(0, *_batch(i))
        engine.flush()
        engine.snapshot(store_dir)
    store = SnapshotStore(store_dir)
    gens = store.generations()
    assert len(gens) == 4
    assert store.prune(keep_last=2) == gens[:2]
    assert store.generations() == gens[2:]
    store.prune(keep_last=1)
    assert store.generations() == [gens[-1]]
    store.read(gens[-1])
    with pytest.raises(TorchMetricsUserError):
        store.prune(keep_last=0)
    engine.close()


def test_pruned_store_still_restores_and_replays_to_parity(tmp_path):
    """``retain_snapshots=1`` prunes old generations and the journal segments they
    cover, and the newest snapshot plus the remaining journal still reconstruct the
    pre-crash state bit for bit."""
    cfg = _serving(journal=str(tmp_path / "journal"), journal_segment_records=4, retain_snapshots=1)
    engine = ServingEngine(_metric(), cfg)
    retained = {}
    snap_dir = str(tmp_path / "snaps")
    info = {}
    for i in range(24):
        engine.update(i % 5, *_batch(i))
        engine.flush()
        retained[engine._applied_seq] = (_batch(i), {})
        if i % 6 == 5:
            info = engine.snapshot(snap_dir)
    assert len(SnapshotStore(snap_dir).generations()) == 1
    assert info.get("pruned_generations", 0) >= 1
    segments = [f for f in os.listdir(tmp_path / "journal") if f.endswith(".tmj")]
    assert len(segments) < 24 // 4 + 1, "covered journal segments were not pruned"
    for i in range(24, 30):
        engine.update(i % 5, *_batch(i))
        engine.flush()
        retained[engine._applied_seq] = (_batch(i), {})
    pre = {tid: tenant_state_digest(engine, tid) for tid in engine.tenants()}
    engine._journal.crash()
    standby = ServingEngine(_metric(), dataclasses.replace(cfg, journal=None))
    standby.restore(snap_dir)
    standby.replay_journal(TrafficJournal.read(str(tmp_path / "journal")), lambda r: retained[r.seq])
    standby.flush()
    assert {tid: tenant_state_digest(standby, tid) for tid in pre} == pre
    standby.close()


# ---------------------------------------------------------------- fleet soak


def _published(which, root):
    """``bench.py``'s ``fleet_failover`` config, as published."""
    C = PKG[which]["chaos"]
    return C.SoakConfig(
        traffic=C.TrafficConfig(seed=37, tenants=24, steps=120),
        faults=C.FaultSchedule([C.FaultSpec(step=40, kind="host_loss", target="host-1"),
                                C.FaultSpec(step=80, kind="host_join")]),
        capacity=12, megabatch_size=4, spill_codec="none", durability_dir=str(root), snapshot_every=20,
        journal_fsync_every=1, fleet_hosts=3,
    )


@pytest.fixture(scope="module")
def fleet_reports(tmp_path_factory):
    """The published fleet soak once in the JAX package and twice in the port."""
    root = tmp_path_factory.mktemp("fleet_soak")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jchaos.run_soak(_published("jax", root / "jax"))
        first = pchaos.run_soak(_published("port", root / "a"), device="cpu")
        second = pchaos.run_fleet_soak(_published("port", root / "b"), device="cpu")
    return want, first, second


@pytest.mark.parametrize("block", ["counters", "history", "faults", "reconciliation"])
def test_fleet_soak_blocks_equal_the_jax_package(fleet_reports, block):
    want, got, _ = fleet_reports
    assert getattr(got, block) == getattr(want, block)


def test_fleet_soak_state_digest_and_config_equal_the_jax_package(fleet_reports):
    want, got, _ = fleet_reports
    assert got.config == want.config


def test_fleet_soak_parity_determinism_and_ledger(fleet_reports):
    _, first, second = fleet_reports
    c = first.counters
    assert c["fleet_failover_parity"] == 1.0 and c["migration_parity"] == 1.0
    assert c["double_counted_batches"] == 0 and c["failover_rpo_records"] == 0 and c["unrecovered_faults"] == 0
    assert c["host_failovers"] == 1 and c["lease_expiries"] == 1 and c["adopted_tenants"] > 0
    assert c["tenant_migrations"] > 0 and c["hosts_joined"] == 1
    assert {r["kind"]: r["outcome"] for r in first.faults} == {"host_loss": "recovered", "host_join": "recovered"}
    assert first.counters == second.counters and first.history == second.history
    assert first.config["state_digest"] == second.config["state_digest"]
    assert first.timing["migration_us"] > 0  # wall clock lives outside the counters
    assert first.timing["failover_rto_ms"] > 0  # the poll that failed host-1 over
    tower = first.fleet_telemetry
    assert set(tower["hosts"]) == {"host-0", "host-2", "host-3"} and tower["totals"]["serve_dispatches"] > 0


def test_fleet_soak_guard_rails(tmp_path):
    with pytest.raises(TorchMetricsUserError, match="fleet"):
        pchaos.run_soak(pchaos.SoakConfig(
            traffic=pchaos.TrafficConfig(steps=12, tenants=4, seed=1),
            faults=pchaos.FaultSchedule([pchaos.FaultSpec(step=2, kind="host_loss", target="host-0")])),
            device="cpu")
    with pytest.raises(TorchMetricsUserError, match="host_loss/host_join"):
        pchaos.run_soak(dataclasses.replace(
            _published("port", tmp_path), faults=pchaos.FaultSchedule([pchaos.FaultSpec(step=2, kind="gather_flaky")])),
            device="cpu")
    with pytest.raises(TorchMetricsUserError, match="fleet_hosts"):
        pchaos.run_fleet_soak(pchaos.SoakConfig(), device="cpu")
    with pytest.raises(ValueError, match="fleet_hosts"):
        pchaos.SoakConfig(fleet_hosts=1, durability_dir=str(tmp_path))
    with pytest.raises(ValueError, match="durability_dir"):
        pchaos.SoakConfig(fleet_hosts=3)


# ------------------------------------------------------------- the read side


def _seeded_fleet(which, root):
    fc = _fleet(root, hosts=3, which=which)
    for i in range(20):
        fc.serve(i % 9, *_batch(i))
    fc.flush()
    return fc


def _fleetz(which):
    O = PKG[which]["obs"]
    with O.HealthServer(host="127.0.0.1", port=0) as server:
        conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
        conn.request("GET", "/fleetz")
        resp = conn.getresponse()
        doc = (resp.status, json.loads(resp.read().decode("utf-8")))
        conn.close()
    return doc


def test_fleetz_and_flight_recorder_seating_equal_the_jax_packages(tmp_path):
    """A live controller in each package over the same seeded traffic: ``/fleetz``
    answers the same rollup and a flight-recorder dump carries the same ``seating``;
    with no controller live, ``/fleetz`` is ``{"fleet": false}`` and no seating."""
    docs, seatings = {}, {}
    for which in ("jax", "port"):
        fc = _seeded_fleet(which, tmp_path / which)
        assert PKG[which]["fleet"].active_controller() is fc
        docs[which] = _fleetz(which)
        seatings[which] = PKG[which]["obs"].FlightRecorder().dump("probe")["seating"]
        fc.close()
        assert PKG[which]["fleet"].active_controller() is None
    assert docs["port"] == docs["jax"]
    status, doc = docs["port"]
    assert status == 200 and doc["fleet"] is True and doc["tenant_count"] == 9
    assert set(doc["hosts"]) == {"host-0", "host-1", "host-2"}
    assert seatings["port"] == seatings["jax"] and sum(len(r) for r in seatings["port"].values()) == 9
    assert _fleetz("port") == (200, {"fleet": False})
    assert pobs.FlightRecorder().dump("probe")["seating"] is None


def test_fleetz_under_a_session_carries_latency_and_history(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pobs.telemetry_session(pobs.TelemetryConfig(history_clock=lambda: 0.0)):
            fc = _seeded_fleet("port", tmp_path)
            status, doc = _fleetz("port")
            fc.close()
    assert status == 200 and doc["totals"]["serve_tenant_rows"] == 20 and "vupdate" in doc["latency"]
    assert "history" in doc
