"""The port's durability plane (``torchmetrics_tpu_torch/serving/durability.py``, the
engine's snapshot/restore/replay, the degraded sync's ledger) held against the JAX
package's, on the CPU. Mirrors ``tests/test_durability.py`` up to its soak drills, which
drive the chaos plane (not ported yet).

Tolerances: none. Snapshot containers, journal segments and ``batch_digest`` equal the
JAX package's byte for byte for the same numpy inputs and records; restored states
equal the uninterrupted engine's bit for bit.
"""

from __future__ import annotations

import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.parallel import coalesce as JC
from torchmetrics_tpu.serving import SnapshotStore as JSnapshotStore
from torchmetrics_tpu.serving import TrafficJournal as JTrafficJournal
from torchmetrics_tpu.serving import batch_digest as jbatch_digest
from torchmetrics_tpu_torch.aggregation import SumMetric
from torchmetrics_tpu_torch.classification import MulticlassAccuracy
from torchmetrics_tpu_torch.observability import telemetry_session
from torchmetrics_tpu_torch.parallel import AsyncSyncHandle
from torchmetrics_tpu_torch.parallel import coalesce as C
from torchmetrics_tpu_torch.reliability import DeadRank
from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine, SnapshotStore, TrafficJournal, batch_digest
from torchmetrics_tpu_torch.serving.durability import _HEADER_LEN_FMT, SNAPSHOT_MAGIC
from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError, TorchMetricsUserError

pytestmark = pytest.mark.durability

NUM_CLASSES = 3
BATCH = 4
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean_liveness():
    """The tombstone ledger is process-global: isolate every test."""
    C.clear_dead_ranks()
    yield
    C.clear_dead_ranks()


def _acc():
    return MulticlassAccuracy(num_classes=NUM_CLASSES, average="micro", validate_args=False, **CPU)


def _batch(rng):
    return (rng.normal(size=(BATCH, NUM_CLASSES)).astype(np.float32),
            rng.integers(0, NUM_CLASSES, BATCH).astype(np.int32))


def _sections():
    return {
        "a/int": np.arange(12, dtype=np.int64).reshape(3, 4),
        "b/float": np.linspace(-1.0, 1.0, 7, dtype=np.float32),
        "c/empty": np.zeros((0, 2), dtype=np.float64),
    }


# ------------------------------------------------------------ snapshot store


def test_snapshot_round_trip_and_generations(tmp_path):
    """Generations, latest-by-default reads, dtypes kept; the container equals the
    JAX package's byte for byte, and each package reads the other's."""
    store = SnapshotStore(str(tmp_path / "port"))
    jstore = JSnapshotStore(str(tmp_path / "jax"))
    meta = {"applied_seq": 41, "note": "gen1"}
    out = store.write(meta, _sections())
    jout = jstore.write(meta, _sections())
    assert out["generation"] == 1 and out["bytes"] == os.path.getsize(out["path"])
    assert open(out["path"], "rb").read() == open(jout["path"], "rb").read()
    store.write({"note": "gen2"}, {"x": np.ones(3)})
    assert store.generations() == [1, 2]
    m2, s2 = store.read()
    assert m2 == {"note": "gen2"} and list(s2) == ["x"]
    m1, s1 = store.read(generation=1)
    assert m1 == meta
    for name, want in _sections().items():
        np.testing.assert_array_equal(s1[name], want)
        assert s1[name].dtype == want.dtype
    jm, js = JSnapshotStore(str(tmp_path / "port")).read(generation=1)
    assert jm == meta and sorted(js) == sorted(s1)
    assert store.prune(keep_last=1) == [1] and store.generations() == [2]
    with pytest.raises(TorchMetricsUserError):
        store.prune(keep_last=0)


def test_snapshot_every_kill_point_refuses_to_load(tmp_path):
    """Truncation at any byte offset raises ``StateCorruptionError``."""
    store = SnapshotStore(str(tmp_path / "src"))
    raw = open(store.write({"k": 1}, _sections())["path"], "rb").read()
    offsets = sorted(set(range(0, len(raw), 7)) | {0, 1, len(SNAPSHOT_MAGIC), len(raw) - 1})
    for i, cut in enumerate(offsets):
        victim = SnapshotStore(str(tmp_path / f"cut{i}"))
        with open(victim.path_for(1), "wb") as fh:
            fh.write(raw[:cut])
        with pytest.raises(StateCorruptionError):
            victim.read()


def test_snapshot_bitflip_and_stale_version_refuse_to_load(tmp_path):
    store = SnapshotStore(str(tmp_path / "src"))
    raw = open(store.write({"k": 1}, _sections())["path"], "rb").read()
    hoff = len(SNAPSHOT_MAGIC)
    (hlen,) = struct.unpack_from(_HEADER_LEN_FMT, raw, hoff)
    body_at = hoff + struct.calcsize(_HEADER_LEN_FMT) + hlen
    flips = {"magic": 0, "header": hoff + struct.calcsize(_HEADER_LEN_FMT) + hlen // 2,
             "payload": body_at + (len(raw) - body_at) // 2}
    for label, at in flips.items():
        victim = SnapshotStore(str(tmp_path / f"flip-{label}"))
        damaged = bytearray(raw)
        damaged[at] ^= 0xFF
        with open(victim.path_for(1), "wb") as fh:
            fh.write(bytes(damaged))
        with pytest.raises(StateCorruptionError):
            victim.read()
    header = json.loads(raw[hoff + struct.calcsize(_HEADER_LEN_FMT): body_at])
    header["version"] = 99
    hb = json.dumps(header, sort_keys=True).encode("utf-8")
    victim = SnapshotStore(str(tmp_path / "stale"))
    with open(victim.path_for(1), "wb") as fh:
        fh.write(SNAPSHOT_MAGIC + struct.pack(_HEADER_LEN_FMT, len(hb)) + hb + raw[body_at:])
    with pytest.raises(StateCorruptionError, match="version"):
        victim.read()


def test_previous_generation_survives_a_torn_latest(tmp_path):
    store = SnapshotStore(str(tmp_path))
    store.write({"note": "good"}, _sections())
    p2 = store.write({"note": "torn"}, _sections())["path"]
    raw = open(p2, "rb").read()
    with open(p2, "wb") as fh:
        fh.write(raw[: len(raw) // 2])
    with pytest.raises(StateCorruptionError):
        store.read()
    meta, _ = store.read(generation=1)
    assert meta == {"note": "good"}
    assert not any(".tmp-" in n for n in os.listdir(tmp_path))


def test_empty_store_is_a_user_error_not_corruption(tmp_path):
    with pytest.raises(TorchMetricsUserError, match="no snapshot generations"):
        SnapshotStore(str(tmp_path)).read()


# ---------------------------------------------------------------- journal


def _segments(root):
    return sorted(n for n in os.listdir(root) if n.startswith("seg-"))


def test_journal_round_trip_rotation_and_fsync_batching(tmp_path):
    """Rotation, fsync batching, seq order, int ids; the segments equal the JAX
    package's byte for byte."""
    root, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    for journal_cls, where in ((TrafficJournal, root), (JTrafficJournal, jroot)):
        with journal_cls(where, fsync_every=2, segment_records=3) as j:
            for seq in range(1, 9):
                j.append(f"tenant-{seq % 3}", f"d{seq}", seq, t=seq * 0.5)
            j.append("q", "boom", 9, kind="quarantine", rolled_back=[4, 7])
        assert j.records == 9 and j.fsyncs >= 4
    assert _segments(root) == _segments(jroot) and len(_segments(root)) >= 3
    for name in _segments(root):
        assert open(os.path.join(root, name), "rb").read() == open(os.path.join(jroot, name), "rb").read()
    recs = TrafficJournal.read(root)
    assert [r.seq for r in recs] == list(range(1, 10))
    assert recs[0].tenant_id == "tenant-1" and recs[0].digest == "d1" and recs[3].t == 2.0
    assert recs[-1].kind == "quarantine" and recs[-1].rolled_back == (4, 7)
    with TrafficJournal(root) as j2:
        j2.append(7, "d10", 10)
    recs = TrafficJournal.read(root)
    assert [r.seq for r in recs] == list(range(1, 11)) and recs[-1].tenant_id == 7
    assert [r.seq for r in JTrafficJournal.read(root)] == list(range(1, 11))


def test_journal_torn_tail_tolerated_corruption_raises(tmp_path):
    root = str(tmp_path)
    with TrafficJournal(root, segment_records=4) as j:
        for seq in range(1, 7):
            j.append("t", f"d{seq}", seq)
    segs = _segments(root)
    last = os.path.join(root, segs[-1])
    raw = open(last, "rb").read()
    with open(last, "wb") as fh:
        fh.write(raw[:-5])
    assert [r.seq for r in TrafficJournal.read(root)] == [1, 2, 3, 4, 5]
    first = os.path.join(root, segs[0])
    raw0 = bytearray(open(first, "rb").read())
    raw0[-3] ^= 0x01
    with open(first, "wb") as fh:
        fh.write(bytes(raw0))
    with pytest.raises(StateCorruptionError, match="CRC"):
        TrafficJournal.read(root)


def test_journal_damage_to_a_rotated_segment_raises(tmp_path):
    root = str(tmp_path)
    with TrafficJournal(root, segment_records=2) as j:
        for seq in range(1, 6):
            j.append("t", f"d{seq}", seq)
    first = os.path.join(root, _segments(root)[0])
    raw = open(first, "rb").read()
    with open(first, "wb") as fh:
        fh.write(raw[:-4])
    with pytest.raises(StateCorruptionError, match="truncated"):
        TrafficJournal.read(root)


def test_journal_sequence_regression_raises(tmp_path):
    root = str(tmp_path)
    with TrafficJournal(root) as j:
        j.append("t", "d5", 5)
        j.append("t", "d3", 3)
    with pytest.raises(StateCorruptionError, match="regressed"):
        TrafficJournal.read(root)


def test_journal_validates_and_reads_missing_root_as_empty(tmp_path):
    with pytest.raises(TorchMetricsUserError, match="fsync_every"):
        TrafficJournal(str(tmp_path), fsync_every=0)
    assert TrafficJournal.read(str(tmp_path / "never-created")) == []


def test_journal_crash_cuts_back_to_the_last_fsync_and_prunes_covered(tmp_path):
    """``crash()`` drops what the last fsync did not cover and ``prune_covered`` removes
    the rotated segments a snapshot's cursor covers: the same records and segments as
    the JAX package's journal after the same calls."""
    seen = []
    for journal_cls, where in ((TrafficJournal, tmp_path / "port"), (JTrafficJournal, tmp_path / "jax")):
        j = journal_cls(str(where), fsync_every=3, segment_records=4)
        for seq in range(1, 11):
            j.append("t", f"d{seq}", seq)
        j.crash()
        after_crash = [r.seq for r in journal_cls.read(str(where))]
        j2 = journal_cls(str(where), segment_records=4)
        removed = j2.prune_covered(6)
        j2.close()
        seen.append((after_crash, removed, sorted(os.listdir(str(where)))))
    assert seen[0] == seen[1]
    assert seen[0][0] == list(range(1, 9))  # 9 and 10 were past the last fsync


def test_batch_digest_is_content_addressed():
    """The digest equals the JAX package's for the same numpy batch (tensors, numpy
    arrays and kwargs alike) and moves with any byte, dtype or shape."""
    rng = np.random.default_rng(3)
    preds, target = _batch(rng)
    tp, tt_ = torch.from_numpy(preds), torch.from_numpy(target)
    base = batch_digest((tp, tt_), {})
    assert base == jbatch_digest((jnp.asarray(preds), jnp.asarray(target)), {})
    assert base == batch_digest((preds, target), {})
    assert batch_digest((tp,), {"target": tt_}) == jbatch_digest((jnp.asarray(preds),), {"target": jnp.asarray(target)})
    assert batch_digest((tp, 1.0), {}) == jbatch_digest((jnp.asarray(preds), 1.0), {})
    bumped = tp.clone()
    bumped[0, 0] += 1.0
    assert batch_digest((bumped, tt_), {}) != base
    assert batch_digest((tp, tt_.float()), {}) != base
    assert batch_digest((tp[:2], tt_[:2]), {}) != base
    bf = tp.to(torch.bfloat16)
    assert batch_digest((bf,), {}) == jbatch_digest((jnp.asarray(preds).astype(jnp.bfloat16),), {})


# ----------------------------------------------- engine snapshot + replay


def _config(root, **kw):
    kw.setdefault("capacity", 6)
    kw.setdefault("megabatch_size", 3)
    return ServingConfig(journal=os.path.join(root, "journal"), **kw)


def test_engine_restore_plus_replay_reaches_bitwise_parity(tmp_path):
    """Kill the primary after a snapshot and more journaled traffic: restore + replay on
    a cold standby reproduces every tenant's state bit for bit; a retried replay
    applies nothing. The journal's records equal the JAX engine's for the same
    traffic (same seqs, tenants and digests)."""
    from torchmetrics_tpu.classification import MulticlassAccuracy as JAccuracy
    from torchmetrics_tpu.serving import ServingConfig as JServingConfig
    from torchmetrics_tpu.serving import ServingEngine as JServingEngine

    root = str(tmp_path)
    snap_dir = os.path.join(root, "snaps")
    rng = np.random.default_rng(17)
    tenants = [f"t{i}" for i in range(8)]
    primary = ServingEngine(_acc(), _config(root))
    jprimary = JServingEngine(JAccuracy(num_classes=NUM_CLASSES, average="micro", validate_args=False),
                              JServingConfig(capacity=6, megabatch_size=3, journal=os.path.join(root, "jjournal")))
    retained = {}
    for step in range(30):
        b = _batch(rng)
        assert primary.update(tenants[step % len(tenants)], *b)
        jprimary.update(tenants[step % len(tenants)], jnp.asarray(b[0]), jnp.asarray(b[1]))
        retained[primary._applied_seq] = ((b[0], b[1]), {})
        if step == 14:
            out = primary.snapshot(snap_dir)
            assert out["generation"] == 1 and out["tenants"] == len(tenants)
    primary.flush()
    want = {tid: primary.state_dict(tid) for tid in tenants}
    want_vals = {tid: float(primary.compute(tid)) for tid in tenants}
    primary.close()
    jprimary.close()
    records = TrafficJournal.read(os.path.join(root, "journal"))
    jrecords = JTrafficJournal.read(os.path.join(root, "jjournal"))
    assert [(r.seq, r.tenant_id, r.digest) for r in records] == [(r.seq, r.tenant_id, r.digest) for r in jrecords]

    standby = ServingEngine(_acc(), _config(root))
    standby.restore(snap_dir)
    assert standby.replay_journal(records, lambda r: retained[r.seq]) == 30 - 15
    standby.flush()
    for tid in tenants:
        got = standby.state_dict(tid)
        assert sorted(got) == sorted(want[tid])
        for name, v in want[tid].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[name], v), f"{tid}/{name}"
            else:
                assert got[name] == v
        assert float(standby.compute(tid)) == want_vals[tid]
    assert standby.replay_journal(records, lambda r: retained[r.seq]) == 0
    standby.close()


def test_replay_verifies_digests_and_restore_checks_geometry(tmp_path):
    root = str(tmp_path)
    snap_dir = os.path.join(root, "snaps")
    rng = np.random.default_rng(5)
    engine = ServingEngine(_acc(), _config(root))
    retained = {}
    for _ in range(4):
        b = _batch(rng)
        engine.update("solo", *b)
        retained[engine._applied_seq] = ((b[0], b[1]), {})
    engine.snapshot(snap_dir)
    engine.close()
    other = ServingEngine(_acc(), ServingConfig(capacity=8, megabatch_size=4))
    with pytest.raises(TorchMetricsUserError, match="geometry"):
        other.restore(snap_dir)
    standby = ServingEngine(_acc(), _config(root))
    records = TrafficJournal.read(os.path.join(root, "journal"))
    wrong = _batch(np.random.default_rng(99))
    standby._applied_seq = 0
    with pytest.raises(StateCorruptionError, match="digest"):
        standby.replay_journal(records, lambda r: ((wrong[0], wrong[1]), {}))
    standby.close()


def test_journal_requires_json_safe_tenant_ids(tmp_path):
    engine = ServingEngine(_acc(), _config(str(tmp_path)))
    with pytest.raises(TorchMetricsUserError, match="tenant ids"):
        engine.update(("tuple", "id"), *_batch(np.random.default_rng(0)))
    engine.close()


def test_quarantine_transition_replays_and_snapshots_retain(tmp_path):
    """A quarantine lands in the journal with its rolled-back admissions; a standby
    replaying it comes up with the tenant quarantined and its peers bit for bit;
    ``retain_snapshots`` keeps the newest generations."""
    root = str(tmp_path)
    snap_dir = os.path.join(root, "snaps")
    rng = np.random.default_rng(8)
    cfg = lambda: _config(root, on_error="quarantine", auto_flush=False, retain_snapshots=2)
    primary = ServingEngine(_acc(), cfg())
    primary.snapshot(snap_dir)
    retained = {}
    for step in range(6):
        b = _batch(rng)
        primary.update(f"t{step % 3}", *b)
        retained[primary._applied_seq] = ((b[0], b[1]), {})
    primary._fault_hook = lambda tids: (_ for _ in ()).throw(RuntimeError("poisoned")) if "t1" in tids else None
    primary.flush()
    primary._fault_hook = None
    assert primary.tenants()["t1"]["quarantined"]
    primary.snapshot(snap_dir)
    out = primary.snapshot(snap_dir)
    assert out["pruned_generations"] == 1 and SnapshotStore(snap_dir).generations() == [2, 3]
    want = {tid: primary.state_dict(tid) for tid in ("t0", "t2")}
    primary.close()
    records = TrafficJournal.read(os.path.join(root, "journal"))
    assert any(r.kind == "quarantine" and r.tenant_id == "t1" and r.rolled_back for r in records)
    standby = ServingEngine(_acc(), cfg())
    standby.restore(snap_dir, generation=2)
    standby._applied_seq = 0  # replay the whole journal over the restored fleet
    standby._classes, standby._tenants = {}, {}
    standby.replay_journal(records, lambda r: retained[r.seq])
    standby.flush()
    assert standby.tenants()["t1"]["quarantined"]
    for tid, sd in want.items():
        got = standby.state_dict(tid)
        for name, v in sd.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[name], v), f"{tid}/{name}"
    standby.close()


# ------------------------------------------------------------ degraded sync


def test_dead_rank_survivor_quorum_then_rejoin():
    """World of 2, rank 1 dead: the sync folds the survivor alone and marks the ledger;
    the revival sync is the rejoin and folds the returned rank once."""
    dead = DeadRank(world=2, rank=1)
    m = SumMetric(dist_sync_fn=dead, distributed_available_fn=lambda: True, **CPU)
    m.update(torch.tensor(3.0))
    with telemetry_session() as rec:
        m.sync()
        assert float(m.sum_value) == 3.0
        m.unsync()
        assert C.dead_ranks() == {1: 1}
        dead.revive()
        m.sync()
        assert float(m.sum_value) == 6.0
        m.unsync()
        assert C.dead_ranks() == {}
    assert rec.counters.value("degraded_syncs") >= 1 and rec.counters.value("rank_rejoins") >= 1
    assert {e.kind for e in rec.events_of("degraded_sync", "rank_rejoin")} == {"degraded_sync", "rank_rejoin"}


def test_dead_rank_validates():
    with pytest.raises(ValueError, match="world"):
        DeadRank(world=1)
    with pytest.raises(ValueError, match="rank"):
        DeadRank(world=2, rank=2)


def test_async_handle_reports_degraded_world():
    dead = DeadRank(world=2, rank=1)
    handle = AsyncSyncHandle([{"sum_value": torch.tensor(4.0)}], [{"sum_value": "sum"}], dist_sync_fn=dead)
    (synced,) = handle.commit()
    assert float(synced["sum_value"]) == 4.0
    assert handle.degraded and handle.dead_ranks == C.dead_ranks() != {}
    dead.revive()
    handle = AsyncSyncHandle([{"sum_value": torch.tensor(4.0)}], [{"sum_value": "sum"}], dist_sync_fn=dead)
    (synced,) = handle.commit()
    assert float(synced["sum_value"]) == 8.0
    assert not handle.degraded and handle.dead_ranks == {}


def test_liveness_epoch_bumps_monotonically():
    e0 = C.liveness_epoch()
    try:
        assert C.bump_liveness_epoch() == e0 + 1
        assert C.liveness_epoch() == e0 + 1
        assert C.build_local_metadata([{"x": torch.zeros(2)}], [{"x": "sum"}])[5] == e0 + 1
        JC._LIVENESS["epoch"] = e0 + 1
        np.testing.assert_array_equal(
            C.build_local_metadata([{"x": torch.zeros(2)}], [{"x": "sum"}]),
            np.asarray(JC.build_local_metadata([{"x": jnp.zeros(2)}], [{"x": "sum"}])))
    finally:
        C._LIVENESS["epoch"] = e0
        JC._LIVENESS["epoch"] = 1
