"""The fleet controller: N serving engines behind one routing surface (counterpart of
``torchmetrics_tpu/fleet/controller.py``).

Each member host is a full :class:`~torchmetrics_tpu_torch.serving.ServingEngine`
with its own durability plane (``<root>/<host>/journal`` write-ahead journal,
``<root>/<host>/snapshots`` generation store) — the simulated multi-host
world pattern the replay-world sync tests use, one process, N engines.
The controller owns three verbs:

- :meth:`FleetController.serve` routes ``(tenant_id, batch)`` by weighted
  rendezvous placement over the live membership and journals on the owning
  host. Traffic for a host that died but whose lease has not yet expired
  parks in arrival order and replays to the adopting host after failover —
  no admitted batch is dropped in the suspicion window.

- :meth:`FleetController.migrate` moves tenants host-to-host with a
  drain → snapshot-slice → transfer → restore → cutover protocol. Ownership
  flips only at the single commit point: any failure before it aborts
  cleanly (partial destination state scrubbed, transfer artifacts deleted,
  the source still authoritative), so a kill at ANY stage leaves every
  tenant whole on exactly one host. A torn transfer artifact is caught by
  the snapshot container's sha256 at restore and aborts the same way.

- lease expiry (:meth:`FleetController.poll`) triggers failover: survivors
  adopt the dead host's tenants by restoring its latest snapshot
  generation, replaying its journal tail (exactly-once via the engine's
  seq cursors), and seating each tenant on its new rendezvous owner. The
  reconstruction is bitwise (restore + replay → pre-crash state); RPO is
  bounded by the journal fsync window (0 records at ``fsync_every=1``).

Durability barrier: every committed migration and every failover adoption
snapshots the hosts it touched, so "latest snapshot + own journal tail"
stays a complete recovery recipe on every host — a later crash can neither
resurrect a migrated-away tenant nor lose an adopted one.

Each host's engine holds its stacks on the device of the metric ``metric_factory``
builds (the card unless the factory asks for the CPU). What crosses hosts is host
memory: a migration's snapshot slice and a failover's adoption read each tenant's
rows to the host in one copy a leaf a shape class (:func:`_tenant_host_states`), and
the destination parks them spilled until the tenant's next traffic uploads them.
"""

from __future__ import annotations

import dataclasses
import os
import time
import weakref
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Tuple

import numpy as np

from .. import observability as _observability
from ..observability import spans as _spans
from ..serving import ServingConfig, ServingEngine
from ..serving import durability as _durability
from ..utilities.exceptions import TorchMetricsUserError
from .membership import LeaseConfig, Membership
from .placement import Move, place, rebalance_plan

__all__ = [
    "MIGRATION_STAGES",
    "MigrationAborted",
    "FleetController",
    "active_controller",
    "tenant_state_digest",
]

# the most recently constructed live controller (weak — close() clears it);
# the health plane's /fleetz endpoint and the flight recorder's seating
# snapshot answer from here without holding the fleet alive
_ACTIVE_CONTROLLER: Optional["weakref.ReferenceType[FleetController]"] = None


def active_controller() -> Optional["FleetController"]:
    """The live :class:`FleetController`, if one exists (else ``None``)."""
    ref = _ACTIVE_CONTROLLER
    if ref is None:
        return None
    return ref()

# the migrate protocol's stages, in order; the post-stage hook fires after
# each stage's effect lands (kill-point fuzz drives every boundary)
MIGRATION_STAGES = ("drain", "snapshot", "transfer", "restore", "cutover")


class MigrationAborted(TorchMetricsUserError):
    """A migration failed before its commit point and was rolled back: the
    source host still owns every tenant, the destination holds nothing.
    ``__cause__`` carries the original failure."""


def tenant_state_digest(engine: ServingEngine, tenant_id: Hashable) -> str:
    """Canonical digest of ONE tenant's state on ``engine`` — every state
    leaf's dtype/shape/bytes plus the update count, the per-tenant unit of
    the fleet parity gates (host-independent: two hosts holding bitwise the
    same tenant produce the same digest)."""
    return _state_digest(_tenant_host_states(engine, [tenant_id])[tenant_id])


def _state_digest(sd: Dict[str, Any]) -> str:
    """The digest of one host checkpoint (:func:`_tenant_host_states`' layout), as the
    JAX package digests its ``state_dict``: numpy arrays, so the dtypes are spelled as
    numpy spells them."""
    import hashlib

    h = hashlib.sha256()
    h.update(str(int(sd.get("_update_count", 0))).encode("utf-8"))
    for name in sorted(sd):
        if name.startswith("_"):
            continue
        arr = np.asarray(sd[name])
        h.update(name.encode("utf-8"))
        h.update(str(arr.dtype).encode("utf-8"))
        h.update(str(arr.shape).encode("utf-8"))
        h.update(arr.tobytes())
    return h.hexdigest()


def _tenant_host_states(engine: ServingEngine, tenant_ids: Iterable[Hashable]) -> Dict[Hashable, Dict[str, Any]]:
    """Each listed tenant's checkpoint on the host, in ``engine.state_dict``'s layout
    (state leaves and ``_update_count``), read once a leaf a shape class
    (``ServingEngine._host_rows``). Pending traffic is flushed first, once, as a
    ``state_dict`` per tenant would."""
    tenant_ids = list(tenant_ids)
    tenants = [engine._require(tid) for tid in tenant_ids]
    if any(t.pending for t in tenants):
        engine.flush()
    out: Dict[Hashable, Dict[str, Any]] = {}
    for tid, t, row in zip(tenant_ids, tenants, engine._host_rows(tenants)):
        state = dict(row[0]) if row is not None else {k: v.cpu().numpy() for k, v in engine._row_defaults.items()}
        state["_update_count"] = int(t.update_count)
        out[tid] = state
    return out


class _Host:
    """One member host: its engine, durability directories, and the retained
    admitted batches its journal records refer to (the replay fetch source,
    pruned at every snapshot — the soak's retention discipline)."""

    __slots__ = ("host_id", "engine", "journal_dir", "snap_dir", "outbox_dir",
                 "inbox_dir", "retained", "killed", "pre_kill_seq", "kill_trace")

    def __init__(self, host_id: str, engine: ServingEngine, root: str) -> None:
        self.host_id = host_id
        self.engine = engine
        self.journal_dir = os.path.join(root, host_id, "journal")
        self.snap_dir = os.path.join(root, host_id, "snapshots")
        self.outbox_dir = os.path.join(root, host_id, "outbox")
        self.inbox_dir = os.path.join(root, host_id, "inbox")
        self.retained: Dict[int, Tuple[tuple, dict]] = {}
        self.killed = False
        self.pre_kill_seq = 0
        # the span active at kill time (the fault-ledger trace) — the later
        # failover chains its adoption spans off this, linking cause to effect
        self.kill_trace: Optional[_spans.SpanContext] = None


class FleetController:
    """Route, migrate, and fail over tenants across N member engines.

    Args:
        metric_factory: zero-arg callable building one metric template per
            host engine (every host must serve the same template — restore
            and migration require identical engine geometry).
        root: fleet durability root; each host gets ``<root>/<host_id>/``.
        hosts: initial host ids (an int ``n`` means ``host-0 .. host-n-1``).
        serving: per-host :class:`ServingConfig` template; ``journal`` and
            ``clock`` are overridden per host / by the fleet clock.
        lease: the membership thresholds.
        clock: injectable virtual clock shared by admission and leases
            (defaults to ``time.monotonic``).
    """

    def __init__(
        self,
        metric_factory: Callable[[], Any],
        root: str,
        hosts: Any = 3,
        serving: Optional[ServingConfig] = None,
        lease: Optional[LeaseConfig] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        if isinstance(hosts, int):
            if hosts < 1:
                raise TorchMetricsUserError(f"need at least one host, got {hosts}")
            hosts = [f"host-{i}" for i in range(hosts)]
        self._metric_factory = metric_factory
        self.root = str(root)
        self.clock = clock if clock is not None else time.monotonic
        self.serving = serving if serving is not None else ServingConfig()
        self.membership = Membership(self.clock, lease)
        self._hosts: Dict[str, _Host] = {}
        self._owner: Dict[Hashable, str] = {}
        # traffic addressed to a killed-but-not-yet-expired host, in arrival
        # order — redelivered to the adopting host after failover
        self._parked: List[Tuple[Hashable, tuple, dict]] = []
        self.stats: Dict[str, Any] = {
            "served": 0, "parked": 0, "replayed_parked": 0,
            "migrations": 0, "migrated_tenants": 0, "migration_parity_failures": 0,
            "aborted_migrations": 0, "failovers": 0, "adopted_tenants": 0,
            "failover_replayed": 0, "rpo_records": 0, "lease_expiries": 0,
            "dropped_quarantined_adoptions": 0,
        }
        self._serve_seq = 0  # request-span sequence (telemetry-only, deterministic)
        for h in hosts:
            self.add_host(str(h), rebalance=False)
        global _ACTIVE_CONTROLLER
        _ACTIVE_CONTROLLER = weakref.ref(self)

    # --------------------------------------------------------------- hosts

    def _engine_config(self, host_id: str) -> ServingConfig:
        return dataclasses.replace(
            self.serving,
            journal=os.path.join(self.root, host_id, "journal"),
            clock=self.clock,
        )

    def hosts(self) -> Dict[str, str]:
        """host id → lease state for every registered (non-dead) host."""
        return {h: self.membership.state(h) for h in sorted(self._hosts)}

    def add_host(self, host_id: str, weight: float = 1.0, rebalance: bool = True) -> List[Move]:
        """Bring up a member host (join). With ``rebalance`` (the default
        for late joins) the rendezvous fair share of existing tenants
        migrates onto it — the minimal move set, nothing else relocates."""
        if host_id in self._hosts:
            raise TorchMetricsUserError(f"host {host_id!r} already in the fleet")
        engine = ServingEngine(self._metric_factory(), self._engine_config(host_id))
        self._hosts[host_id] = _Host(host_id, engine, self.root)
        self.membership.join(host_id, weight)
        if not rebalance or not self._owner:
            return []
        plan = rebalance_plan(self._owner, self.membership.hosts())
        by_src: Dict[str, List[Hashable]] = {}
        for m in plan:
            if m.src is not None:
                by_src.setdefault(m.src, []).append(m.tenant_id)
        for src in sorted(by_src):
            self.migrate(by_src[src], host_id)
        return plan

    def kill_host(self, host_id: str) -> None:
        """Simulate a host crash: the journal tears at its last fsync (the
        real loss window), the engine stops serving, heartbeats stop. The
        lease runs to expiry — failover happens at :meth:`poll` after
        ``dead_after``, not here (the suspicion window is the point)."""
        h = self._require_host(host_id)
        if h.killed:
            return
        h.pre_kill_seq = int(h.engine._applied_seq)
        if h.engine._journal is not None:
            h.engine._journal.crash()
        h.killed = True
        if _observability._ACTIVE is not None:
            h.kill_trace = _spans.current()

    def heartbeat_all(self) -> None:
        """One heartbeat round: every non-killed host renews its lease."""
        rec = _observability._ACTIVE
        for host_id in sorted(self._hosts):
            if not self._hosts[host_id].killed:
                self.membership.heartbeat(host_id)
                if rec is not None:
                    rec.record_fleet_heartbeat(host_id)

    def poll(self) -> List[str]:
        """Check leases; fail over every host whose lease expired since the
        last poll. Returns the hosts failed over (the soak's resolution
        signal for ``host_loss``)."""
        expired = self.membership.expire()
        rec = _observability._ACTIVE
        for host_id in expired:
            self.stats["lease_expiries"] += 1
            if rec is not None:
                rec.record_lease_expiry(host_id)
            self._failover(host_id)
        return expired

    def _require_host(self, host_id: str) -> _Host:
        h = self._hosts.get(host_id)
        if h is None:
            raise TorchMetricsUserError(f"unknown host {host_id!r}")
        return h

    # --------------------------------------------------------------- serve

    def owner(self, tenant_id: Hashable) -> str:
        """The host currently seating ``tenant_id`` (placing it now if it
        has never been seen)."""
        host = self._owner.get(tenant_id)
        if host is None:
            host = place(tenant_id, self.membership.hosts())
            self._owner[tenant_id] = host
        return host

    def serve(self, tenant_id: Hashable, *args: Any, **kwargs: Any) -> bool:
        """Route one batch to its owner and fold it (journal-first on the
        owning host). Returns the engine's admission verdict; batches for a
        crashed-but-unexpired owner park and count as admitted (they replay
        to the adopting host — the suspicion window drops nothing)."""
        ctx = None
        if _observability._ACTIVE is not None:
            # request span: everything the routed batch triggers (admission,
            # journal append, the megabatch dispatch it seats into) links
            # back to this deterministic per-request trace
            self._serve_seq += 1
            ctx = _spans.enter("serve", repr(tenant_id), self._serve_seq)
        try:
            host = self.owner(tenant_id)
            h = self._hosts[host]
            if h.killed:
                # the owner is down but its lease has not expired: hold the
                # batch (arrival order) until failover reseats the tenant
                self._parked.append((tenant_id, args, dict(kwargs)))
                self.stats["parked"] += 1
                return True
            ok = h.engine.update(tenant_id, *args, **kwargs)
            if ok:
                self.stats["served"] += 1
                if h.engine._journal is not None:
                    h.retained[h.engine._applied_seq] = (args, dict(kwargs))
            return ok
        finally:
            if ctx is not None:
                _spans.exit(ctx)

    def _drain_parked(self) -> None:
        """Redeliver parked traffic whose tenant has a live owner again."""
        parked, self._parked = self._parked, []
        for tenant_id, args, kwargs in parked:
            host = self.owner(tenant_id)
            if self._hosts[host].killed:
                self._parked.append((tenant_id, args, kwargs))
                continue
            self.stats["replayed_parked"] += 1
            ok = self._hosts[host].engine.update(tenant_id, *args, **kwargs)
            if ok:
                self.stats["served"] += 1
                eng = self._hosts[host].engine
                if eng._journal is not None:
                    self._hosts[host].retained[eng._applied_seq] = (args, kwargs)

    # ----------------------------------------------------------- durability

    def snapshot_host(self, host_id: str) -> Dict[str, Any]:
        """Snapshot one host and prune its retained-batch buffer to the new
        cursor (everything the snapshot covers never replays)."""
        h = self._require_host(host_id)
        info = h.engine.snapshot(h.snap_dir)
        cutoff = int(h.engine._applied_seq)
        for seq in [s for s in h.retained if s <= cutoff]:
            del h.retained[seq]
        return info

    def snapshot_all(self) -> Dict[str, Dict[str, Any]]:
        return {
            host_id: self.snapshot_host(host_id)
            for host_id in sorted(self._hosts)
            if not self._hosts[host_id].killed
        }

    # ------------------------------------------------------------- failover

    def _failover(self, host_id: str) -> None:
        """Survivors adopt a dead host's tenants: restore its latest
        snapshot generation into a recovery engine, replay its journal tail
        (exactly-once seq cursors), then seat each tenant on its new
        rendezvous owner and snapshot the adopters (durability barrier)."""
        h = self._hosts.pop(host_id)
        survivors = self.membership.hosts()
        if not survivors or all(self._hosts[s].killed for s in survivors):
            self._hosts[host_id] = h  # put it back: nothing can adopt
            raise TorchMetricsUserError(
                f"host {host_id!r} expired but no live host remains to adopt its tenants"
            )
        survivors = {s: w for s, w in survivors.items() if not self._hosts[s].killed}
        rec = _observability._ACTIVE
        ctx = None
        if rec is not None:
            # child of the kill-time span when one was recorded: the fault-
            # ledger trace id flows through restore/replay/adoption events
            ctx = _spans.enter("failover", host_id, parent=h.kill_trace)
        try:
            self._failover_adopt(host_id, h, survivors, rec)
        finally:
            if ctx is not None:
                _spans.exit(ctx)
        self._drain_parked()

    def _failover_adopt(
        self, host_id: str, h: _Host, survivors: Dict[str, float],
        rec: Optional[Any],
    ) -> None:
        # bitwise reconstruction: latest snapshot + journal tail
        recovery = ServingEngine(
            self._metric_factory(),
            dataclasses.replace(self.serving, journal=None, clock=self.clock),
        )
        if _durability.SnapshotStore(h.snap_dir).generations():
            recovery.restore(h.snap_dir)
        records = _durability.TrafficJournal.read(h.journal_dir)
        replayed = recovery.replay_journal(records, lambda r: h.retained[r.seq])
        recovery.flush()
        rpo = max(0, h.pre_kill_seq - int(recovery._applied_seq))
        # adoption: every tenant moves to its new rendezvous owner
        roster = recovery.tenants()
        adopted = 0
        adopted_ids: List[str] = []
        touched: List[str] = []
        # one host read of the recovered rows for the whole roster
        states = _tenant_host_states(
            recovery, [tid for tid, info in roster.items() if not info["quarantined"]])
        for tenant_id in sorted(roster, key=repr):
            if roster[tenant_id]["quarantined"]:
                # a quarantined tenant's state is frozen garbage by contract —
                # adopting it would launder a contained fault into a clean host
                self._owner.pop(tenant_id, None)
                self.stats["dropped_quarantined_adoptions"] += 1
                continue
            dst = place(tenant_id, survivors)
            self._hosts[dst].engine.load_state_dict(tenant_id, states[tenant_id])
            self._owner[tenant_id] = dst
            adopted += 1
            adopted_ids.append(repr(tenant_id))
            if dst not in touched:
                touched.append(dst)
        for dst in touched:
            self.snapshot_host(dst)
        # a tenant routed to the dead host but never durably folded (first
        # seen inside the suspicion window, batches all parked) has no state
        # to adopt — drop its stale route so the next serve re-places it
        for tenant_id in [t for t, owner in self._owner.items() if owner == host_id]:
            del self._owner[tenant_id]
        self.stats["failovers"] += 1
        self.stats["adopted_tenants"] += adopted
        self.stats["failover_replayed"] += replayed
        self.stats["rpo_records"] = max(self.stats["rpo_records"], rpo)
        if rec is not None:
            rec.record_host_failover(
                host_id, host_id, adopted, replayed, rpo, roster=adopted_ids,
            )

    # ------------------------------------------------------------ migration

    def migrate(
        self,
        tenants: Iterable[Hashable],
        dst: str,
        _stage_hook: Optional[Callable[[str], None]] = None,
    ) -> Dict[str, Any]:
        """Move ``tenants`` onto host ``dst`` with the staged protocol.

        ``_stage_hook(stage)`` fires after each stage's effect (test seam —
        the kill-point fuzz raises or tears the transfer artifact here).
        Any failure before the cutover commit rolls back completely and
        raises :class:`MigrationAborted`; after the commit the migration is
        final. Returns ``{"moved", "src_hosts", "parity_failures"}``."""
        hook = _stage_hook if _stage_hook is not None else (lambda stage: None)
        dst_h = self._require_host(dst)
        if dst_h.killed:
            raise TorchMetricsUserError(f"cannot migrate onto dead host {dst!r}")
        tenants = list(tenants)
        by_src: Dict[str, List[Hashable]] = {}
        for tid in tenants:
            src = self._owner.get(tid)
            if src is None:
                raise TorchMetricsUserError(f"unknown tenant {tid!r}")
            if src == dst:
                continue
            if self._hosts[src].killed:
                raise TorchMetricsUserError(
                    f"tenant {tid!r} lives on dead host {src!r} — failover, not migration"
                )
            by_src.setdefault(src, []).append(tid)
        t0 = time.perf_counter()
        moved = 0
        parity_failures = 0
        ctx = None
        if _observability._ACTIVE is not None:
            ctx = _spans.enter("migration", ",".join(sorted(by_src)), dst, len(tenants))
        try:
            for src in sorted(by_src):
                moved_n, bad = self._migrate_group(src, by_src[src], dst, hook)
                moved += moved_n
                parity_failures += bad
            duration = time.perf_counter() - t0
            if moved:
                self.stats["migrations"] += 1
                self.stats["migrated_tenants"] += moved
                self.stats["migration_parity_failures"] += parity_failures
                rec = _observability._ACTIVE
                if rec is not None:
                    rec.record_migration(
                        "fleet", ",".join(sorted(by_src)), dst, moved, duration
                    )
        finally:
            if ctx is not None:
                _spans.exit(ctx)
        return {"moved": moved, "src_hosts": sorted(by_src), "parity_failures": parity_failures}

    def _migrate_group(
        self,
        src: str,
        tids: List[Hashable],
        dst: str,
        hook: Callable[[str], None],
    ) -> Tuple[int, int]:
        src_h = self._hosts[src]
        dst_h = self._hosts[dst]
        outbox_path: Optional[str] = None
        inbox_path: Optional[str] = None
        generation: Optional[int] = None
        restored: List[Hashable] = []
        # per-stage child spans of the ambient migration span: events a stage
        # triggers (snapshots, dispatches) attribute to THEIR stage boundary
        stage_ctx: List[Optional[_spans.SpanContext]] = [None]

        def _stage_enter(name: str) -> None:
            if _observability._ACTIVE is not None:
                stage_ctx[0] = _spans.enter("migrate_stage", src, dst, name)

        def _stage_exit() -> None:
            if stage_ctx[0] is not None:
                _spans.exit(stage_ctx[0])
                stage_ctx[0] = None

        try:
            # 1. drain: queued megabatches land on src (their admissions are
            # already journaled — nothing new can be lost past this point)
            _stage_enter("drain")
            src_h.engine.flush()
            hook("drain")
            _stage_exit()
            # 2. snapshot-slice: the tenants' exact state rows, published as
            # one atomic sha256-sealed artifact in src's outbox
            _stage_enter("snapshot")
            slices = _tenant_host_states(src_h.engine, tids)
            pre_digests = {tid: _state_digest(slices[tid]) for tid in tids}
            sections: Dict[str, np.ndarray] = {}
            entries: List[Dict[str, Any]] = []
            for i, tid in enumerate(tids):
                sd = slices[tid]
                entries.append({
                    "id": _durability.encode_tenant_id(tid),
                    "update_count": int(sd.get("_update_count", 0)),
                    "keys": sorted(k for k in sd if not k.startswith("_")),
                })
                for name in entries[-1]["keys"]:
                    sections[f"t{i}/{name}"] = np.asarray(sd[name])
            outbox = _durability.SnapshotStore(src_h.outbox_dir)
            info = outbox.write({"src": src, "dst": dst, "tenants": entries}, sections)
            outbox_path, generation = info["path"], info["generation"]
            hook("snapshot")
            _stage_exit()
            _stage_enter("transfer")
            # 3. transfer: ship the artifact bytes to dst's inbox (the
            # simulated network copy — a kill here leaves at worst a torn
            # file that restore's sha256 check rejects)
            os.makedirs(dst_h.inbox_dir, exist_ok=True)
            inbox_path = os.path.join(dst_h.inbox_dir, os.path.basename(outbox_path))
            with open(outbox_path, "rb") as fh:
                payload = fh.read()
            with open(inbox_path, "wb") as fh:
                fh.write(payload)
            hook("transfer")
            _stage_exit()
            _stage_enter("restore")
            # 4. restore: decode the artifact ON DST (sha256-verified — a
            # torn transfer dies here, not after cutover) and park each
            # tenant's state on the destination engine
            meta, rx_sections = _durability.SnapshotStore(dst_h.inbox_dir).read(generation)
            for i, entry in enumerate(meta["tenants"]):
                tid = _durability.decode_tenant_id(entry["id"])
                sd: Dict[str, Any] = {
                    name: np.asarray(rx_sections[f"t{i}/{name}"]) for name in entry["keys"]
                }
                sd["_update_count"] = int(entry["update_count"])
                dst_h.engine.load_state_dict(tid, sd)
                restored.append(tid)
            hook("restore")
            _stage_exit()
        except BaseException as err:
            # ---- abort: ownership never flipped; scrub every partial effect
            _stage_exit()
            self.stats["aborted_migrations"] += 1
            for tid in restored:
                try:
                    dst_h.engine.forget(tid)
                except Exception:  # noqa: BLE001 — best-effort scrub
                    pass
            for path in (inbox_path, outbox_path):
                if path is not None and os.path.exists(path):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            raise MigrationAborted(
                f"migration {src!r} -> {dst!r} aborted before cutover "
                f"({len(tids)} tenants stay on {src!r}): {err}"
            ) from err
        # ---- 5. cutover: THE commit point. Ownership flips, the source
        # forgets, artifacts are swept, and both hosts snapshot so their own
        # "latest snapshot + journal tail" recipes stay complete. A kill
        # from here on is post-commit: the destination owns every tenant.
        _stage_enter("cutover")
        parity_failures = 0
        landed = _tenant_host_states(dst_h.engine, tids)
        for tid in tids:
            if _state_digest(landed[tid]) != pre_digests[tid]:
                parity_failures += 1
            self._owner[tid] = dst
            src_h.engine.forget(tid)
        for path in (inbox_path, outbox_path):
            if path is not None and os.path.exists(path):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        self.snapshot_host(src)
        self.snapshot_host(dst)
        hook("cutover")
        _stage_exit()
        return len(tids), parity_failures

    # ------------------------------------------------------------- read side

    def compute(self, tenant_id: Hashable) -> Any:
        host = self._owner.get(tenant_id)
        if host is None:
            raise TorchMetricsUserError(f"unknown tenant {tenant_id!r}")
        return self._hosts[host].engine.compute(tenant_id)

    def tenants(self) -> Dict[Hashable, str]:
        """tenant → owning host (the routing table)."""
        return dict(self._owner)

    def engines(self) -> Dict[str, ServingEngine]:
        """host id → live engine (killed hosts excluded) — the read seam the
        control tower and the flight recorder's seating snapshot use."""
        return {
            host_id: h.engine
            for host_id, h in sorted(self._hosts.items())
            if not h.killed
        }

    # the control tower's per-host engine-stat → fleet-counter-field mapping
    # (one shared recorder serves every engine in this process, so per-host
    # attribution must come from each engine's own stats, not the counters)
    _STATS_COUNTER_MAP: Tuple[Tuple[str, str], ...] = (
        ("serve_dispatches", "dispatches"),
        ("serve_tenant_rows", "tenant_rows"),
        ("serve_padded_rows", "padded_rows"),
        ("tenant_spills", "spills"),
        ("tenant_readmits", "readmissions"),
        ("quarantines", "quarantined"),
        ("serve_rejected", "rejected_batches"),
        ("window_rotations", "window_rotations"),
    )

    def telemetry(self, top_k: int = 5) -> Dict[str, Any]:
        """The fleet control tower: one rollup of per-host counters (merged
        through :func:`aggregate_counters`), per-kind latency histograms,
        top-``top_k`` hot tenants (by folded rows, with spill/quarantine
        flags), lease states, and the controller's own lifecycle stats.
        This is what ``/fleetz`` serves and ``serve_demo --fleet`` prints."""
        from ..observability.counters import aggregate_counters

        live = self.engines()
        per_host: Dict[str, Dict[str, int]] = {
            host_id: {
                field: int(engine.stats.get(stat, 0))
                for field, stat in self._STATS_COUNTER_MAP
            }
            for host_id, engine in live.items()
        }
        hosts_sorted = sorted(per_host)
        totals: Dict[str, int] = {field: 0 for field, _ in self._STATS_COUNTER_MAP}
        if per_host:
            merged = aggregate_counters([per_host[h] for h in hosts_sorted])
            totals = {
                field: int(merged.totals.get(field, 0))
                for field, _ in self._STATS_COUNTER_MAP
            }
        hot: List[Dict[str, Any]] = []
        for host_id, engine in live.items():
            for tid, info in engine.tenants().items():
                hot.append({
                    "tenant": repr(tid)[:80],
                    "host": host_id,
                    "rows": int(info["update_count"]),
                    "spilled": bool(info["spilled"]),
                    "quarantined": bool(info["quarantined"]),
                })
        hot.sort(key=lambda r: (-r["rows"], r["tenant"], r["host"]))
        out: Dict[str, Any] = {
            "hosts": per_host,
            "totals": totals,
            "hot_tenants": hot[:max(0, int(top_k))],
            "tenant_count": len(hot),
            "membership": self.hosts(),
            "parked": len(self._parked),
            "stats": dict(self.stats),
        }
        rec = _observability._ACTIVE
        if rec is not None:
            out["latency"] = rec.latency_summary()
            if rec.history is not None:
                # the fleet sim shares one recorder per process, so this IS the
                # fleet-wide history: retained level boundaries ride the tower
                out["history"] = rec.history.levels()
        return out

    def tenant_digests(self) -> Dict[Hashable, str]:
        """Per-tenant state digests across the whole fleet (the parity
        oracle: compare against a single-host reference run)."""
        for h in self._hosts.values():
            if not h.killed:
                h.engine.flush()
        by_host: Dict[str, List[Hashable]] = {}
        for tid, host in self._owner.items():
            h = self._hosts.get(host)
            if h is not None and not h.killed:
                by_host.setdefault(host, []).append(tid)
        states: Dict[Hashable, Dict[str, Any]] = {}
        for host, tids in by_host.items():
            states.update(_tenant_host_states(self._hosts[host].engine, tids))
        return {tid: _state_digest(states[tid]) for tid in self._owner if tid in states}

    def flush(self) -> None:
        for h in self._hosts.values():
            if not h.killed:
                h.engine.flush()

    def close(self) -> None:
        global _ACTIVE_CONTROLLER
        for h in self._hosts.values():
            if not h.killed:
                h.engine.close()
        if _ACTIVE_CONTROLLER is not None and _ACTIVE_CONTROLLER() is self:
            _ACTIVE_CONTROLLER = None
