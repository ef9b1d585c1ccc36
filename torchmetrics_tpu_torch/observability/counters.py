"""Process-wide telemetry counters.

Everything the runtime can observe without a device→host readback is counted
here: jitted dispatches split into compiles vs cache hits per ``_jit_cache`` key
(first-seen input shape/dtype signature == a trace/compile; a repeat == a cache
hit, mirroring ``jax.jit``'s own cache discipline — in the PyTorch port, which
compiles nothing, a first-seen and a repeated input signature of an eager
dispatch; the names are kept because the counter vector is the wire format), retraces (every compile
beyond a key's first), device→host readbacks at the runtime's instrumented
sites (``state_dict``, ``compute_on_cpu`` appends, finiteness guards),
``process_sync`` invocations with payload bytes (computed from array metadata —
``shape``/``dtype`` never touch the device), and the reliability layer's
retry/quarantine totals.

The registry is pure stdlib (no torch import): the benchmark and
``tools/trace_report.py`` consume snapshots without initializing a runtime.
Counting happens only while a telemetry session is active — a disabled process
never calls into this module from a dispatch path.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

# every scalar the registry tracks, in reporting order
COUNTER_FIELDS: Tuple[str, ...] = (
    "dispatches",  # jitted donated dispatches (update/forward tensor path)
    "jit_compiles",  # first-seen (key, signature) pairs — one XLA trace each
    "jit_cache_hits",  # repeat signatures — served from an in-memory program
    "retraces",  # compiles beyond a key's first actual compile (shape/dtype churn)
    "aot_cache_hits",  # first-seen signatures served by a LOADED executable (aot/)
    "aot_cache_misses",  # aot-plane disk probes that found nothing usable
    "aot_deserialize_us",  # wall-clock spent loading serialized executables
    "host_dispatches",  # HostMetric update/forward (eager, never jitted)
    "computes",  # Metric.compute invocations
    "d2h_readbacks",  # device→host transfers at instrumented runtime sites
    "d2h_bytes",
    "sync_calls",  # process_sync invocations
    "sync_payload_bytes",  # bytes entering the cross-process gather
    "sync_time_us",  # wall-clock spent inside Metric.sync (straggler signal)
    "gather_calls",  # per-leaf gather_all_arrays collectives (fallback plane)
    "gathers_coalesced",  # state leaves served by a coalesced bucket (no own collective)
    "sync_collectives",  # collectives actually launched by the sync planes
    "sync_bytes_saved",  # wire bytes the quantized codecs shaved off sync payloads
    "quantized_buckets",  # dtype buckets shipped as compressed byte streams
    "retries",  # transient failures accepted for retry
    "retries_exhausted",  # retry budgets that ran out on a transient failure
    "quarantines",  # metrics frozen by MetricCollection(on_error="quarantine")
    "skips",  # per-batch skips under on_error="skip"
    "state_growths",  # list/cat states that crossed the unbounded-growth sentinel
    "alerts",  # SLO engine alerts emitted (breaches + rule errors)
    "serve_dispatches",  # megabatched stacked-state dispatches (serving engine)
    "serve_tenant_rows",  # real tenant rows those dispatches served
    "serve_padded_rows",  # scratch pad rows burned to keep megabatch signatures fixed
    "tenant_spills",  # cold tenant states spilled from the stack to host memory
    "tenant_readmits",  # spilled tenant states uploaded back into a stack slot
    "tenant_spill_us",  # wall-clock spent spilling/readmitting tenant state
    "window_rolls",  # SlidingWindow updates (streaming plane, wupdate/wdual/wstack dispatches)
    "window_rotations",  # dual block rotations / two-stack pane completions (window hop progress)
    "async_syncs",  # double-buffered background syncs committed (AsyncSyncHandle)
    "async_sync_wait_us",  # wall-clock commit() actually blocked — the UNHIDDEN sync latency
    "drift_evals",  # DriftMonitor window-vs-reference evaluations
    "drift_breaches",  # evaluations whose drift score crossed the monitor's threshold
    "serve_rejected",  # tenant batches shed by the serving admission rate limit
    "snapshots",  # crash-consistent engine snapshot generations written (durability plane)
    "snapshot_restores",  # engine restores from a snapshot generation
    "journal_records",  # batches appended to the write-ahead traffic journal
    "journal_fsyncs",  # journal appends that reached stable storage (fsync batches)
    "replayed_records",  # journal records rolled forward into a restored engine
    "degraded_syncs",  # coalesced syncs completed over a survivor quorum (dead rank seen)
    "rank_rejoins",  # previously dead ranks whose contribution reconciled on rejoin
    "fleet_heartbeats",  # member-host lease renewals seen by the fleet controller
    "lease_expiries",  # host leases that ran past dead_after (suspect -> dead transitions)
    "host_failovers",  # dead hosts whose tenants survivors adopted (snapshot + journal tail)
    "tenant_migrations",  # tenants moved host-to-host by the committed migrate protocol
    "migration_us",  # wall-clock spent inside committed migrations (drain -> cutover)
    "flightrec_dumps",  # postmortem artifacts the flight recorder dumped (observability plane)
    "history_folds",  # telemetry-history blocks closed/telescoped (timeseries plane)
    "burn_alerts",  # multi-window burn-rate pages (both short AND long window burned)
)


def _tenants_per_dispatch(counts: Mapping[str, int]) -> float:
    """Derived headline of the serving engine: real tenant rows served per
    megabatched dispatch. One python dispatch per tenant reads 1.0; the
    stacked/vmapped plane reads close to the megabatch size — the direct
    observable of one-compile-many-tenants amortization (0.0 before any
    serving dispatch ran)."""
    dispatches = int(counts.get("serve_dispatches", 0))
    if not dispatches:
        return 0.0
    return round(int(counts.get("serve_tenant_rows", 0)) / dispatches, 3)


def _collectives_per_sync(counts: Mapping[str, int]) -> float:
    """Derived headline of the coalesced sync plane: collectives launched per
    ``process_sync``/collection sync. K·L per-leaf collectives collapse to
    1 metadata gather + one per dtype bucket — this ratio is the direct
    observable of that reduction (0.0 before any sync ran)."""
    syncs = int(counts.get("sync_calls", 0))
    if not syncs:
        return 0.0
    return round(int(counts.get("sync_collectives", 0)) / syncs, 3)


@dataclasses.dataclass(frozen=True)
class CountersSnapshot:
    """Immutable point-in-time view of a :class:`Counters` registry.

    ``costs`` is the per-key compiled-cost map (``observability/costs.py``) as
    of the snapshot — empty when no cost registry is attached (standalone
    counters, cost accounting disabled).
    """

    counts: Dict[str, int]
    per_key: Dict[str, Dict[str, Any]]
    costs: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    def __getitem__(self, name: str) -> int:
        return self.counts[name]

    def diff(self, earlier: "CountersSnapshot") -> "CountersSnapshot":
        """This snapshot minus an ``earlier`` one (per-key signatures and cost
        entries: only the ones that appeared in between)."""
        counts = {k: v - earlier.counts.get(k, 0) for k, v in self.counts.items()}
        per_key: Dict[str, Dict[str, Any]] = {}
        for key, rec in self.per_key.items():
            old = earlier.per_key.get(key, {})
            old_sigs = set(old.get("signatures", ()))
            old_counts = old.get("sig_counts", {})
            delta = {
                "compiles": rec["compiles"] - old.get("compiles", 0),
                "cache_hits": rec["cache_hits"] - old.get("cache_hits", 0),
                "aot_hits": rec.get("aot_hits", 0) - old.get("aot_hits", 0),
                "signatures": [s for s in rec["signatures"] if s not in old_sigs],
                "sig_counts": {
                    s: n - old_counts.get(s, 0)
                    for s, n in rec.get("sig_counts", {}).items()
                    if n - old_counts.get(s, 0)
                },
            }
            if delta["compiles"] or delta["cache_hits"] or delta["aot_hits"] or delta["signatures"]:
                per_key[key] = delta
        costs = {}
        for key, sigs in self.costs.items():
            old_sigs = set(earlier.costs.get(key, {}))
            fresh = {s: rec for s, rec in sigs.items() if s not in old_sigs}
            if fresh:
                costs[key] = fresh
        return CountersSnapshot(counts=counts, per_key=per_key, costs=costs)

    def summary(self, brief: bool = False) -> Dict[str, Any]:
        """Flat JSON-friendly dict. ``brief`` keeps only the headline counters
        (the shape bench configs embed next to ``attempts``/``recovered_from``)."""
        if brief:
            keys = (
                "dispatches", "jit_compiles", "jit_cache_hits", "retraces",
                "host_dispatches", "d2h_readbacks", "sync_calls",
                "gathers_coalesced", "serve_dispatches",
            )
            out = {k: self.counts[k] for k in keys}
            out["collectives_per_sync"] = _collectives_per_sync(self.counts)
            out["tenants_per_dispatch"] = _tenants_per_dispatch(self.counts)
            return out
        out: Dict[str, Any] = dict(self.counts)
        out["collectives_per_sync"] = _collectives_per_sync(self.counts)
        out["tenants_per_dispatch"] = _tenants_per_dispatch(self.counts)
        out["per_key"] = {
            k: {"compiles": v["compiles"], "cache_hits": v["cache_hits"],
                "aot_hits": v.get("aot_hits", 0),
                "signatures": list(v["signatures"]),
                "sig_counts": dict(v.get("sig_counts", {}))}
            for k, v in self.per_key.items()
        }
        if self.costs:
            out["costs"] = {k: {s: dict(r) for s, r in v.items()} for k, v in self.costs.items()}
            out["cost_totals"] = self.cost_totals()
        return out

    def cost_totals(self) -> Dict[str, Any]:
        """Dispatch-weighted run totals: each program's per-call cost times how
        often its exact ``(key, signature)`` dispatched — the per-program cost
        attribution the compile counters alone cannot give."""
        totals: Dict[str, Any] = {
            "run_flops": 0.0, "run_bytes_accessed": 0.0, "run_transcendentals": 0.0,
            "compiled_programs": 0, "unavailable": 0,
            "peak_argument_bytes": 0, "peak_output_bytes": 0, "peak_temp_bytes": 0,
        }
        for key, sigs in self.costs.items():
            sig_counts = self.per_key.get(key, {}).get("sig_counts", {})
            for sig, rec in sigs.items():
                totals["compiled_programs"] += 1
                if not rec.get("available"):
                    totals["unavailable"] += 1
                    continue
                n = int(sig_counts.get(sig, 0))
                totals["run_flops"] += rec.get("flops", 0.0) * n
                totals["run_bytes_accessed"] += rec.get("bytes_accessed", 0.0) * n
                totals["run_transcendentals"] += rec.get("transcendentals", 0.0) * n
                for peak, field in (
                    ("peak_argument_bytes", "argument_bytes"),
                    ("peak_output_bytes", "output_bytes"),
                    ("peak_temp_bytes", "temp_bytes"),
                ):
                    totals[peak] = max(totals[peak], int(rec.get(field, 0)))
        return totals

    def counts_vector(self) -> List[int]:
        """Counts as an int vector in :data:`COUNTER_FIELDS` order — the
        metadata-only payload the fleet gather plane ships per rank."""
        return [int(self.counts.get(f, 0)) for f in COUNTER_FIELDS]


class Counters:
    """Mutable counters registry (one per telemetry session; thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {f: 0 for f in COUNTER_FIELDS}
        # "ClassName#id.tag" -> {"compiles", "cache_hits", "signatures": [..],
        #                        "sig_counts": {sig: dispatches}}
        self._per_key: Dict[str, Dict[str, Any]] = {}
        # optional costs.CostRegistry — its snapshot rides along in snapshot()
        self._costs: Optional[Any] = None

    def attach_costs(self, registry: Any) -> None:
        """Fold a ``costs.CostRegistry``'s snapshots into this registry's
        (the recorder attaches its per-session registry here)."""
        self._costs = registry

    # -------------------------------------------------------------- recording

    def record_dispatch(self, key: str, signature: str, aot_loaded: bool = False) -> Tuple[bool, int]:
        """One successful jitted dispatch under ``key`` with the given input
        ``signature``. Returns ``(is_new_signature, n_compiles_for_key)`` —
        the second element counts the key's actual COMPILES (not distinct
        signatures), which is what the retrace event/sentinel key off.

        ``aot_loaded`` marks a dispatch served by a deserialized executable
        from the AOT cache: a FIRST-seen signature then counts as an
        ``aot_cache_hit`` instead of a compile (and never as a retrace —
        nothing recompiled), keeping ``jit_compiles + jit_cache_hits +
        aot_cache_hits == dispatches`` an exact identity. Repeat signatures
        count as ``jit_cache_hits`` either way: they are served by an
        in-memory program, whichever plane first materialized it. With no AOT
        activity, compiles == distinct signatures, so the return is exactly
        what it always was.
        """
        with self._lock:
            rec = self._per_key.setdefault(
                # "signatures" keeps first-seen order for reports; "_sig_set" is
                # the O(1) membership twin — a retrace storm (the pathology this
                # counter diagnoses) must not make its own bookkeeping O(n)
                key, {"compiles": 0, "cache_hits": 0, "aot_hits": 0, "signatures": [],
                      "_sig_set": set(), "sig_counts": {}}
            )
            self._counts["dispatches"] += 1
            rec["sig_counts"][signature] = rec["sig_counts"].get(signature, 0) + 1
            if signature in rec["_sig_set"]:
                rec["cache_hits"] += 1
                self._counts["jit_cache_hits"] += 1
                return False, rec["compiles"]
            rec["signatures"].append(signature)
            rec["_sig_set"].add(signature)
            if aot_loaded:
                rec["aot_hits"] += 1
                self._counts["aot_cache_hits"] += 1
            else:
                rec["compiles"] += 1
                self._counts["jit_compiles"] += 1
                # a retrace is a recompile beyond the key's first COMPILE —
                # signatures served by the AOT cache never recompiled anything
                if rec["compiles"] > 1:
                    self._counts["retraces"] += 1
            return True, rec["compiles"]

    def record_aot_miss(self) -> None:
        """The AOT plane probed the disk cache for a first-seen signature and
        found nothing usable (absent, stale-keyed, or corrupt — all misses)."""
        with self._lock:
            self._counts["aot_cache_misses"] += 1

    def record_aot_deserialize(self, duration_s: float) -> None:
        """Wall-clock of one executable load (microseconds, accumulated like
        ``sync_time_us``)."""
        with self._lock:
            self._counts["aot_deserialize_us"] += max(0, int(duration_s * 1e6))

    def has_signature(self, key: str, signature: str) -> bool:
        """Whether ``(key, signature)`` has already been counted (the recorder
        peeks this to harvest a fresh program's cost BEFORE the compile counter
        ticks — see :meth:`snapshot` for why the ordering matters)."""
        with self._lock:
            rec = self._per_key.get(key)
            return rec is not None and signature in rec["_sig_set"]

    def record_host_dispatch(self) -> None:
        with self._lock:
            self._counts["host_dispatches"] += 1

    def record_compute(self) -> None:
        with self._lock:
            self._counts["computes"] += 1

    def record_d2h(self, nbytes: int) -> None:
        with self._lock:
            self._counts["d2h_readbacks"] += 1
            self._counts["d2h_bytes"] += int(nbytes)

    def record_sync(self, payload_bytes: int) -> None:
        with self._lock:
            self._counts["sync_calls"] += 1
            self._counts["sync_payload_bytes"] += int(payload_bytes)

    def record_sync_time(self, duration_s: float) -> None:
        """Wall-clock of one ``Metric.sync`` (microseconds; the fleet rollup
        turns per-rank totals into straggler min/max skew)."""
        with self._lock:
            self._counts["sync_time_us"] += max(0, int(duration_s * 1e6))

    def record_gather(self) -> None:
        with self._lock:
            self._counts["gather_calls"] += 1

    def record_coalesced(self, n_leaves: int) -> None:
        """``n_leaves`` state leaves rode a coalesced bucket (no per-leaf
        collective of their own)."""
        with self._lock:
            self._counts["gathers_coalesced"] += int(n_leaves)

    def record_sync_collectives(self, n: int) -> None:
        """``n`` collectives launched by a sync plane (coalesced: metadata +
        one per bucket; per-leaf fallback: one per leaf)."""
        with self._lock:
            self._counts["sync_collectives"] += int(n)

    def record_quant(self, buckets: int, bytes_saved: int) -> None:
        """One quantized coalesced sync: ``buckets`` dtype buckets shipped as
        compressed byte streams, saving ``bytes_saved`` wire bytes vs the
        exact plane (payload minus the scale metadata that rode the metadata
        collective; clamped at zero — a pathological all-tiny-leaf sync could
        cost more in scales than it saves, which the eligibility floor
        normally prevents)."""
        with self._lock:
            self._counts["quantized_buckets"] += int(buckets)
            self._counts["sync_bytes_saved"] += max(0, int(bytes_saved))

    def record_retry(self) -> None:
        with self._lock:
            self._counts["retries"] += 1

    def record_retry_exhausted(self) -> None:
        with self._lock:
            self._counts["retries_exhausted"] += 1

    def record_quarantine(self, status: str) -> None:
        with self._lock:
            self._counts["quarantines" if status == "quarantined" else "skips"] += 1

    def record_state_growth(self) -> None:
        with self._lock:
            self._counts["state_growths"] += 1

    def record_serve_dispatch(self, rows: int, padded: int = 0) -> None:
        """One megabatched serving dispatch that updated ``rows`` real tenant
        rows (plus ``padded`` scratch rows keeping the signature fixed)."""
        with self._lock:
            self._counts["serve_dispatches"] += 1
            self._counts["serve_tenant_rows"] += int(rows)
            self._counts["serve_padded_rows"] += int(padded)

    def record_tenant_spill(self, duration_s: float, readmit: bool = False) -> None:
        """One tenant-state spill to host (or, ``readmit=True``, an upload
        back into a stack slot); wall-clock accumulates like ``sync_time_us``."""
        with self._lock:
            self._counts["tenant_readmits" if readmit else "tenant_spills"] += 1
            self._counts["tenant_spill_us"] += max(0, int(duration_s * 1e6))

    def record_alert(self) -> None:
        with self._lock:
            self._counts["alerts"] += 1

    def record_window_roll(self, rotated: bool = False) -> None:
        """One SlidingWindow update (a windowed ``wupdate``/``wdual``/
        ``wstack`` dispatch); ``rotated`` marks a dual block rotation or a
        two-stack pane completion — the hop cadence of the constant-memory
        window tiers."""
        self.record_window_rolls(1, 1 if rotated else 0)

    def record_window_rolls(self, n: int, rotations: int = 0) -> None:
        """Bulk form: ``n`` windowed per-tenant row updates (one vmapped
        ``vwupdate`` megabatch advances many tenant windows at once), of
        which ``rotations`` completed a block/pane."""
        with self._lock:
            self._counts["window_rolls"] += int(n)
            self._counts["window_rotations"] += int(rotations)

    def record_async_sync(self, wait_s: float) -> None:
        """One committed double-buffered background sync; ``wait_s`` is how
        long ``commit()`` actually blocked — the part of the sync latency the
        overlap did NOT hide (the gather's full wall-clock still lands in
        ``sync_time_us`` like a blocking sync)."""
        with self._lock:
            self._counts["async_syncs"] += 1
            self._counts["async_sync_wait_us"] += max(0, int(wait_s * 1e6))

    def record_drift(self, breached: bool) -> None:
        """One DriftMonitor evaluation (``breached``: score over threshold)."""
        with self._lock:
            self._counts["drift_evals"] += 1
            if breached:
                self._counts["drift_breaches"] += 1

    def record_serve_rejected(self) -> None:
        """One tenant batch shed by the serving admission rate limit."""
        with self._lock:
            self._counts["serve_rejected"] += 1

    def record_snapshot(self, restore: bool = False) -> None:
        """One crash-consistent engine snapshot written (``restore=True``:
        one engine restored from a generation instead)."""
        with self._lock:
            self._counts["snapshot_restores" if restore else "snapshots"] += 1

    def record_journal_append(self, fsynced: bool) -> None:
        """One batch appended to the write-ahead journal; ``fsynced`` marks
        the appends that closed an fsync batch (stable-storage boundary)."""
        with self._lock:
            self._counts["journal_records"] += 1
            if fsynced:
                self._counts["journal_fsyncs"] += 1

    def record_journal_replay(self, records: int) -> None:
        """``records`` journal entries rolled forward into a restored engine."""
        with self._lock:
            self._counts["replayed_records"] += int(records)

    def record_degraded_sync(self) -> None:
        """One coalesced sync that completed over a survivor quorum because a
        rank presented a dead (all-zero) metadata row."""
        with self._lock:
            self._counts["degraded_syncs"] += 1

    def record_rank_rejoin(self) -> None:
        """One previously dead rank seen alive again — its accumulated state
        folds back in on this very sync (full-state gather, no double count)."""
        with self._lock:
            self._counts["rank_rejoins"] += 1

    def record_fleet_heartbeat(self) -> None:
        """One member-host lease renewal accepted by the fleet controller."""
        with self._lock:
            self._counts["fleet_heartbeats"] += 1

    def record_lease_expiry(self) -> None:
        """One host lease that ran past its expiry — the suspect → dead
        transition that triggers tenant adoption by the survivors."""
        with self._lock:
            self._counts["lease_expiries"] += 1

    def record_host_failover(self) -> None:
        """One dead host whose tenant roster was adopted by survivors
        (latest snapshot generation + journal-tail replay)."""
        with self._lock:
            self._counts["host_failovers"] += 1

    def record_migration(self, tenants: int, duration_us: int) -> None:
        """One committed host-to-host migration: ``tenants`` moved, with the
        wall-clock the drain → cutover protocol took."""
        with self._lock:
            self._counts["tenant_migrations"] += int(tenants)
            self._counts["migration_us"] += int(duration_us)

    def record_flightrec_dump(self) -> None:
        """One postmortem artifact dumped by the flight recorder (auto-trigger
        or explicit ``dump()``)."""
        with self._lock:
            self._counts["flightrec_dumps"] += 1

    def record_history_folds(self, folds: int = 1) -> None:
        """``folds`` telemetry-history blocks closed (each fold telescopes a
        fine block into the coarser level above it)."""
        with self._lock:
            self._counts["history_folds"] += int(folds)

    def record_burn_alert(self) -> None:
        """One multi-window burn-rate page: a ``burn(expr, short, long)`` rule
        breached with BOTH windows burning (cooldown-gated, like alerts)."""
        with self._lock:
            self._counts["burn_alerts"] += 1

    # --------------------------------------------------------------- querying

    def value(self, name: str) -> int:
        with self._lock:
            return self._counts[name]

    def counts_vector(self) -> List[int]:
        """Counts in :data:`COUNTER_FIELDS` order without the full snapshot
        copy — the sync-latency path ships this on every coalesced sync, so it
        must not pay the per-key/costs deep copies ``snapshot()`` does."""
        with self._lock:
            return [int(self._counts.get(f, 0)) for f in COUNTER_FIELDS]

    def signatures(self, key: str) -> List[str]:
        with self._lock:
            rec = self._per_key.get(key)
            return list(rec["signatures"]) if rec else []

    def keys_for(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        """Per-key records whose key starts with ``prefix`` (instance lookup:
        keys are ``ClassName#id.tag``, so ``ClassName#id.`` selects one metric)."""
        with self._lock:
            return {
                k: {"compiles": v["compiles"], "cache_hits": v["cache_hits"],
                    "aot_hits": v.get("aot_hits", 0),
                    "signatures": list(v["signatures"]),
                    "sig_counts": dict(v["sig_counts"])}
                for k, v in self._per_key.items()
                if k.startswith(prefix)
            }

    def snapshot(self) -> CountersSnapshot:
        with self._lock:
            counts = dict(self._counts)
            per_key = {
                k: {"compiles": v["compiles"], "cache_hits": v["cache_hits"],
                    "aot_hits": v.get("aot_hits", 0),
                    "signatures": list(v["signatures"]),
                    "sig_counts": dict(v["sig_counts"])}
                for k, v in self._per_key.items()
            }
        # Cost registry read AFTER the counts, then trimmed to the counted
        # signatures. The recorder harvests a fresh program's cost BEFORE
        # ticking its compile counter, so every signature visible in per_key
        # already has its cost entry by the time the counts were copied —
        # a concurrent snapshot can never catch a compile without its cost
        # (the 1:1 reconciliation invariant); entries harvested after the
        # counts copy are dropped from THIS snapshot, not lost.
        costs: Dict[str, Dict[str, Any]] = {}
        if self._costs is not None:
            for key, sigs in self._costs.snapshot().items():
                counted = set(per_key.get(key, {}).get("signatures", ()))
                kept = {s: r for s, r in sigs.items() if s in counted}
                if kept:
                    costs[key] = kept
        return CountersSnapshot(counts=counts, per_key=per_key, costs=costs)

    def reset(self) -> None:
        with self._lock:
            self._counts = {f: 0 for f in COUNTER_FIELDS}
            self._per_key = {}
        if self._costs is not None:
            self._costs.reset()


# ---------------------------------------------------------------------------
# fleet aggregation (pure merge; the gather plane lives in parallel/sync.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetSnapshot:
    """Pod-wide counter rollup: N per-rank snapshots merged into one view.

    ``totals`` is the exact fieldwise sum of the per-rank counts; ``per_key``
    is the union of per-rank dispatch records (available only when full
    snapshots were aggregated — the cross-host gather ships counts vectors
    only, metadata-sized); ``stragglers`` attributes sync-time skew to ranks.
    """

    per_rank: Tuple[Dict[str, int], ...]
    totals: Dict[str, int]
    per_key: Dict[str, Dict[str, Any]]
    stragglers: Dict[str, Any]

    @property
    def ranks(self) -> int:
        return len(self.per_rank)

    def __getitem__(self, name: str) -> int:
        return self.totals[name]

    def summary(self, brief: bool = False) -> Dict[str, Any]:
        if brief:
            keys = (
                "dispatches", "jit_compiles", "jit_cache_hits", "retraces",
                "host_dispatches", "d2h_readbacks", "sync_calls",
                "gathers_coalesced", "serve_dispatches",
            )
            return {
                "fleet": True, "ranks": self.ranks,
                **{k: self.totals[k] for k in keys},
                "collectives_per_sync": _collectives_per_sync(self.totals),
                "tenants_per_dispatch": _tenants_per_dispatch(self.totals),
                "stragglers": dict(self.stragglers),
            }
        return {
            "fleet": True,
            "ranks": self.ranks,
            "totals": dict(self.totals),
            "per_rank": [dict(r) for r in self.per_rank],
            "per_key": {k: dict(v) for k, v in self.per_key.items()},
            "stragglers": dict(self.stragglers),
        }


def _rank_counts(snap: Union["CountersSnapshot", Mapping[str, int], Sequence[int]]) -> Dict[str, int]:
    """Normalize one rank's contribution: a full snapshot, a counts mapping, or
    the bare counts vector the gather plane ships."""
    if isinstance(snap, CountersSnapshot):
        return {f: int(snap.counts.get(f, 0)) for f in COUNTER_FIELDS}
    if isinstance(snap, Mapping):
        return {f: int(snap.get(f, 0)) for f in COUNTER_FIELDS}
    values = list(snap)
    if len(values) != len(COUNTER_FIELDS):
        raise ValueError(
            f"counts vector has {len(values)} entries, expected {len(COUNTER_FIELDS)} "
            f"({', '.join(COUNTER_FIELDS)})"
        )
    return {f: int(v) for f, v in zip(COUNTER_FIELDS, values)}


def _skew(per_rank: Sequence[Dict[str, int]], field: str) -> Dict[str, int]:
    values = [r[field] for r in per_rank]
    lo, hi = min(values), max(values)
    return {
        "min": lo, "max": hi, "skew": hi - lo,
        "min_rank": values.index(lo), "max_rank": values.index(hi),
    }


def aggregate_counters(
    snapshots: Sequence[Union["CountersSnapshot", Mapping[str, int], Sequence[int]]],
) -> FleetSnapshot:
    """Merge per-rank counter snapshots into one fleet view (pure, stdlib).

    ``totals`` equals the exact fieldwise sum of the inputs — the invariant the
    acceptance test pins — and ``stragglers`` carries per-rank min/max skew for
    the sync-time and sync-call fields (the rank holding the max sync time is
    the pod's straggler candidate). Accepts full :class:`CountersSnapshot`
    objects (simulated ranks, tests), plain counts mappings, or the raw counts
    vectors the gather plane returns.
    """
    if not snapshots:
        raise ValueError("aggregate_counters needs at least one rank snapshot")
    per_rank = tuple(_rank_counts(s) for s in snapshots)
    totals = {f: sum(r[f] for r in per_rank) for f in COUNTER_FIELDS}
    per_key: Dict[str, Dict[str, Any]] = {}
    for snap in snapshots:
        if not isinstance(snap, CountersSnapshot):
            continue
        for key, rec in snap.per_key.items():
            merged = per_key.setdefault(
                key, {"compiles": 0, "cache_hits": 0, "aot_hits": 0, "signatures": [], "sig_counts": {}}
            )
            merged["compiles"] += rec["compiles"]
            merged["cache_hits"] += rec["cache_hits"]
            merged["aot_hits"] += rec.get("aot_hits", 0)
            for sig in rec["signatures"]:
                if sig not in merged["signatures"]:
                    merged["signatures"].append(sig)
            for sig, n in rec.get("sig_counts", {}).items():
                merged["sig_counts"][sig] = merged["sig_counts"].get(sig, 0) + n
    stragglers = {
        "sync_time_us": _skew(per_rank, "sync_time_us"),
        "sync_calls": _skew(per_rank, "sync_calls"),
    }
    return FleetSnapshot(per_rank=per_rank, totals=totals, per_key=per_key, stragglers=stragglers)
