"""The production soak: every plane, one run, verdicts attached (counterpart of
``torchmetrics_tpu/chaos/soak.py``).

``run_soak`` drives a :class:`~torchmetrics_tpu_torch.serving.ServingEngine`
(quarantine mode, LRU spill with an optional codec, token-bucket admission
on a VIRTUAL clock, optional per-tenant windows, optional AOT self-warming)
plus :class:`~torchmetrics_tpu_torch.streaming.SlidingWindow` /
:class:`~torchmetrics_tpu_torch.streaming.DriftMonitor` side-channels through one
seeded :class:`~torchmetrics_tpu_torch.chaos.TrafficModel`, arming a
:class:`~torchmetrics_tpu_torch.chaos.FaultSchedule` at exact steps, inside one
telemetry session whose SLO engine (``default_rules()`` + :func:`soak_rules`)
renders verdicts each sync epoch.

Determinism contract: the ``SoakReport.counters`` block — admission/shed,
engine stats (minus wall-clock nanoseconds), and the fault ledger
(injected/recovered/quarantined/unrecovered) — is a pure function of
``(SoakConfig, seed, fault schedule)``. Admission runs on a virtual clock
advancing ``seconds_per_step`` per traffic step (``ServingConfig(clock=)``),
so even shed counts replay exactly. Latency percentiles and SLO breach
timing ride real wall-clock and live in the non-contractual ``timing`` /
``slo_breaches`` blocks.

Fault accounting (``docs/chaos.md`` has the full table):

- *recovered* — the plane absorbed the fault and service continued:
  transient megabatch raises re-driven clean, poisons caught by
  ``validate_state`` and reset, flaky gathers retried home, clock skews
  admitting again;
- *quarantined* — the engine CONTAINED a deterministic per-tenant fault by
  quarantining exactly the offender (the designed blast radius, not a
  failure of recovery);
- *unrecovered* — anything that escaped: an exception out of the serve
  loop, a sync that exhausted its retry budget, corruption detected with no
  armed poison, a skew still shedding at run end. A healthy soak reports
  **zero**, and the ``production_soak`` bench gate pins that.

The soak builds its metrics itself, so :func:`run_soak` and :func:`run_fleet_soak` take
``device=``: the card when ``None`` (raising without CUDA), ``"cpu"`` explicitly. Traffic
batches stay numpy on the host, as the JAX engine receives them; the engine uploads them
a megabatch at a time. The device is kept out of ``SoakReport.counters``, ``history``
and ``config``, so a run on the card and one on the CPU compare block for block.

Each sync epoch runs inside a ``torch.profiler`` range named ``SYNC_EPOCH_RANGE``, so a
profiler around a soak can read one epoch of it; the fleet soak's ``timing`` carries
``failover_rto_ms``, the wall time of the lease polls that failed a host over.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import observability as _observability
from ..observability import spans as _spans
from ..observability import tracing as _tracing
from ..classification import MulticlassAccuracy
from ..observability.slo import SloRule, default_rules
from ..parallel import SyncConfig
from ..parallel import coalesce as _coalesce
from ..reliability import (
    DeadRank,
    FlakyGather,
    ReliabilityConfig,
    RetryPolicy,
    make_transient_error,
    poison_state_leaf,
    validate_state,
)
from ..serving import ServingConfig, ServingEngine, TrafficJournal
from ..streaming import DriftMonitor, SlidingWindow
from ..utilities.checks import resolve_device
from ..utilities.exceptions import StateCorruptionError, TorchMetricsUserError
from .schedule import FAULT_KINDS, FaultSchedule, FaultSpec, default_fault_schedule
from .traffic import TrafficConfig, TrafficModel

SYNC_EPOCH_RANGE = "soak.sync_epoch"  # the profiler range of one sync epoch


@dataclasses.dataclass(frozen=True)
class SoakConfig:
    """One soak run, fully specified (defaults are CPU-test sized).

    Args:
        traffic: the seeded load (ignored when ``run_soak`` is handed a
            replayed :class:`TrafficModel` directly).
        faults: the schedule; ``None`` arms :func:`default_fault_schedule`
            over the traffic's step count.
        capacity / megabatch_size / spill_codec / window /
        max_tenants_per_sec / aot_cache_dir: forwarded into
            :class:`~torchmetrics_tpu_torch.serving.ServingConfig` (quarantine
            mode and spill are always on — the soak exists to exercise
            them).
        seconds_per_step: virtual seconds the admission clock advances per
            traffic step.
        sync_every: sync-epoch cadence in steps — each epoch validates the
            witness, syncs it through the (possibly flaky) gather, commits
            the engine's async stacked sync (or ``compute_all`` on windowed
            engines), and evaluates the SLO rules.
        sync_codec: ``None`` syncs exact; else a
            :class:`~torchmetrics_tpu_torch.parallel.SyncConfig` codec name for
            quantize-on-sync (one config instance lives across the run, so
            error-feedback residuals fold correctly).
        side_channel_every: update the SlidingWindow/DriftMonitor side
            channels every Nth event (they dispatch per update — this keeps
            the CPU soak fast without changing the engine path).
        drift_reference / drift_test: DriftMonitor window geometry.
        shed_rate_max: threshold for the ``soak_shed_rate`` SLO rule.
        retry_attempts: witness sync retry budget (the ``gather_flaky`` /
            ``coordination_outage`` recovery headroom).
        durability_dir: root directory for the durability plane — the
            engine's write-ahead journal lives in ``<dir>/journal`` and
            crash-consistent snapshots in ``<dir>/snapshots``. Required
            when ``snapshot_every`` or ``failover_at`` is set.
        snapshot_every: snapshot the engine every N traffic steps (the
            standby's restore point).
        failover_at: at this step the primary engine is KILLED and a cold
            standby takes over: restore the latest snapshot, replay the
            journal tail against the retained batches, and verify bitwise
            state parity against the pre-kill primary. ``timing`` gains
            ``failover_rto_ms``; ``counters`` gain the replay/parity block.
        journal_fsync_every: fsync cadence of the write-ahead journal
            (1 = every record, the RPO=0 setting the parity gate assumes).
        retain_snapshots: keep only the newest N snapshot generations per
            engine (``ServingConfig.retain_snapshots``) — journal segments
            every retained snapshot covers are pruned with them. ``None``
            retains everything (unbounded growth under ``snapshot_every``).
        fleet_hosts: run the FLEET soak (:func:`run_fleet_soak`) over this
            many member hosts behind one :class:`FleetController` instead
            of a single engine. Fleet mode admits unlimited (the per-tenant
            parity gate compares against an uninterrupted single-host
            reference, so admission must not fork) and arms only the
            ``host_loss`` / ``host_join`` fault kinds.
        fleet_suspect_after / fleet_dead_after: lease thresholds in virtual
            seconds (suspect keeps its tenants — the flap window; dead
            triggers adoption). Heartbeats renew every traffic step.
    """

    traffic: TrafficConfig = dataclasses.field(default_factory=TrafficConfig)
    faults: Optional[FaultSchedule] = None
    capacity: int = 16
    megabatch_size: int = 4
    spill_codec: str = "none"
    window: Optional[int] = None
    max_tenants_per_sec: Optional[float] = 40.0
    aot_cache_dir: Optional[str] = None
    seconds_per_step: float = 0.25
    sync_every: int = 20
    sync_codec: Optional[str] = None
    side_channel_every: int = 4
    drift_reference: int = 48
    drift_test: int = 16
    shed_rate_max: float = 0.5
    retry_attempts: int = 5
    durability_dir: Optional[str] = None
    snapshot_every: Optional[int] = None
    failover_at: Optional[int] = None
    journal_fsync_every: int = 1
    retain_snapshots: Optional[int] = None
    fleet_hosts: Optional[int] = None
    fleet_suspect_after: float = 0.75
    fleet_dead_after: float = 1.5

    def __post_init__(self) -> None:
        if self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {self.sync_every}")
        if self.snapshot_every is not None and self.snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got {self.snapshot_every}")
        if self.failover_at is not None and self.failover_at < 1:
            raise ValueError(f"failover_at must be >= 1, got {self.failover_at}")
        if (self.snapshot_every is not None or self.failover_at is not None) and not self.durability_dir:
            raise ValueError("snapshot_every/failover_at need durability_dir")
        if self.journal_fsync_every < 1:
            raise ValueError(f"journal_fsync_every must be >= 1, got {self.journal_fsync_every}")
        if self.seconds_per_step <= 0:
            raise ValueError(f"seconds_per_step must be > 0, got {self.seconds_per_step}")
        if self.side_channel_every < 1:
            raise ValueError(f"side_channel_every must be >= 1, got {self.side_channel_every}")
        if not 0.0 < self.shed_rate_max <= 1.0:
            raise ValueError(f"shed_rate_max must be in (0, 1], got {self.shed_rate_max}")
        if self.retry_attempts < 1:
            raise ValueError(f"retry_attempts must be >= 1, got {self.retry_attempts}")
        if self.retain_snapshots is not None and self.retain_snapshots < 1:
            raise ValueError(f"retain_snapshots must be >= 1, got {self.retain_snapshots}")
        if self.fleet_hosts is not None:
            if self.fleet_hosts < 2:
                raise ValueError(
                    f"fleet_hosts must be >= 2 (a fleet of one cannot fail over), "
                    f"got {self.fleet_hosts}"
                )
            if not self.durability_dir:
                raise ValueError("fleet_hosts needs durability_dir (per-host journals/snapshots)")
        if not self.fleet_dead_after > self.fleet_suspect_after > 0:
            raise ValueError(
                f"need fleet_dead_after > fleet_suspect_after > 0, got "
                f"{self.fleet_dead_after} / {self.fleet_suspect_after}"
            )


def soak_rules(
    shed_rate_max: float = 0.5,
    drift_threshold: float = 0.75,
) -> Tuple[SloRule, ...]:
    """Soak-specific SLO rules layered on ``default_rules()``: overload shed
    rate, any quarantine in the window, and sustained side-channel drift."""
    return (
        SloRule(
            name="soak_shed_rate",
            expr=(
                "serve_rejected >= 3 and "
                f"serve_rejected / max(serve_tenant_rows + serve_rejected, 1) > {shed_rate_max}"
            ),
            window=120.0,
            severity="critical",
            description="admission shedding more than the overload budget",
        ),
        SloRule(
            name="soak_quarantine",
            expr="quarantines > 0",
            window=120.0,
            severity="warning",
            description="a tenant was quarantined this window (contained deterministic fault)",
        ),
        SloRule(
            name="soak_drift",
            expr=f"drift('soak') > {drift_threshold}",
            window=240.0,
            severity="warning",
            description="side-channel stream drifted past the soak threshold",
        ),
    )


@dataclasses.dataclass
class SoakReport:
    """Structured soak verdict. ``counters`` is the deterministic block (the
    replay/determinism contract); ``timing`` and ``slo_breaches`` carry
    wall-clock observations; ``faults`` is the per-spec ledger;
    ``reconciliation`` is the health-plane identity
    ``jit_compiles + jit_cache_hits + aot_cache_hits == dispatches``."""

    counters: Dict[str, Any]
    timing: Dict[str, float]
    faults: List[Dict[str, Any]]
    slo_breaches: List[Dict[str, Any]]
    reconciliation: Dict[str, Any]
    config: Dict[str, Any]
    # the fleet control tower rollup (FleetController.telemetry()) captured
    # just before teardown — fleet soaks only; carries wall-clock latency
    # summaries, so it lives OUTSIDE the counters determinism contract
    fleet_telemetry: Optional[Dict[str, Any]] = None
    # the telemetry history's deterministic export (recorder.history_block()):
    # retained level boundaries keyed by the soak's virtual clock, so two
    # same-seed runs carry byte-identical blocks — INSIDE the determinism
    # contract, same standing as ``counters`` (pinned by test and bench)
    history: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        c = self.counters
        return (
            f"soak seed={self.config.get('seed')}: {c['events']} events, "
            f"{c['admitted']} admitted, {c['shed']} shed "
            f"(rate {c['shed_rate']:.3f}); faults injected={c['faults_injected']} "
            f"recovered={c['recovered_faults']} quarantined={c['quarantined_faults']} "
            f"unrecovered={c['unrecovered_faults']}; "
            f"reconciliation={'OK' if self.reconciliation['exact'] else 'BROKEN'}"
        )


class _ChaosHook:
    """Multiplexing ``ServingEngine._fault_hook``: one seam, two behaviors.

    Transient faults fire only on MEGABATCH dispatches (``len > 1``) so the
    quarantine path's single-tenant re-drives always pass — a transient by
    definition does not reproduce. Tenant faults fire whenever the target is
    present, re-drive included, so exactly that tenant quarantines; the hook
    disarms on the single-entry raise (the raise that quarantines)."""

    def __init__(self) -> None:
        self.transient_left = 0
        self.transient_raised = 0
        self.tenant_targets: set = set()
        self.tenant_raised = 0
        self.tenant_contained = 0

    def __call__(self, tenant_ids: List[Any]) -> None:
        tids = [int(t) for t in tenant_ids]
        armed = [t for t in tids if t in self.tenant_targets]
        if armed:
            self.tenant_raised += 1
            if len(tids) == 1:
                # the re-drive raise: the engine quarantines this tenant next
                self.tenant_targets.discard(tids[0])
                self.tenant_contained += 1
            raise RuntimeError(
                f"chaos: deterministic fault pinned to tenant {armed[0]}"
            )
        if self.transient_left > 0 and len(tids) > 1:
            self.transient_left -= 1
            self.transient_raised += 1
            raise make_transient_error()


class _WitnessGather:
    """World-of-one gather for the witness sync, with the schedule's
    collective faults layered over it:

    - ``arm(n)`` — a ``FlakyGather`` drops a participant on the next ``n``
      calls (``gather_flaky``);
    - ``arm_outage(n)`` — a second ``FlakyGather`` raises an UNAVAILABLE
      coordination-service error on the next ``n`` calls
      (``coordination_outage``);
    - ``arm_dead_rank()`` — every collective runs through a
      :class:`~torchmetrics_tpu_torch.reliability.DeadRank` world-of-two whose
      peer rank is tombstoned until :meth:`revive_rank` — the coalesced
      plane's degraded-quorum path, not a raise.

    Layering order on a call: flaky raise, then outage raise, then the
    (possibly dead-rank-widened) collective.
    """

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._flaky: Optional[FlakyGather] = None
        self._outage: Optional[FlakyGather] = None
        self._dead: Optional[DeadRank] = None

    def base(self, value: Any, group: Any = None) -> List[Any]:
        return [torch.as_tensor(value, device=self.device)]

    def _inner(self, value: Any, group: Any = None) -> List[Any]:
        if self._dead is not None:
            return self._dead(value, group)
        return self.base(value, group)

    def arm(self, fail_times: int) -> None:
        self._flaky = FlakyGather(inner=self._inner, fail_times=fail_times)

    @property
    def armed_failures(self) -> int:
        return self._flaky.failures if self._flaky is not None else 0

    def disarm(self) -> None:
        self._flaky = None

    def arm_outage(self, fail_times: int) -> None:
        self._outage = FlakyGather(
            inner=self._inner,
            fail_times=fail_times,
            exc_factory=lambda: make_transient_error(
                "UNAVAILABLE: coordination service unreachable during collective setup"
            ),
        )

    @property
    def outage_failures(self) -> int:
        return self._outage.failures if self._outage is not None else 0

    def disarm_outage(self) -> None:
        self._outage = None

    def arm_dead_rank(self) -> None:
        self._dead = DeadRank(inner=self.base, world=2, rank=1)

    def revive_rank(self) -> None:
        if self._dead is not None:
            self._dead.revive()

    def disarm_dead_rank(self) -> None:
        self._dead = None

    def __call__(self, value: Any, group: Any = None) -> List[Any]:
        if self._flaky is not None and self._flaky.failures < self._flaky.fail_times:
            return self._flaky(value, group)  # raises (participant drop)
        if self._outage is not None and self._outage.failures < self._outage.fail_times:
            return self._outage(value, group)  # raises (coordination outage)
        return self._inner(value, group)


def _metric(
    num_classes: int, device: torch.device, reliability: Optional[ReliabilityConfig] = None,
) -> MulticlassAccuracy:
    return MulticlassAccuracy(
        num_classes=num_classes, average="micro", validate_args=False,
        reliability=reliability, device=device,
    )


def _engine_digest(engine: ServingEngine) -> str:
    """Canonical digest of the whole engine's tenant state — id, quarantine
    flag, update count, and every state leaf's exact bytes, in sorted tenant
    order. Two engines with equal digests are bitwise-identical as far as
    any tenant read can tell; the failover parity gate compares these. The
    rows come to the host once (one copy a leaf a shape class)."""
    from ..fleet.controller import _tenant_host_states

    h = hashlib.sha256()
    roster = engine.tenants()
    states = _tenant_host_states(engine, [tid for tid, info in roster.items() if not info["quarantined"]])
    for tid in sorted(roster, key=repr):
        info = roster[tid]
        h.update(f"{tid!r}|{info['quarantined']}|{info['update_count']}".encode("utf-8"))
        if info["quarantined"]:
            continue  # a quarantined tenant's state is frozen garbage by contract
        state = states[tid]
        for name in sorted(state):
            if name.startswith("_"):
                continue
            arr = np.asarray(state[name])
            h.update(name.encode("utf-8"))
            h.update(str(arr.dtype).encode("utf-8"))
            h.update(str(arr.shape).encode("utf-8"))
            h.update(arr.tobytes())
    return h.hexdigest()


def run_soak(
    config: Optional[SoakConfig] = None,
    traffic_model: Optional[TrafficModel] = None,
    *,
    device: Any = None,
) -> SoakReport:
    """Run one soak; see the module docstring for the contract. Pass
    ``traffic_model`` (e.g. :meth:`TrafficModel.load_trace`) to replay a
    recorded stream instead of simulating ``config.traffic``. ``device`` is
    where the soak's metrics and the engine's stacks live (the card when
    ``None``; ``"cpu"`` explicitly)."""
    cfg = config if config is not None else SoakConfig()
    if cfg.fleet_hosts is not None:
        return run_fleet_soak(cfg, traffic_model, device=device)
    device = resolve_device(device)
    model = traffic_model if traffic_model is not None else TrafficModel(cfg.traffic)
    traffic = model.config
    faults = cfg.faults if cfg.faults is not None else default_fault_schedule(traffic.steps)
    if faults.last_step >= traffic.steps:
        raise TorchMetricsUserError(
            f"fault schedule reaches step {faults.last_step} but the traffic "
            f"runs only {traffic.steps} steps."
        )
    fleet_kinds = [s.kind for s in faults if s.kind in ("host_loss", "host_join")]
    if fleet_kinds:
        raise TorchMetricsUserError(
            f"{sorted(set(fleet_kinds))} faults need the fleet soak — set "
            "SoakConfig(fleet_hosts=N)"
        )

    _coalesce.clear_dead_ranks()  # liveness ledger is process-global — fresh run, fresh ledger
    journal_dir = os.path.join(cfg.durability_dir, "journal") if cfg.durability_dir else None
    snap_dir = os.path.join(cfg.durability_dir, "snapshots") if cfg.durability_dir else None
    clock = {"t": 0.0}

    def _serving_config() -> ServingConfig:
        return ServingConfig(
            capacity=cfg.capacity,
            megabatch_size=cfg.megabatch_size,
            spill=True,
            spill_codec=cfg.spill_codec,
            on_error="quarantine",
            max_tenants_per_sec=cfg.max_tenants_per_sec,
            clock=lambda: clock["t"],
            window=cfg.window,
            aot_cache_dir=cfg.aot_cache_dir,
            journal=journal_dir,
            journal_fsync_every=cfg.journal_fsync_every,
            retain_snapshots=cfg.retain_snapshots,
        )

    flight = (
        _observability.FlightRecorder(
            dump_dir=os.path.join(cfg.durability_dir, "flightrec"))
        if cfg.durability_dir else None
    )
    engine = ServingEngine(_metric(traffic.num_classes, device), _serving_config())
    hook = _ChaosHook()
    engine._fault_hook = hook
    gather = _WitnessGather(device)
    # the witness: a fleet-level side metric whose sync path carries the
    # gather_flaky/state_poison faults (its retry budget is the recovery)
    witness = _metric(
        traffic.num_classes,
        device,
        reliability=ReliabilityConfig(
            retry=RetryPolicy(
                max_attempts=cfg.retry_attempts, backoff_base=0.0, jitter=0.0,
                sleep_fn=lambda _s: None,
            )
        ),
    )
    sync_cfg = SyncConfig(codec=cfg.sync_codec) if cfg.sync_codec else None
    sliding = SlidingWindow(_metric(traffic.num_classes, device), cfg.drift_test * 2)
    drift = DriftMonitor(
        _metric(traffic.num_classes, device),
        reference_window=cfg.drift_reference,
        test_window=cfg.drift_test,
        threshold=0.75,
        name="soak",
        eval_every=cfg.drift_test,
    )

    # fault ledger: per-spec records resolved as recoveries land (FIFO per kind)
    records: List[Dict[str, Any]] = []
    pending: Dict[str, List[Dict[str, Any]]] = {k: [] for k in FAULT_KINDS}
    recovered = 0
    unrecovered = 0
    skew_pending = 0
    armed_poisons = 0
    # rank_loss staged recovery: N degraded sync epochs, revive, then the
    # rejoin sync reconciles — tracked via the degraded_syncs/rank_rejoins
    # counter deltas each epoch
    dead_epochs_left = 0
    awaiting_rejoin = False
    # retained admitted batches keyed by journal seq — the failover standby's
    # replay source (pruned at every snapshot: covered seqs never replay)
    retained: Dict[int, Tuple[tuple, dict]] = {}
    failover_info: Dict[str, Any] = {}
    epochs = 0
    slo_breaches: List[Dict[str, Any]] = []
    quarantined_tids: set = set()
    known_quarantines = 0
    admitted = 0
    shed = 0
    dropped_quarantined = 0
    events_total = 0

    def _arm(spec: FaultSpec) -> None:
        nonlocal skew_pending, armed_poisons, dead_epochs_left, awaiting_rejoin
        rec = {
            "step": spec.step, "kind": spec.kind, "target": spec.target,
            "count": spec.count, "outcome": "pending",
            "trace_id": _spans.derive_trace_id(
                "fault", traffic.seed, spec.step, spec.kind, spec.target),
        }
        records.append(rec)
        pending[spec.kind].append(rec)
        if spec.kind == "dispatch_transient":
            hook.transient_left += spec.count
        elif spec.kind == "tenant_fault":
            hook.tenant_targets.add(int(spec.target))  # type: ignore[arg-type]
        elif spec.kind == "state_poison":
            poison_state_leaf(witness, spec.target or "tp")
            armed_poisons += 1
        elif spec.kind == "gather_flaky":
            gather.arm(spec.count)
        elif spec.kind == "clock_skew":
            clock["t"] += float(spec.target)  # type: ignore[arg-type]
            skew_pending += 1
        elif spec.kind == "rank_loss":
            gather.arm_dead_rank()
            dead_epochs_left = spec.count
            awaiting_rejoin = False
        elif spec.kind == "coordination_outage":
            gather.arm_outage(spec.count)

    def _resolve(kind: str, outcome: str, n: int = 1) -> None:
        for _ in range(n):
            if pending[kind]:
                pending[kind].pop(0)["outcome"] = outcome

    def _sync_epoch() -> None:
        nonlocal recovered, unrecovered, armed_poisons, epochs
        nonlocal dead_epochs_left, awaiting_rejoin
        with _tracing.trace_span(SYNC_EPOCH_RANGE):  # a profiler's range around one epoch
            epochs += 1
            engine.flush()
            act = _observability._ACTIVE
            deg0 = act.counters.value("degraded_syncs") if act is not None else 0
            rej0 = act.counters.value("rank_rejoins") if act is not None else 0
            # 1. witness integrity: an armed poison MUST be caught here
            try:
                validate_state(witness, context=f"soak epoch {epochs}")
            except StateCorruptionError:
                witness.reset()
                if armed_poisons:
                    recovered += armed_poisons
                    _resolve("state_poison", "recovered", armed_poisons)
                    armed_poisons = 0
                else:
                    unrecovered += 1
                    if flight is not None:
                        flight.dump("state_corruption", extra={"epoch": epochs})
            # 2. witness sync through the (possibly flaky/dead-rank) gather,
            # retry armed
            try:
                witness.sync(
                    dist_sync_fn=gather,
                    distributed_available=lambda: True,
                    sync_config=sync_cfg,
                )
                witness.unsync()
                if gather.armed_failures:
                    recovered += gather.armed_failures
                    _resolve("gather_flaky", "recovered")
                gather.disarm()
                if gather.outage_failures:
                    recovered += gather.outage_failures
                    _resolve("coordination_outage", "recovered")
                gather.disarm_outage()
                # rank_loss staged flow: each degraded epoch ticks the countdown;
                # at zero the rank revives, and the NEXT sync's rejoin resolves it
                if awaiting_rejoin:
                    if act is not None and act.counters.value("rank_rejoins") > rej0:
                        recovered += 1
                        _resolve("rank_loss", "recovered")
                        awaiting_rejoin = False
                        gather.disarm_dead_rank()
                elif dead_epochs_left > 0:
                    if act is not None and act.counters.value("degraded_syncs") > deg0:
                        dead_epochs_left -= 1
                        if dead_epochs_left == 0:
                            gather.revive_rank()
                            awaiting_rejoin = True
            except Exception:  # noqa: BLE001 — an escaped sync is an unrecovered fault
                unrecovered += 1
                _resolve("gather_flaky", "unrecovered")
                _resolve("coordination_outage", "unrecovered")
                gather.disarm()
                gather.disarm_outage()
            # 3. engine read side: async stacked sync (plain engines) or the
            # windowed per-tenant read (sync_async rejects windowed stacks)
            if cfg.window is None:
                engine.sync_async(dist_sync_fn=gather.base, sync_config=sync_cfg).commit()
            else:
                engine.compute_all()
            # 4. SLO verdicts (real-clock windows — informational)
            rec = _observability._ACTIVE
            if rec is not None:
                for alert in rec.evaluate_slos():
                    slo_breaches.append({
                        "epoch": epochs,
                        "rule": alert.get("rule", "?"),
                        "severity": alert.get("severity", "?"),
                    })

    def _refresh_quarantined() -> None:
        nonlocal known_quarantines
        known_quarantines = engine.stats["quarantined"]
        quarantined_tids.clear()
        quarantined_tids.update(
            tid for tid, info in engine.tenants().items() if info["quarantined"]
        )

    def _snapshot() -> None:
        info = engine.snapshot(snap_dir)
        failover_info["snapshots"] = failover_info.get("snapshots", 0) + 1
        failover_info["last_generation"] = info["generation"]
        # everything the snapshot covers never replays — prune the retention
        # buffer so its footprint is one snapshot interval, not the whole run
        cutoff = engine._applied_seq
        for seq in [s for s in retained if s <= cutoff]:
            del retained[seq]

    def _failover() -> None:
        """Kill the primary, bring up a cold standby from the latest snapshot
        plus the journal tail, and verify bitwise state parity."""
        nonlocal engine
        # parity reference: the primary's exact pre-kill state (flush first so
        # queued megabatches land — the journal already holds their admissions)
        engine.flush()
        pre_digest = _engine_digest(engine)
        pre_seq = engine._applied_seq  # the last admission the primary applied
        engine.close()  # the kill point: after the last durable journal write
        # ---- the primary is dead from here on ----
        t_rto = time.perf_counter()
        standby = ServingEngine(_metric(traffic.num_classes, device), _serving_config())
        standby._fault_hook = hook
        if failover_info.get("snapshots"):
            standby.restore(snap_dir)
        # with no snapshot yet the standby replays the journal from scratch
        replayed = standby.replay_journal(
            TrafficJournal.read(journal_dir), lambda r: retained[r.seq],
        )
        standby.flush()
        rto_ms = (time.perf_counter() - t_rto) * 1000.0
        post_digest = _engine_digest(standby)
        engine = standby
        _refresh_quarantined()
        failover_info.update(
            failovers=failover_info.get("failovers", 0) + 1,
            rto_ms=round(rto_ms, 3),
            replayed=replayed,
            # RPO in records: admissions the primary applied that the standby
            # could not reconstruct (0 with fsync-per-record journaling)
            rpo_records=max(0, pre_seq - standby._applied_seq),
            state_parity=1.0 if post_digest == pre_digest else 0.0,
            pre_digest=pre_digest,
            post_digest=post_digest,
        )

    t0 = time.perf_counter()
    with _observability.telemetry_session(
        _observability.TelemetryConfig(
            slo_rules=tuple(default_rules()) + soak_rules(shed_rate_max=cfg.shed_rate_max),
            sinks=(
                (_observability.RingBufferSink(), flight) if flight is not None else ()
            ),
            # history keyed by the soak's virtual clock: same seed ⇒ same
            # block boundaries ⇒ byte-identical SoakReport.history
            history_clock=lambda: clock["t"],
        )
    ) as rec:
        current_step = -1
        for ev in model.events():
            while current_step < ev.step:
                current_step += 1
                clock["t"] += cfg.seconds_per_step
                for spec in faults.due(current_step):
                    _arm(spec)
                if cfg.snapshot_every and current_step and current_step % cfg.snapshot_every == 0:
                    _snapshot()
                if cfg.failover_at is not None and current_step == cfg.failover_at:
                    _failover()
                if current_step and current_step % cfg.sync_every == 0:
                    _sync_epoch()
            events_total += 1
            tid = int(ev.tenant_id)
            if tid in quarantined_tids:
                dropped_quarantined += 1
                continue
            try:
                ok = engine.update(tid, ev.batch[0], ev.batch[1])
            except Exception:  # noqa: BLE001 — an escaped dispatch is unrecovered
                unrecovered += 1
                ok = False
            if ok:
                admitted += 1
                if engine._journal is not None:
                    # the standby's replay source for this journaled admission
                    retained[engine._applied_seq] = ((ev.batch[0], ev.batch[1]), {})
                if skew_pending:
                    # service admitted again after the jump: skew absorbed
                    recovered += skew_pending
                    _resolve("clock_skew", "recovered", skew_pending)
                    skew_pending = 0
            else:
                shed += 1
            if engine.stats["quarantined"] != known_quarantines:
                _refresh_quarantined()
            if ev.index % cfg.side_channel_every == 0:
                witness.update(ev.batch[0], ev.batch[1])
                sliding.update(ev.batch[0], ev.batch[1])
                drift.update(ev.batch[0], ev.batch[1])
        # drain the remaining steps (faults/epochs past the last event)
        while current_step < traffic.steps - 1:
            current_step += 1
            clock["t"] += cfg.seconds_per_step
            for spec in faults.due(current_step):
                _arm(spec)
            if cfg.snapshot_every and current_step and current_step % cfg.snapshot_every == 0:
                _snapshot()
            if cfg.failover_at is not None and current_step == cfg.failover_at:
                _failover()
            if current_step and current_step % cfg.sync_every == 0:
                _sync_epoch()
        _sync_epoch()  # the closing epoch: catches late poisons/flaky syncs
        elapsed = time.perf_counter() - t0

        # ledger close-out
        if skew_pending:
            unrecovered += skew_pending
            _resolve("clock_skew", "unrecovered", skew_pending)
        recovered += hook.transient_raised
        consumed = hook.transient_raised
        for r in list(pending["dispatch_transient"]):
            if consumed >= r["count"]:
                consumed -= r["count"]
                _resolve("dispatch_transient", "recovered")
        _resolve("tenant_fault", "quarantined", hook.tenant_contained)
        # a rank_loss that armed but never reconciled (rejoin sync never came)
        # is unrecovered — every other still-pending spec simply never fired
        for r in list(pending["rank_loss"]):
            unrecovered += 1
            _resolve("rank_loss", "unrecovered")
        for kind_pending in pending.values():
            for r in kind_pending:
                if r["outcome"] == "pending":
                    r["outcome"] = "not_fired"
        if unrecovered and flight is not None:
            flight.dump("unrecovered_faults", extra={"ledger": records})
        quarantined_faults = engine.stats["quarantined"]
        injected = (
            hook.transient_raised + hook.tenant_raised + sum(
                1 for r in records if r["kind"] in ("state_poison", "clock_skew", "rank_loss")
            ) + sum(
                r["count"] for r in records
                if r["kind"] in ("gather_flaky", "coordination_outage")
            )
        )

        snap = rec.counters.snapshot().counts
        lat = rec.latency_summary()
        history_block = rec.history_block(last_n=16)
        reconciliation = {
            "dispatches": int(snap.get("dispatches", 0)),
            "jit_compiles": int(snap.get("jit_compiles", 0)),
            "jit_cache_hits": int(snap.get("jit_cache_hits", 0)),
            "aot_cache_hits": int(snap.get("aot_cache_hits", 0)),
        }
        reconciliation["exact"] = (
            reconciliation["jit_compiles"]
            + reconciliation["jit_cache_hits"]
            + reconciliation["aot_cache_hits"]
            == reconciliation["dispatches"]
        )
        update_kind = "vwupdate" if cfg.window is not None else "vupdate"
        kind_lat = lat.get(update_kind) or {}

    final_digest = _engine_digest(engine)
    engine.close()  # release the journal segment cleanly
    # degraded-sync reconciliation: every scheduled rank loss recovered AND
    # the liveness ledger drained (no rank still marked dead at run end)
    rank_loss_ok = all(
        r["outcome"] in ("recovered", "not_fired")
        for r in records if r["kind"] == "rank_loss"
    )
    degraded_parity = 1.0 if rank_loss_ok and not _coalesce.dead_ranks() else 0.0

    stats = dict(engine.stats)
    stats.pop("spill_ns", None)  # wall-clock — outside the determinism contract
    served = admitted
    shed_rate = round(shed / max(served + shed, 1), 6)
    counters: Dict[str, Any] = {
        "events": events_total,
        "admitted": admitted,
        "shed": shed,
        "shed_rate": shed_rate,
        "dropped_quarantined": dropped_quarantined,
        "steps": traffic.steps,
        "epochs": epochs,
        "tenants": len(engine.tenants()),
        "drift_evals": len(drift.history),
        "faults_injected": injected,
        "recovered_faults": recovered,
        "quarantined_faults": quarantined_faults,
        "unrecovered_faults": unrecovered,
        "degraded_syncs": int(snap.get("degraded_syncs", 0)),
        "rank_rejoins": int(snap.get("rank_rejoins", 0)),
        "degraded_sync_parity": degraded_parity,
        **{f"engine_{k}": int(v) for k, v in stats.items()},
    }
    if cfg.durability_dir:
        counters.update({
            "journal_records": int(snap.get("journal_records", 0)),
            "journal_fsyncs": int(snap.get("journal_fsyncs", 0)),
            "snapshots": int(snap.get("snapshots", 0)),
            "snapshot_restores": int(snap.get("snapshot_restores", 0)),
            "replayed_records": int(failover_info.get("replayed", 0)),
            "failovers": int(failover_info.get("failovers", 0)),
            "failover_rpo_records": int(failover_info.get("rpo_records", 0)),
            "failover_state_parity": float(failover_info.get("state_parity", 1.0)),
        })
    timing = {
        "elapsed_s": round(elapsed, 6),
        "tenants_per_sec": round(stats["tenant_rows"] / max(elapsed, 1e-9), 3),
        "update_p50_us": float(kind_lat.get("p50_us", 0.0)),
        "update_p99_us": float(kind_lat.get("p99_us", 0.0)),
        "failover_rto_ms": float(failover_info.get("rto_ms", 0.0)),
    }
    return SoakReport(
        counters=counters,
        timing=timing,
        faults=records,
        slo_breaches=slo_breaches,
        reconciliation=reconciliation,
        config={
            "seed": traffic.seed,
            "steps": traffic.steps,
            "tenants": traffic.tenants,
            "spill_codec": cfg.spill_codec,
            "sync_codec": cfg.sync_codec,
            "window": cfg.window,
            "capacity": cfg.capacity,
            "megabatch_size": cfg.megabatch_size,
            "faults": len(faults),
            "replayed": model.replayed,
            "snapshot_every": cfg.snapshot_every,
            "failover_at": cfg.failover_at,
            "state_digest": final_digest,
        },
        history=history_block,
    )


def run_fleet_soak(
    config: Optional[SoakConfig] = None,
    traffic_model: Optional[TrafficModel] = None,
    *,
    device: Any = None,
) -> SoakReport:
    """The fleet soak: one :class:`~torchmetrics_tpu_torch.fleet.FleetController`
    over ``cfg.fleet_hosts`` member engines, driven by the same seeded
    traffic, arming ``host_loss`` (crash a member, lease runs to expiry,
    survivors adopt) and ``host_join`` (late member, rendezvous rebalance)
    at exact steps.

    The verdict is the per-tenant parity gate: after the run, the SAME
    traffic folds into one uninterrupted single-host reference engine, and
    every tenant's state digest must match bitwise —
    ``fleet_failover_parity`` 1.0 means no kill point lost a batch, seated
    a tenant twice, or double-folded a journaled record. Admission runs
    unlimited in fleet mode so the reference cannot fork on shed decisions.
    The ``counters`` block stays a pure function of (config, seed, faults);
    ``migration_us`` is wall-clock and reports under ``timing``. ``device``
    is where every host's metric lives (the card when ``None``)."""
    if config is None or config.fleet_hosts is None:
        raise TorchMetricsUserError(
            "run_fleet_soak needs SoakConfig(fleet_hosts=N, durability_dir=...)"
        )
    cfg = config
    device = resolve_device(device)
    from ..fleet import FleetController, LeaseConfig

    model = traffic_model if traffic_model is not None else TrafficModel(cfg.traffic)
    traffic = model.config
    faults = cfg.faults if cfg.faults is not None else FaultSchedule([])
    if faults.last_step >= traffic.steps:
        raise TorchMetricsUserError(
            f"fault schedule reaches step {faults.last_step} but the traffic "
            f"runs only {traffic.steps} steps."
        )
    foreign = sorted({s.kind for s in faults} - {"host_loss", "host_join"})
    if foreign:
        raise TorchMetricsUserError(
            f"the fleet soak arms only host_loss/host_join, got {foreign} — "
            "run the single-host soak for the other kinds"
        )

    clock = {"t": 0.0}
    serving = ServingConfig(
        capacity=cfg.capacity,
        megabatch_size=cfg.megabatch_size,
        spill=True,
        spill_codec=cfg.spill_codec,
        on_error="quarantine",
        max_tenants_per_sec=None,  # parity: admission must match the reference
        window=cfg.window,
        aot_cache_dir=cfg.aot_cache_dir,
        journal_fsync_every=cfg.journal_fsync_every,
        retain_snapshots=cfg.retain_snapshots,
    )

    def _fleet_metric() -> MulticlassAccuracy:
        return _metric(traffic.num_classes, device)

    records: List[Dict[str, Any]] = []
    pending: Dict[str, List[Dict[str, Any]]] = {k: [] for k in FAULT_KINDS}
    recovered = 0
    unrecovered = 0
    joined_hosts = 0
    events_total = 0
    served = 0
    failover_s = 0.0  # wall clock of the polls that failed a host over (restore, replay, adoption)
    # arrival-ordered replay source for the reference engine: the exact
    # batches the fleet saw (CPU-test sized traffic — bounded by the run)
    replay_log: List[Tuple[int, tuple, dict]] = []

    def _resolve(kind: str, outcome: str, n: int = 1) -> None:
        for _ in range(n):
            if pending[kind]:
                pending[kind].pop(0)["outcome"] = outcome

    flight = _observability.FlightRecorder(
        dump_dir=os.path.join(cfg.durability_dir, "flightrec"))
    t0 = time.perf_counter()
    with _observability.telemetry_session(
        _observability.TelemetryConfig(
            slo_rules=tuple(default_rules()) + soak_rules(shed_rate_max=cfg.shed_rate_max),
            sinks=(_observability.RingBufferSink(), flight),
            # same virtual-clock keying as the single-host soak: same seed ⇒
            # byte-identical SoakReport.history across fleet runs
            history_clock=lambda: clock["t"],
        )
    ) as rec:
        controller = FleetController(
            _fleet_metric,
            root=os.path.join(cfg.durability_dir, "fleet"),
            hosts=cfg.fleet_hosts,
            serving=serving,
            lease=LeaseConfig(
                heartbeat_interval=cfg.seconds_per_step,
                suspect_after=cfg.fleet_suspect_after,
                dead_after=cfg.fleet_dead_after,
            ),
            clock=lambda: clock["t"],
        )

        def _arm(spec: FaultSpec) -> None:
            nonlocal joined_hosts, recovered, unrecovered
            entry = {
                "step": spec.step, "kind": spec.kind, "target": spec.target,
                "count": spec.count, "outcome": "pending",
                "trace_id": _spans.derive_trace_id(
                    "fault", traffic.seed, spec.step, spec.kind, spec.target),
            }
            records.append(entry)
            pending[spec.kind].append(entry)
            if spec.kind == "host_loss":
                ctx = _spans.enter(
                    "fault", spec.kind, str(spec.target), trace=entry["trace_id"])
                try:
                    controller.kill_host(str(spec.target))
                finally:
                    _spans.exit(ctx)
            elif spec.kind == "host_join":
                host_id = spec.target or f"host-{cfg.fleet_hosts + joined_hosts}"
                joined_hosts += 1
                bad_before = controller.stats["migration_parity_failures"]
                controller.add_host(str(host_id))
                # the rebalance commits synchronously: recovered iff every
                # move landed with per-tenant parity intact
                if controller.stats["migration_parity_failures"] == bad_before:
                    recovered += 1
                    _resolve("host_join", "recovered")
                else:
                    unrecovered += 1
                    _resolve("host_join", "unrecovered")

        def _tick(step: int) -> None:
            nonlocal recovered, failover_s
            clock["t"] += cfg.seconds_per_step
            controller.heartbeat_all()
            t_poll = time.perf_counter()
            failed = controller.poll()
            if failed:
                failover_s += time.perf_counter() - t_poll
            for host_id in failed:
                # survivors adopted the dead host's roster — host_loss done
                recovered += 1
                _resolve("host_loss", "recovered")
            for spec in faults.due(step):
                _arm(spec)
            if cfg.snapshot_every and step and step % cfg.snapshot_every == 0:
                controller.snapshot_all()

        current_step = -1
        for ev in model.events():
            while current_step < ev.step:
                current_step += 1
                _tick(current_step)
            events_total += 1
            tid = int(ev.tenant_id)
            replay_log.append((tid, (ev.batch[0], ev.batch[1]), {}))
            if controller.serve(tid, ev.batch[0], ev.batch[1]):
                served += 1
            else:
                unrecovered += 1  # unlimited admission: a rejection is a bug
        while current_step < traffic.steps - 1:
            current_step += 1
            _tick(current_step)
        # run the leases out so a kill near the end still fails over inside
        # the run (the drain window is part of the soak, not lost coverage)
        drain_ticks = int(cfg.fleet_dead_after / cfg.seconds_per_step) + 2
        for _ in range(drain_ticks):
            if not pending["host_loss"]:
                break
            current_step += 1
            _tick(current_step)
        controller.flush()
        fleet_digests = controller.tenant_digests()
        rosters = {host: h.engine.tenants() for host, h in controller._hosts.items() if not h.killed}
        fleet_counts = {
            tid: rosters[host][tid]["update_count"]
            for tid, host in controller.tenants().items()
            if host in rosters
        }
        elapsed = time.perf_counter() - t0

        # ---- the uninterrupted single-host reference: same batches, same
        # arrival order, one engine, no faults — the parity oracle
        reference = ServingEngine(
            _fleet_metric(),
            dataclasses.replace(serving, journal=None, clock=lambda: clock["t"]),
        )
        for tid, args, kwargs in replay_log:
            reference.update(tid, *args, **kwargs)
        reference.flush()
        from ..fleet import tenant_state_digest as _tsd

        ref_digests = {tid: _tsd(reference, tid) for tid in reference.tenants()}
        ref_counts = {
            tid: info["update_count"] for tid, info in reference.tenants().items()
        }
        parity = 1.0 if fleet_digests == ref_digests else 0.0
        double_counted = sum(
            max(0, int(fleet_counts.get(tid, 0)) - int(ref_counts.get(tid, 0)))
            for tid in set(fleet_counts) | set(ref_counts)
        )
        reference.close()
        fleet_telemetry = controller.telemetry()
        controller.close()

        # ledger close-out: a host_loss whose lease never expired in-run is
        # unrecovered; anything else still pending never fired
        for entry in list(pending["host_loss"]):
            unrecovered += 1
            _resolve("host_loss", "unrecovered")
        for kind_pending in pending.values():
            for entry in kind_pending:
                if entry["outcome"] == "pending":
                    entry["outcome"] = "not_fired"
        if unrecovered:
            flight.dump("unrecovered_faults", extra={"ledger": records})
        injected = sum(1 for r in records if r["outcome"] != "not_fired")

        snap = rec.counters.snapshot().counts
        history_block = rec.history_block(last_n=16)
        reconciliation = {
            "dispatches": int(snap.get("dispatches", 0)),
            "jit_compiles": int(snap.get("jit_compiles", 0)),
            "jit_cache_hits": int(snap.get("jit_cache_hits", 0)),
            "aot_cache_hits": int(snap.get("aot_cache_hits", 0)),
        }
        reconciliation["exact"] = (
            reconciliation["jit_compiles"]
            + reconciliation["jit_cache_hits"]
            + reconciliation["aot_cache_hits"]
            == reconciliation["dispatches"]
        )

    cstats = controller.stats
    migration_parity = 1.0 if cstats["migration_parity_failures"] == 0 else 0.0
    digest_h = hashlib.sha256()
    for tid in sorted(fleet_digests, key=repr):
        digest_h.update(f"{tid!r}={fleet_digests[tid]}".encode("utf-8"))
    counters: Dict[str, Any] = {
        "events": events_total,
        "admitted": served,
        "shed": 0,
        "shed_rate": 0.0,
        "steps": traffic.steps,
        "tenants": len(fleet_digests),
        "hosts": int(cfg.fleet_hosts),
        "hosts_joined": joined_hosts,
        "faults_injected": injected,
        "recovered_faults": recovered,
        "quarantined_faults": 0,
        "unrecovered_faults": unrecovered,
        "fleet_failover_parity": parity,
        "migration_parity": migration_parity,
        "failover_rpo_records": int(cstats["rpo_records"]),
        "double_counted_batches": int(double_counted),
        "host_failovers": int(snap.get("host_failovers", 0)),
        "tenant_migrations": int(snap.get("tenant_migrations", 0)),
        "lease_expiries": int(snap.get("lease_expiries", 0)),
        "fleet_heartbeats": int(snap.get("fleet_heartbeats", 0)),
        "adopted_tenants": int(cstats["adopted_tenants"]),
        "parked_batches": int(cstats["parked"]),
        "replayed_records": int(cstats["failover_replayed"]),
        "snapshots": int(snap.get("snapshots", 0)),
        "snapshot_restores": int(snap.get("snapshot_restores", 0)),
        "journal_records": int(snap.get("journal_records", 0)),
        "journal_fsyncs": int(snap.get("journal_fsyncs", 0)),
    }
    timing = {
        "elapsed_s": round(elapsed, 6),
        "migration_us": float(snap.get("migration_us", 0)),
        "failover_rto_ms": round(failover_s * 1000.0, 3),
    }
    return SoakReport(
        counters=counters,
        timing=timing,
        faults=records,
        slo_breaches=[],
        reconciliation=reconciliation,
        config={
            "seed": traffic.seed,
            "steps": traffic.steps,
            "tenants": traffic.tenants,
            "spill_codec": cfg.spill_codec,
            "window": cfg.window,
            "capacity": cfg.capacity,
            "megabatch_size": cfg.megabatch_size,
            "fleet_hosts": cfg.fleet_hosts,
            "faults": len(faults),
            "replayed": model.replayed,
            "snapshot_every": cfg.snapshot_every,
            "state_digest": digest_h.hexdigest(),
        },
        fleet_telemetry=fleet_telemetry,
        history=history_block,
    )
