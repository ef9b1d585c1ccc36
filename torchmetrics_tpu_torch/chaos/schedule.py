"""Declarative, deterministic fault schedules (counterpart of
``torchmetrics_tpu/chaos/schedule.py``, copied: the same kinds, specs and JSON).

A :class:`FaultSchedule` is a list of :class:`FaultSpec` entries arming the
repo's EXISTING injection points at exact traffic steps — no new failure
machinery, just a scheduler over the seams every recovery path already
tests through (``reliability/faults.py``, the serving ``_fault_hook``, the
token-bucket clock):

==================  ==========================================================
kind                what fires, and what "recovered" means
==================  ==========================================================
dispatch_transient  the next ``count`` MEGABATCH dispatches raise a transient
                    infra error (the round-5 crash class). The quarantine
                    path re-drives per tenant; the transient does not
                    reproduce on re-drives, so every tenant survives —
                    recovered = each raise absorbed with zero quarantines.
tenant_fault        a deterministic per-tenant poison: every dispatch whose
                    megabatch contains tenant ``target`` raises, INCLUDING
                    the single-tenant re-drive — so the engine quarantines
                    exactly that tenant and readmits the peers. Counted as
                    a quarantined (contained) fault, never unrecovered.
state_poison        ``poison_state_leaf`` NaN-floods the witness metric's
                    leaf ``target`` (default ``"tp"``) at the step; the next
                    sync epoch's ``validate_state`` raises
                    ``StateCorruptionError`` and the harness resets the
                    witness — recovered at that epoch.
gather_flaky        the witness's next sync gathers through ``FlakyGather``
                    (first ``count`` collective calls drop a participant);
                    the metric's retry policy re-enters the sync — recovered
                    when the sync lands within budget.
clock_skew          the virtual admission clock jumps by ``float(target)``
                    seconds (negative = backwards skew, which DRAINS the
                    token bucket — the refill formula sees a negative
                    delta); recovered when the first post-skew batch is
                    admitted again.
rank_loss           the witness's gather seam dies as ``DeadRank``: every
                    collective row for the simulated peer rank is an
                    all-zero tombstone. The coalesced plane completes each
                    sync over the survivor quorum (``degraded_syncs``
                    counts them); ``count`` sync epochs later the rank
                    revives — recovered when the rejoin sync reconciles it
                    (``rank_rejoins``) with zero hangs or double counts.
coordination_outage the next ``count`` collective calls raise an
                    UNAVAILABLE coordination-service error BEFORE any
                    collective is entered (all ranks fail in lockstep);
                    the retry policy re-enters the sync — recovered when
                    the sync lands within budget.
host_loss           (fleet soak only) member host ``target`` crashes: its
                    journal tears at the last fsync, heartbeats stop, the
                    lease runs to expiry — recovered when the survivors
                    adopt its tenants from its latest snapshot generation
                    plus the journal tail (``host_failovers`` ticks,
                    bitwise parity against the uninterrupted reference).
host_join           (fleet soak only) a new member host joins (``target``
                    names it, default ``host-<n>``): the rendezvous fair
                    share of tenants migrates onto it via the full
                    drain → cutover protocol — recovered when the minimal
                    move set commits with per-tenant state parity.
==================  ==========================================================

Schedules serialize to/from JSON (``to_json``/``from_json``, ``save``/
``load``) so a failing soak's faults replay alongside its traffic trace.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Tuple

from ..utilities.exceptions import TorchMetricsUserError

FAULT_KINDS = (
    "dispatch_transient",
    "tenant_fault",
    "state_poison",
    "gather_flaky",
    "clock_skew",
    "rank_loss",
    "coordination_outage",
    "host_loss",
    "host_join",
)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    Args:
        step: traffic step at which the fault arms (0-based; fires before
            the step's events are driven).
        kind: one of :data:`FAULT_KINDS`.
        target: kind-specific — tenant id (``tenant_fault``), state leaf
            name (``state_poison``), skew seconds (``clock_skew``), host id
            (``host_loss``, required; ``host_join``, optional); unused
            otherwise.
        count: kind-specific repetition — failing dispatches
            (``dispatch_transient``), failing gather calls
            (``gather_flaky`` / ``coordination_outage``), or degraded sync
            epochs before the dead rank revives (``rank_loss``).
    """

    step: int
    kind: str
    target: Optional[str] = None
    count: int = 1

    def __post_init__(self) -> None:
        if not (isinstance(self.step, int) and self.step >= 0):
            raise ValueError(f"step must be a non-negative integer, got {self.step}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        if not (isinstance(self.count, int) and self.count >= 1):
            raise ValueError(f"count must be a positive integer, got {self.count}")
        if self.kind == "tenant_fault" and self.target is None:
            raise ValueError("tenant_fault needs target=<tenant id>")
        if self.kind == "host_loss" and self.target is None:
            raise ValueError("host_loss needs target=<host id>")
        if self.kind == "clock_skew":
            try:
                float(self.target)  # type: ignore[arg-type]
            except (TypeError, ValueError):
                raise ValueError(
                    f"clock_skew needs target=<seconds as float string>, got {self.target!r}"
                ) from None


class FaultSchedule:
    """An ordered, replayable set of :class:`FaultSpec` entries."""

    def __init__(self, specs: Iterable[FaultSpec] = ()) -> None:
        specs = list(specs)
        for s in specs:
            if not isinstance(s, FaultSpec):
                raise TorchMetricsUserError(
                    f"FaultSchedule entries must be FaultSpec, got {type(s).__name__}"
                )
        self.specs: Tuple[FaultSpec, ...] = tuple(sorted(specs, key=lambda s: (s.step, s.kind)))

    def due(self, step: int) -> List[FaultSpec]:
        """Specs arming exactly at ``step``."""
        return [s for s in self.specs if s.step == step]

    @property
    def last_step(self) -> int:
        return max((s.step for s in self.specs), default=-1)

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    # ------------------------------------------------------------ round trip

    def to_json(self) -> str:
        return json.dumps(
            {"version": 1, "faults": [dataclasses.asdict(s) for s in self.specs]},
            sort_keys=True,
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as err:
            # a torn/garbage file must fail cleanly, not leak a decoder error
            raise TorchMetricsUserError(f"malformed fault schedule: {err}") from err
        entries = doc["faults"] if isinstance(doc, dict) else doc
        try:
            return cls(FaultSpec(**e) for e in entries)
        except TypeError as err:
            raise TorchMetricsUserError(f"malformed fault schedule: {err}") from err

    def save(self, path: str) -> None:
        # atomic: a schedule torn by a mid-write crash must never replay as a
        # plausible-but-wrong fault set (same tmp+fsync+rename discipline as
        # the AOT cache and the durability snapshot store)
        import os
        import uuid

        path = str(path)
        tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(self.to_json() + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_json(fh.read())

    def __repr__(self) -> str:
        kinds: Dict[str, int] = {}
        for s in self.specs:
            kinds[s.kind] = kinds.get(s.kind, 0) + 1
        return f"FaultSchedule({len(self.specs)} faults: {kinds})"


def default_fault_schedule(steps: int, tenant: int = 1) -> FaultSchedule:
    """One fault of every kind, spread across the run — the schedule the
    demo/bench/CLI use when none is supplied. ``tenant`` is the id the
    ``tenant_fault`` entry quarantines (pick a mid-popularity one so its
    loss is visible but not dominant)."""
    if steps < 10:
        raise ValueError(f"need >= 10 steps to spread the default faults, got {steps}")
    return FaultSchedule(
        [
            FaultSpec(step=max(1, steps // 10), kind="rank_loss", count=1),
            FaultSpec(step=max(1, steps // 5), kind="dispatch_transient", count=2),
            FaultSpec(step=max(2, (2 * steps) // 5), kind="tenant_fault", target=str(tenant)),
            FaultSpec(step=max(3, steps // 2), kind="state_poison", target="tp"),
            FaultSpec(step=max(4, (3 * steps) // 5), kind="gather_flaky", count=2),
            FaultSpec(step=max(5, (3 * steps) // 4), kind="clock_skew", target="-2.0"),
            FaultSpec(step=max(6, (7 * steps) // 10), kind="coordination_outage", count=2),
        ]
    )
