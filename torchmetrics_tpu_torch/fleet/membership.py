"""Lease/heartbeat membership on the injectable virtual clock (counterpart of
``torchmetrics_tpu/fleet/membership.py``, copied).

Each member host holds a lease it renews by heartbeating. Liveness is a
pure function of ``clock() - last_heartbeat`` against two thresholds, so a
host is in exactly one of three states:

- **alive** — heartbeat within ``suspect_after`` seconds;
- **suspect** — silent past ``suspect_after`` but inside ``dead_after``:
  the host keeps its tenants (routing is NOT disturbed — a suspect that
  revives must cause no spurious failover);
- **dead** — silent past ``dead_after``: the lease expired. :meth:`expire`
  reports the transition exactly once and the controller adopts the dead
  host's tenants from its durable state.

The clock is injected (``ServingConfig(clock=)`` discipline), so the chaos
soak drives expiry deterministically in virtual seconds — no wall-clock in
the membership verdicts.

Epoch bookkeeping mirrors ``parallel/coalesce`` v8 rank liveness: every
member carries a liveness epoch, bumped when a host rejoins after its lease
expired. A peer can therefore tell a rejoin (same id, higher epoch — fold
its state exactly once, the ``rank_rejoin`` discipline) from a host that
never died (same epoch).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from ..utilities.exceptions import TorchMetricsUserError

__all__ = ["LEASE_STATES", "LeaseConfig", "Member", "Membership"]

LEASE_STATES = ("alive", "suspect", "dead")


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    """Liveness thresholds in (virtual) seconds.

    Args:
        heartbeat_interval: the cadence hosts are expected to renew at —
            advisory (the controller heartbeats on its traffic steps), but
            the thresholds should be comfortable multiples of it.
        suspect_after: silence before a host turns suspect (routing
            undisturbed; the flap window).
        dead_after: silence before the lease expires and survivors adopt
            the host's tenants. Must exceed ``suspect_after``: the suspect
            state exists so a flapping host can revive WITHOUT a failover.
    """

    heartbeat_interval: float = 1.0
    suspect_after: float = 3.0
    dead_after: float = 6.0

    def __post_init__(self) -> None:
        if not self.heartbeat_interval > 0:
            raise ValueError(
                f"heartbeat_interval must be > 0, got {self.heartbeat_interval}"
            )
        if not self.suspect_after > 0:
            raise ValueError(f"suspect_after must be > 0, got {self.suspect_after}")
        if not self.dead_after > self.suspect_after:
            raise ValueError(
                f"dead_after ({self.dead_after}) must exceed suspect_after "
                f"({self.suspect_after}) — without a suspect window every "
                "missed heartbeat would be a failover"
            )


@dataclasses.dataclass
class Member:
    """One host's lease bookkeeping."""

    host_id: str
    weight: float = 1.0
    last_heartbeat: float = 0.0
    epoch: int = 1  # liveness epoch — bumps on rejoin-after-expiry
    heartbeats: int = 0
    expired: bool = False  # lease expiry already reported by expire()


class Membership:
    """The fleet's lease table. All verdicts derive from the injected clock;
    nothing here touches wall-clock or threads."""

    def __init__(
        self,
        clock: Callable[[], float],
        config: Optional[LeaseConfig] = None,
    ) -> None:
        if not callable(clock):
            raise TorchMetricsUserError(
                f"clock must be a zero-arg callable returning seconds, got {clock!r}"
            )
        self.clock = clock
        self.config = config if config is not None else LeaseConfig()
        self._members: Dict[str, Member] = {}

    # ------------------------------------------------------------- lifecycle

    def join(self, host_id: str, weight: float = 1.0) -> Member:
        """Register a host (or re-register one whose lease expired — that is
        a REJOIN and bumps its liveness epoch, the coalesce-v8 discipline
        that lets peers fold a rejoiner exactly once)."""
        if not weight > 0:
            raise TorchMetricsUserError(f"host weight must be > 0, got {weight}")
        m = self._members.get(host_id)
        if m is None:
            m = Member(host_id=host_id, weight=float(weight), last_heartbeat=self.clock())
            self._members[host_id] = m
        else:
            if self.state(host_id) == "dead":
                m.epoch += 1  # rejoin after expiry — a NEW incarnation
            m.weight = float(weight)
            m.last_heartbeat = self.clock()
            m.expired = False
        return m

    def leave(self, host_id: str) -> None:
        """Graceful departure: the host is removed without an expiry (its
        tenants migrate out first — the controller's job, not ours)."""
        self._members.pop(host_id, None)

    def heartbeat(self, host_id: str) -> None:
        """Renew one host's lease. Heartbeats from a host whose lease
        ALREADY expired are ignored — it must :meth:`join` again (rejoin
        epoch bump), never silently resurrect."""
        m = self._members.get(host_id)
        if m is None:
            raise TorchMetricsUserError(f"unknown host {host_id!r} (join first)")
        if self.state(host_id) == "dead":
            return
        m.last_heartbeat = self.clock()
        m.heartbeats += 1

    # --------------------------------------------------------------- queries

    def state(self, host_id: str) -> str:
        """``"alive"`` / ``"suspect"`` / ``"dead"`` for one host, computed
        from the clock (never cached — a revived clock revives the host as
        long as the lease has not expired)."""
        m = self._members.get(host_id)
        if m is None:
            raise TorchMetricsUserError(f"unknown host {host_id!r}")
        if m.expired:
            return "dead"  # expiry is terminal until an explicit rejoin
        silence = self.clock() - m.last_heartbeat
        if silence >= self.config.dead_after:
            return "dead"
        if silence >= self.config.suspect_after:
            return "suspect"
        return "alive"

    def members(self) -> Dict[str, Member]:
        return dict(self._members)

    def hosts(self, states: tuple = ("alive", "suspect")) -> Dict[str, float]:
        """Host → weight map for placement. Default includes suspects: a
        suspect keeps its tenants until its lease actually expires, so
        routing must keep targeting it (no spurious failover)."""
        return {
            h: m.weight for h, m in sorted(self._members.items())
            if self.state(h) in states
        }

    def expire(self) -> List[str]:
        """Report leases that expired since the last call (each host exactly
        once, in sorted order — the controller's failover trigger)."""
        out: List[str] = []
        for h in sorted(self._members):
            m = self._members[h]
            if not m.expired and self.state(h) == "dead":
                m.expired = True
                out.append(h)
        return out
