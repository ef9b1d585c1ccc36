"""Fleet failover plane: multi-host tenant placement, live migration, and
host-loss recovery over N serving engines (counterpart of ``torchmetrics_tpu/fleet``).

- :mod:`~torchmetrics_tpu_torch.fleet.placement` — deterministic weighted
  rendezvous-hash tenant→host map and the minimal-move rebalance planner;
- :mod:`~torchmetrics_tpu_torch.fleet.membership` — lease/heartbeat liveness on
  the injectable virtual clock (alive → suspect → dead);
- :mod:`~torchmetrics_tpu_torch.fleet.controller` — the routing surface:
  ``serve`` by placement, ``migrate`` with the drain → snapshot-slice →
  transfer → restore → cutover protocol, and lease-expiry failover from
  each host's snapshot generation + journal tail. Every host's engine lives on
  the device of the metric its factory builds.
"""

from .controller import (
    MIGRATION_STAGES,
    FleetController,
    MigrationAborted,
    active_controller,
    tenant_state_digest,
)
from .membership import LEASE_STATES, LeaseConfig, Member, Membership
from .placement import Move, place, place_all, placement_score, rebalance_plan

__all__ = [
    "MIGRATION_STAGES",
    "LEASE_STATES",
    "FleetController",
    "MigrationAborted",
    "active_controller",
    "LeaseConfig",
    "Member",
    "Membership",
    "Move",
    "place",
    "place_all",
    "placement_score",
    "rebalance_plan",
    "tenant_state_digest",
]
