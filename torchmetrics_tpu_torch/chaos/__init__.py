"""Chaos plane: replayable traffic, scheduled faults, the production soak (counterpart
of ``torchmetrics_tpu/chaos``).

Three pieces:

- :class:`TrafficModel` / :class:`TrafficConfig` — a seeded, Zipf-skewed,
  bursty, churning tenant stream; same seed ⇒ same stream, serializable to
  a byte-for-byte replayable trace file (the JAX package's bytes);
- :class:`FaultSchedule` / :class:`FaultSpec` — declarative arming of the
  port's fault-injection seams at exact steps;
- :func:`run_soak` / :class:`SoakConfig` / :class:`SoakReport` — the
  end-to-end harness driving the serving + streaming + reliability +
  observability planes through one trace, with SLO verdicts and a
  deterministic fault/recovery/shed ledger (the JAX package's counter block
  for the same config). It runs on the card unless ``device="cpu"`` is asked for.
"""

from .schedule import FAULT_KINDS, FaultSchedule, FaultSpec, default_fault_schedule
from .soak import SoakConfig, SoakReport, run_fleet_soak, run_soak, soak_rules
from .traffic import TrafficConfig, TrafficEvent, TrafficModel

__all__ = [
    "FAULT_KINDS",
    "FaultSchedule",
    "FaultSpec",
    "SoakConfig",
    "SoakReport",
    "TrafficConfig",
    "TrafficEvent",
    "TrafficModel",
    "default_fault_schedule",
    "run_fleet_soak",
    "run_soak",
    "soak_rules",
]
