"""Multi-tenant serving engine (counterpart of ``torchmetrics_tpu/serving``): stacked
tenant states, vmapped megabatch dispatch, LRU spill, per-tenant lifecycle,
crash-consistent snapshots and a write-ahead traffic journal."""

from .durability import JournalRecord, SnapshotStore, TrafficJournal, batch_digest
from .engine import ServingConfig, ServingEngine

__all__ = [
    "JournalRecord",
    "ServingConfig",
    "ServingEngine",
    "SnapshotStore",
    "TrafficJournal",
    "batch_digest",
]
