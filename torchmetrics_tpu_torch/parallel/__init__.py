"""Sync planes over ``torch.distributed`` (counterpart of ``torchmetrics_tpu/parallel``:
the coalesced core of ``coalesce.py`` with its dead-rank ledger, ``sync.py``,
``async_sync.py``'s double-buffered background sync, and ``mesh.py``'s
``runtime_fingerprint`` for the AOT plane's keys; the quantized sync and the mesh
helpers are not ported yet)."""

from . import coalesce
from .async_sync import AsyncSyncHandle
from .coalesce import CoalesceFallback, clear_dead_ranks, coalesced_process_sync, collective_counts, reduce_many
from .sync import (
    distributed_available,
    gather_all_arrays,
    gather_metadata_vector,
    merge_states,
    pairwise_merge,
    process_sync,
    reduce_over_group,
    reduce_states,
    reduce_states_per_leaf,
)

__all__ = [
    "AsyncSyncHandle",
    "CoalesceFallback",
    "clear_dead_ranks",
    "coalesce",
    "coalesced_process_sync",
    "collective_counts",
    "distributed_available",
    "gather_all_arrays",
    "gather_metadata_vector",
    "merge_states",
    "pairwise_merge",
    "process_sync",
    "reduce_many",
    "reduce_over_group",
    "reduce_states",
    "reduce_states_per_leaf",
]
