"""Sync planes over ``torch.distributed`` (counterpart of ``torchmetrics_tpu/parallel``:
the coalesced core of ``coalesce.py`` and ``sync.py``; the quantized, asynchronous and
mesh helpers are not ported yet)."""

from . import coalesce
from .coalesce import CoalesceFallback, coalesced_process_sync, collective_counts, reduce_many
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
    "CoalesceFallback",
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
