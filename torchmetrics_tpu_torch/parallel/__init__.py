"""Sync planes over ``torch.distributed`` (counterpart of ``torchmetrics_tpu/parallel``):
the coalesced core of ``coalesce.py`` with its quantized buckets, degraded sync and
rejoin ledger, ``quantize.py``'s codecs and ``SyncConfig``, ``sync.py``,
``async_sync.py``'s double-buffered background sync, and ``mesh.py``'s
``runtime_fingerprint`` and ``tenant_sharding``. The JAX names with no torch meaning
(``shard_map``, ``make_data_mesh``, ``make_2d_mesh``, ``batch_sharding``,
``replicated``, ``reduce_over_axis``, ``DEFAULT_AXIS``) are not exported; the port adds
``gather_metadata_vector``."""

from . import coalesce, quantize
from .async_sync import AsyncSyncHandle
from .coalesce import (
    CoalesceFallback,
    clear_dead_ranks,
    coalesced_process_sync,
    collective_counts,
    quantized_payload_model,
    reduce_many,
)
from .mesh import DEFAULT_TENANT_AXIS, tenant_sharding
from .quantize import SyncConfig
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
    "DEFAULT_TENANT_AXIS",
    "SyncConfig",
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
    "quantize",
    "quantized_payload_model",
    "reduce_many",
    "reduce_states",
    "reduce_states_per_leaf",
    "tenant_sharding",
]
