"""State synchronization over ``torch.distributed`` (counterpart of
``torchmetrics_tpu/parallel/sync.py``).

Three sync planes, all driven by each state's reduction tag:

1. **Over a process group** (``reduce_states``, ``reduce_over_group``): the collective
   form of the JAX package's in-graph plane, where the group takes the place of the
   mesh axis: sum/max/min by ``all_reduce``, mean as the summed value over the world
   size, cat and custom reductions by ``all_gather``. Shapes are equal on every rank.
2. **Across processes** (``process_sync``): every rank's state is gathered and folded
   with the state's reduction; list ("cat") states may differ in length by rank. Used
   by ``Metric.sync``.
3. **Without communication** (``merge_states``): a pure fold of two state dicts, the
   building block of ``Metric.merge_state`` and of every metric's update.

Planes 1 and 2 are coalesced (``parallel/coalesce.py``): all leaves ride one collective
per (reduction class × dtype) bucket. The per-leaf plane stays as the parity reference
and as plane 2's fallback (``reduce_states_per_leaf``, ``_process_sync_per_leaf``).

The group's backend decides where a collective's tensors live: NCCL keeps them on the
card; gloo takes each payload to the CPU for the collective and brings the result back
to the device it came from.

In a telemetry session (``observability/``) ``process_sync`` counts each call with its
payload bytes and the per-leaf plane each gather, its collectives and its payload;
``gather_metadata_vector`` is the fleet-telemetry rollup's one collective.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import observability as _observability
from ..observability import tracing as _tracing
from . import coalesce as _coalesce

Reduction = Union[str, Callable, None]

# ---------------------------------------------------------------------------
# pairwise merge semantics per reduction tag (across batches / processes)
# ---------------------------------------------------------------------------


def _merge_cat(a, b):
    if isinstance(a, list):
        return a + (b if isinstance(b, list) else [b])
    return torch.cat([torch.atleast_1d(a), torch.atleast_1d(b)], dim=0)


_PAIRWISE: Dict[str, Callable] = {
    "sum": lambda a, b: a + b,
    # the mean of TWO participants only: n-way folds use weighted_mean or the stacked
    # reduction of _fold_gathered
    "mean": lambda a, b: (a + b) / 2.0,
    "max": torch.maximum,
    "min": torch.minimum,
    "cat": _merge_cat,
}


def pairwise_merge(fx: Reduction, a, b, weights: Optional[tuple] = None):
    """Merge two values of one state by its reduction tag.

    ``weights=(w_a, w_b)`` are the update counts behind each side: with them a
    ``"mean"`` state folds exactly; without them it takes the plain average of two.
    """
    if fx is None:
        return a  # keep the local value
    if callable(fx):
        return fx(torch.stack([torch.as_tensor(a), torch.as_tensor(b)], dim=0))
    if fx == "mean" and weights is not None:
        return weighted_mean(a, b, weights[0], weights[1])
    return _PAIRWISE[fx](a, b)


def weighted_mean(a, b, w_a, w_b):
    """Count-weighted mean merge: exact for any number of folded participants as long as
    each carries its cumulative weight. A total weight of 0 keeps ``a``."""
    total = w_a + w_b
    return a if total == 0 else (w_a * a + w_b * b) / total


# ---------------------------------------------------------------------------
# plane 1: reduction over a process group
# ---------------------------------------------------------------------------


def reduce_over_group(value: torch.Tensor, fx: Reduction, group: Any = None):
    """Reduce one state leaf across the processes of ``group`` (per-leaf plane)."""
    if fx is None:
        return value
    value = torch.as_tensor(value)
    if fx in ("sum", "max", "min"):
        return _coalesce._all_reduce(value.reshape(-1), fx, group).reshape(value.shape)
    if fx == "mean":
        return _coalesce._all_reduce(value.reshape(-1), "sum", group).reshape(value.shape) * (
            1.0 / dist.get_world_size(group))
    if fx == "cat":
        return torch.cat(_coalesce.process_rows(torch.atleast_1d(value), group))
    if callable(fx):
        return fx(torch.stack(_coalesce.process_rows(value, group)))
    raise ValueError(f"Unknown dist_reduce_fx: {fx!r}")


def reduce_states(state: Dict[str, Any], reductions: Mapping[str, Reduction], group: Any = None) -> Dict[str, Any]:
    """Reduce a whole state dict across ``group``, coalesced: one collective per
    (reduction class × dtype) bucket (``parallel/coalesce.py``), with the per-leaf
    plane's results."""
    return _coalesce.reduce_many([(state, reductions)], group)[0]


def reduce_states_per_leaf(
    state: Dict[str, Any], reductions: Mapping[str, Reduction], group: Any = None
) -> Dict[str, Any]:
    """The per-leaf plane (one collective per leaf): the parity reference of
    ``reduce_states``."""
    return {k: reduce_over_group(v, reductions.get(k), group) for k, v in state.items()}


# ---------------------------------------------------------------------------
# plane 2: cross-process sync
# ---------------------------------------------------------------------------


def distributed_available() -> bool:
    """True when a process group of more than one process is initialized."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


_GATHER_MAX_RANK = 8
_GATHER_DTYPES = _coalesce.GATHER_DTYPES  # one table for both planes


def gather_all_arrays(value: Optional[torch.Tensor], process_group: Any = None) -> List[torch.Tensor]:
    """All-gather one tensor across processes: a list of per-process values.

    Shapes may differ by process. They are gathered first, in a vector of fixed size so
    that every process enters the collective; every process pads each dimension to the
    world maximum, and the gathered results are trimmed back per process.
    ``value=None`` means this process has nothing (a concat state after zero updates):
    it still takes part, with a zero-length tensor in the dtype and rank its peers
    announce. An unsupported dtype is announced inside the shape collective, so every
    process raises the same error together instead of leaving its peers waiting.
    """
    vec = np.full(_GATHER_MAX_RANK + 2, -1, np.int64)
    if value is not None:
        value = torch.as_tensor(value)
        if value.ndim > _GATHER_MAX_RANK:
            raise ValueError(f"gather_all_arrays supports rank <= {_GATHER_MAX_RANK}, got {value.ndim}")
        vec[0] = value.ndim
        vec[1 : 1 + value.ndim] = value.shape
        vec[-1] = _coalesce._dtype_code_of(value.dtype)
    rows = lambda v: _coalesce.process_rows(v, process_group)  # noqa: E731
    shapes = np.stack(_coalesce._gather_metadata(rows, vec, process_group, real=True))
    known_rows = np.flatnonzero(shapes[:, 0] >= 0)
    if known_rows.size == 0:
        return []  # no process has data for this state
    codes_seen = sorted(set(shapes[known_rows, -1].tolist()))
    if _coalesce._CODE_UNSUPPORTED in codes_seen:
        raise ValueError(
            f"gather_all_arrays got an unsupported dtype on at least one process; supported: "
            f"{[str(d) for d in _GATHER_DTYPES]}"
        )
    if len(codes_seen) > 1:
        raise ValueError(
            "gather_all_arrays requires the same dtype on every process, got "
            f"{[str(_GATHER_DTYPES[int(c)]) for c in codes_seen]}"
        )
    ranks = shapes[known_rows, 0]
    if int(ranks.min()) != int(ranks.max()):
        raise ValueError(f"gather_all_arrays requires equal ranks across processes, got {sorted(set(ranks.tolist()))}")
    rank = int(ranks[0])
    dtype = _GATHER_DTYPES[int(shapes[known_rows[0], -1])]
    world = shapes.shape[0]
    if rank == 0:
        if value is None:
            value = torch.zeros((), dtype=dtype)  # scalar states cannot signal emptiness: contribute zero
        return rows(value)
    dims = np.tile(shapes[known_rows[0], 1 : 1 + rank], (world, 1))
    for i in range(world):
        if shapes[i, 0] >= 0:
            dims[i] = shapes[i, 1 : 1 + rank]
        else:
            dims[i, 0] = 0  # empty contributor: zero length, the peers' trailing dims
    if value is None:
        me = dist.get_rank(process_group) if dist.is_initialized() else 0
        value = torch.zeros(tuple(int(d) for d in dims[me]), dtype=dtype)
    if (dims == dims[0]).all():
        return rows(value)
    padded = value.new_zeros(tuple(int(m) for m in dims.max(axis=0)))
    padded[tuple(slice(0, s) for s in value.shape)] = value
    return [row[tuple(slice(0, int(d)) for d in dims[i])] for i, row in enumerate(rows(padded))]


def process_sync(
    state: Dict[str, Any],
    reductions: Mapping[str, Reduction],
    process_group: Any = None,
    dist_sync_fn: Optional[Callable] = None,
    sync_config: Optional[Any] = None,
) -> Dict[str, Any]:
    """Synchronize a state dict across processes.

    ``dist_sync_fn`` is the injection seam: ``fn(value, group) -> list_of_values``. The
    coalesced plane runs first; when the gathered metadata cannot be decoded (an
    injected gather that rewrites values), every rank sees the same rows and falls
    back to the per-leaf plane together. ``sync_config``
    (:class:`~torchmetrics_tpu_torch.parallel.SyncConfig`) opts the coalesced plane into
    the quantized (bf16/int8) buckets; the per-leaf fallback is always exact.
    """
    rec = _observability._ACTIVE
    if rec is not None:
        rec.counters.record_sync(_payload_bytes(state))
    with _tracing.trace_span("process_sync"):
        try:
            return _coalesce.coalesced_process_sync(
                [state], [reductions], process_group=process_group, dist_sync_fn=dist_sync_fn,
                sync_config=sync_config,
            )[0]
        except _coalesce.CoalesceFallback:
            return _process_sync_per_leaf(state, reductions, process_group, dist_sync_fn)


def _process_sync_per_leaf(
    state: Dict[str, Any],
    reductions: Mapping[str, Reduction],
    process_group: Any = None,
    dist_sync_fn: Optional[Callable] = None,
) -> Dict[str, Any]:
    """The per-leaf plane: one ``gather_all_arrays`` per state leaf."""
    gather = dist_sync_fn or gather_all_arrays
    rec = _observability._ACTIVE
    out: Dict[str, Any] = {}
    for name, value in state.items():
        if rec is not None:
            rec.counters.record_gather()
            # the real gather_all_arrays launches two collectives per leaf (shape
            # exchange and payload); an injected fn is one call
            rec.counters.record_sync_collectives(1 if dist_sync_fn is not None else 2)
            rec.record_gather_payload("per_leaf", _payload_bytes({name: value}))
        if isinstance(value, list):  # concat list state: concatenate, then gather
            local = torch.cat([torch.atleast_1d(torch.as_tensor(v)) for v in value]) if value else None
            if local is None and dist_sync_fn is not None:
                # injected gathers keep the plain fn(value, group) contract
                local = torch.zeros((0,), dtype=torch.float32)
            gathered = [torch.as_tensor(g) for g in gather(local, process_group)]
            out[name] = [g for g in gathered if g.shape[0] > 0] or value
            continue
        gathered = [torch.as_tensor(g) for g in gather(value, process_group)]
        out[name] = _fold_gathered(gathered, reductions.get(name))
    return out


def gather_metadata_vector(
    values: Sequence[int],
    process_group: Any = None,
    dist_sync_fn: Optional[Callable] = None,
) -> List[List[int]]:
    """All-gather one small per-process int metadata vector: a list of per-rank vectors,
    indexed by rank.

    The fleet-telemetry rollup plane: counter snapshots ride the coalesced gather plane
    (``dist_sync_fn`` stays the injection seam) as one collective of a fixed-length
    vector, with no shape exchange. Values ship as 31-bit ``(hi, lo)`` int32 halves, the
    JAX package's wire form, exact below 2**62. Over NCCL the vector goes to the current
    CUDA device (NCCL takes no CPU tensor); over gloo it stays on the CPU. Without a
    process group (and without an injected gather) the local vector comes straight
    back; with one, the collective runs, a world of one included, as every collective
    of this package does. A coalesced sync in a telemetry session already ships the
    counter vector inside its metadata collective, so ``observability.gather_counters``
    right after a sync calls this function not at all.
    """
    vals = [int(v) for v in values]
    if any(not 0 <= v < 1 << 62 for v in vals):
        raise ValueError(f"gather_metadata_vector values must be in [0, 2**62), got {vals}")
    if dist_sync_fn is None and not (dist.is_available() and dist.is_initialized()):
        return [vals]
    halves = np.empty(2 * len(vals), np.int32)
    _coalesce._pack_halves(halves, vals)
    return [_coalesce.unpack_halves(row) for row in _coalesce.gather_host_rows(halves, process_group, dist_sync_fn)]


def _payload_bytes(state: Dict[str, Any]) -> int:
    """Bytes this process contributes to a sync, from shapes and dtypes only."""
    total = 0
    for value in state.values():
        for leaf in value if isinstance(value, list) else [value]:
            if isinstance(leaf, torch.Tensor):
                total += leaf.numel() * leaf.element_size()
    return total


_REDUCED_FLOATS = (torch.bfloat16, torch.float16)


def _fold_gathered(gathered: List[torch.Tensor], fx: Reduction):
    """Reduce a world-sized list of one state's values.

    Stack, then reduce: ``"mean"`` takes the whole stacked gather in one step, since a
    sequential pairwise ``(a+b)/2`` fold is wrong for 3+ ranks. The dtypes follow
    ``jnp``'s reductions: integer sums keep their dtype (bool counts in int32), a mean
    of integers is float32, and bf16/f16 accumulate in float32 and round once. A mean is
    the sum times ``1/n`` in float32, which is what XLA makes of ``jnp.mean``'s
    division, so the results equal the JAX package's bit for bit.
    """
    if fx is None:
        return gathered[0] if len(gathered) == 1 else torch.stack(gathered)
    if callable(fx):
        return fx(torch.stack(gathered))
    if fx == "cat":
        return torch.cat([torch.atleast_1d(g) for g in gathered], dim=0)
    stacked = torch.stack(gathered)
    if fx == "sum":
        if stacked.dtype in _REDUCED_FLOATS:
            return stacked.float().sum(dim=0).to(stacked.dtype)
        return stacked.sum(dim=0, dtype=torch.int32 if stacked.dtype == torch.bool else stacked.dtype)
    if fx == "mean":  # the sum times 1/n, as XLA folds jnp.mean's division
        if stacked.dtype in _REDUCED_FLOATS:
            return (stacked.float().sum(dim=0) * (1.0 / len(gathered))).to(stacked.dtype)
        if not stacked.is_floating_point():
            stacked = stacked.float()
        return stacked.sum(dim=0) * (1.0 / len(gathered))
    if fx == "max":
        return stacked.amax(dim=0)
    if fx == "min":
        return stacked.amin(dim=0)
    raise ValueError(f"Unknown dist_reduce_fx: {fx!r}")


# ---------------------------------------------------------------------------
# plane 3: merge without communication
# ---------------------------------------------------------------------------


def merge_states(
    a: Dict[str, Any],
    b: Dict[str, Any],
    reductions: Mapping[str, Reduction],
    weights: Optional[tuple] = None,
) -> Dict[str, Any]:
    """Fold state dict ``b`` into ``a`` by per-state reductions (pure).

    ``weights=(w_a, w_b)`` carries each side's update count, so that ``"mean"`` states
    fold exactly for any chain length (``Metric.merge_state`` passes its counts).
    """
    out: Dict[str, Any] = {}
    for name, va in a.items():
        vb = b[name]
        if isinstance(va, list) or isinstance(vb, list):
            out[name] = (va if isinstance(va, list) else [va]) + (vb if isinstance(vb, list) else [vb])
        else:
            out[name] = pairwise_merge(reductions.get(name), va, vb, weights=weights)
    return out


__all__ = [
    "distributed_available",
    "gather_all_arrays",
    "gather_metadata_vector",
    "merge_states",
    "pairwise_merge",
    "process_sync",
    "reduce_over_group",
    "reduce_states",
    "reduce_states_per_leaf",
    "weighted_mean",
]
