"""Coalesced sync plane: bucketed state synchronization over ``torch.distributed``
(counterpart of ``torchmetrics_tpu/parallel/coalesce.py``).

The per-leaf plane (``parallel/sync.py``) launches two collectives per state leaf: a
shape exchange and the payload. A collection of K metrics with L leaves each pays 2·K·L
collectives per sync, each with its full launch latency, while the payloads are small.
This module buckets them:

- **Over a process group** (:func:`reduce_many`, the counterpart of the JAX package's
  in-graph plane): every fixed-shape leaf of one or many state dicts is raveled into a
  flat bucket per (reduction class × dtype). One ``all_reduce`` serves each sum/mean
  bucket (a mean divides by the world size afterwards), one each the max and min
  buckets, and one ``all_gather`` per dtype the cat and custom leaves, whose slices are
  reshaped back to ``(world, *shape)`` before they are concatenated or reduced.
- **Across processes** (:func:`coalesced_process_sync`): one metadata all-gather
  describes every leaf of every participating metric, then one padded all-gather per
  dtype bucket ships all leaves of that dtype at once. Cat lengths that differ by rank
  are padded to the world maximum and trimmed from the metadata. The gathered rows are
  split back into the per-(rank, leaf) tensors the per-leaf plane would have produced
  and folded by the same ``_fold_gathered``, so the results equal the per-leaf plane's
  bit for bit. A weighted mean's weight is an ordinary ``"sum"`` leaf and rides the
  same bucket as its value.

**Per-leaf fallback.** When the gathered metadata cannot be decoded consistently (an
injected ``dist_sync_fn`` that rewrites values, ranks that disagree on the leaf table),
:class:`CoalesceFallback` is raised and the caller runs the per-leaf plane. The decision
is made from the gathered rows, which every rank sees alike, so all ranks fall back
together and the collectives stay in step.

**Transport and devices.** With a process group initialized, every sync runs real
collectives, a world of one included; without one, a process is a world of one and its
rows are its own. The group's backend decides where the collectives' tensors live:
under NCCL everything stays on the card (``torch.cuda.current_device()``); under gloo
each payload goes to the CPU for the collective and the gathered rows come back to the
device the payload came from. The metadata row is int32 numpy: it goes to the
transport's device for the all-gather, and the gathered rows come back to the host with
one device-to-host copy, the sync's only host read. Bucket rows stay on their device
and fold there. Gathers use the list form ``dist.all_gather``, which every torch
version has (``all_gather_into_tensor`` is deprecated in newer ones).

**The metadata row.** ``[magic, version, n_leaves, n_counter_fields, alive, epoch]``,
then per leaf ``[dtype_code, ndim, d0..d7, kind | codec << 1]``, then the telemetry
tails: the active session's counter vector (``len(COUNTER_FIELDS)`` values) and its
fleet histogram vector, each value as two 31-bit int32 halves, zeros when no session is
on; with an enabled ``SyncConfig`` (``parallel/quantize.py``) a quant section follows,
one fixed-length record per quantizable dtype (``[codec, n_blocks]`` plus, for int8,
the bucket's block scales and zeros as float32 bit patterns). The row equals the JAX
package's int for int (format v11). An all-zero row is a tombstone, the row a rank
that died mid-collective leaves behind: the plan marks that rank dead and the bucket
folds cover the survivors only.

**Quantized buckets.** A bucket in which some rank announced a codec ships as a byte
stream: exact leaves as their raw bytes, quantized leaves as their codec payloads, each
rank's segment decoded with that rank's own announced codes and scales. A world of one
never quantizes.

**The fleet mailbox.** A sync over the real transport leaves every rank's counter and
histogram rows in a mailbox keyed to the telemetry session's epoch, so that
``observability.gather_counters``/``gather_histograms`` right after a sync launch no
collective of their own.

**Degraded sync and rejoin.** Every live rank announces alive 1 and its liveness epoch
(:func:`liveness_epoch`; a restarted process calls :func:`bump_liveness_epoch`), so an
all-zero row can only be a tombstone. After a sync has committed, the dead-rank ledger
(:func:`dead_ranks`: rank -> consecutive degraded syncs seen dead) counts each
tombstoned rank, drops a rank whose row came back alive (a rejoin: its whole accumulator
was part of that very gather, so nothing is counted twice), and the telemetry session
records the degraded sync and each rejoin. :func:`clear_dead_ranks` forgets the ledger.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import observability as _observability
from ..observability.counters import COUNTER_FIELDS
from ..observability.histograms import FLEET_VECTOR_LEN as _HIST_VEC_LEN
from ..reliability.retry import TRANSIENT, classify_exception
from . import quantize as _quantize

Reduction = Union[str, Callable, None]

_MAX_RANK = 8
# one dtype table for both planes; the codes are the JAX package's, in its order
GATHER_DTYPES = (
    torch.float32, torch.float64, torch.int32, torch.int64,
    torch.bfloat16, torch.float16, torch.uint8, torch.bool,
)

_MAGIC = 0x436F414C  # "CoAL"
_VERSION = 11
_HEADER_LEN = 6  # [magic, version, n_leaves, n_counter_fields, alive, epoch]
_LEAF_REC_LEN = 2 + _MAX_RANK + 1  # [dtype_code, ndim, d0..d7, kind | codec << 1]
_KIND_TENSOR = 0
_KIND_LIST = 1

# dtype sentinels announced inside the metadata collective: every rank completes the
# exchange, sees the same sentinel and raises (or falls back) together
_CODE_EMPTY = -1  # zero-update list state: no data, dtype unknown on this rank
_CODE_UNSUPPORTED = -2
_CODE_RANK_OVERFLOW = -3
_CODE_DIM_OVERFLOW = -4  # a dimension does not fit the int32 metadata encoding


# this process's liveness epoch, announced in every metadata row: a process that
# restarts bumps it, so its peers can tell a rejoin from a rank that never died
_LIVENESS: Dict[str, int] = {"epoch": 1}
# rank index -> consecutive degraded syncs it has been seen dead for
_DEAD_RANKS: Dict[int, int] = {}


def liveness_epoch() -> int:
    """This process's current liveness epoch (starts at 1)."""
    return _LIVENESS["epoch"]


def bump_liveness_epoch() -> int:
    """Announce a fresh liveness epoch (a restarted or failed-over process calls this so
    its peers see its rows as a new incarnation)."""
    _LIVENESS["epoch"] += 1
    return _LIVENESS["epoch"]


def dead_ranks() -> Dict[int, int]:
    """Ranks currently tombstoned by the degraded-sync plane (rank index ->
    consecutive degraded syncs seen dead)."""
    return dict(_DEAD_RANKS)


def clear_dead_ranks() -> None:
    """Forget all tombstones (test and soak-run isolation)."""
    _DEAD_RANKS.clear()


class CoalesceFallback(Exception):
    """Internal control flow: the gathered metadata could not be decoded into a
    consistent world plan, and the caller must run the per-leaf plane. Never raised for
    errors of a real collective: those propagate."""


# ---------------------------------------------------------------------------
# leaf table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Leaf:
    state_idx: int
    name: str
    fx: Reduction
    is_list: bool
    array: Optional[torch.Tensor]  # list states pre-concatenated; None == no data
    original: Any


def _dtype_code_of(dtype: torch.dtype) -> int:
    for i, cand in enumerate(GATHER_DTYPES):
        if dtype == cand:
            return i
    return _CODE_UNSUPPORTED


def _prepare_leaves(
    states: Sequence[Dict[str, Any]], reductions_list: Sequence[Mapping[str, Reduction]]
) -> List[_Leaf]:
    """Ordered leaf table over one or many state dicts. List ("cat") states are
    concatenated first, as the per-leaf plane does before it gathers."""
    leaves: List[_Leaf] = []
    for si, (state, reds) in enumerate(zip(states, reductions_list)):
        for name, value in state.items():
            fx = reds.get(name)
            if isinstance(value, list):
                arr = torch.cat([torch.atleast_1d(torch.as_tensor(v)) for v in value]) if value else None
                leaves.append(_Leaf(si, name, fx, True, arr, value))
            else:
                leaves.append(_Leaf(si, name, fx, False, torch.as_tensor(value), value))
    return leaves


def build_local_metadata(
    states: Sequence[Dict[str, Any]],
    reductions_list: Sequence[Mapping[str, Reduction]],
    counters_vector: Optional[Sequence[int]] = None,
    hist_vector: Optional[Sequence[int]] = None,
    sync_config: Optional[Any] = None,
) -> np.ndarray:
    """This rank's metadata row: the shapes and dtypes of its leaves, the telemetry
    tails and, with an enabled ``sync_config``, the quant section announcing this rank's
    per-leaf codecs and per-bucket block scales, as one int32 vector. Its length depends
    only on the leaf table and the codec, so the collective needs no shape exchange."""
    leaves = _prepare_leaves(states, reductions_list)
    return _encode_metadata(leaves, counters_vector, hist_vector, _make_qctx(leaves, sync_config))


def _make_qctx(leaves: Sequence[_Leaf], sync_config: Optional[Any]) -> Optional[_quantize.QuantContext]:
    if sync_config is None or not getattr(sync_config, "enabled", False):
        return None
    return _quantize.QuantContext(sync_config, leaves)


def _quant_record_lens(qctx: Optional[_quantize.QuantContext]) -> List[int]:
    """Quant-section record lengths: a fixed layout, one record per dtype of
    ``quantize.QUANT_SECTION_DTYPES`` (``[codec, n_blocks]`` plus the reserved
    ``(scale, zero)`` slot pairs for int8) whether or not this rank holds leaves of that
    dtype, so the row's length is the same on every rank."""
    if qctx is None:
        return []
    per = 2 + (2 * _quantize.BUCKET_SCALE_SLOTS if qctx.config.codec == "int8" else 0)
    return [per] * len(_quantize.QUANT_SECTION_DTYPES)


def _pack_halves(dest: np.ndarray, values: Sequence[int]) -> None:
    """31-bit ``(hi, lo)`` int32 halves, the JAX package's encoding of a value below
    2**62 in an int32 row."""
    vals = [int(v) for v in values]
    dest[0::2] = [v >> 31 for v in vals]
    dest[1::2] = [v & 0x7FFFFFFF for v in vals]


def unpack_halves(halves: Sequence[int]) -> List[int]:
    """Inverse of :func:`_pack_halves`."""
    return [(int(hi) << 31) | int(lo) for hi, lo in zip(halves[0::2], halves[1::2])]


def _encode_metadata(
    leaves: Sequence[_Leaf],
    counters_vector: Optional[Sequence[int]] = None,
    hist_vector: Optional[Sequence[int]] = None,
    qctx: Optional[_quantize.QuantContext] = None,
) -> np.ndarray:
    n_fields = len(COUNTER_FIELDS)
    quant_lens = _quant_record_lens(qctx)
    vec = np.zeros(
        _HEADER_LEN + len(leaves) * _LEAF_REC_LEN + 2 * n_fields + 2 * _HIST_VEC_LEN + sum(quant_lens), np.int32)
    vec[0], vec[1], vec[2], vec[3] = _MAGIC, _VERSION, len(leaves), n_fields
    # a live rank always announces alive=1 and its epoch, so an all-zero row can only
    # be a dead rank's tombstone
    vec[4], vec[5] = 1, _LIVENESS["epoch"]
    for i, leaf in enumerate(leaves):
        rec = vec[_HEADER_LEN + i * _LEAF_REC_LEN :]
        if leaf.array is None:
            rec[0], rec[1] = _CODE_EMPTY, 1  # zero-length; peers decide the rest
        else:
            arr = leaf.array
            if arr.ndim > _MAX_RANK:
                rec[0], rec[1] = _CODE_RANK_OVERFLOW, 1
            elif any(s >= 1 << 31 for s in arr.shape):
                # announced inside the collective like the other sentinels: a local
                # fallback before it would put this rank out of step with its peers
                rec[0], rec[1] = _CODE_DIM_OVERFLOW, 1
            else:
                rec[0] = _dtype_code_of(arr.dtype)
                rec[1] = arr.ndim
                for d, s in enumerate(arr.shape):
                    rec[2 + d] = s
        kind = _KIND_LIST if leaf.is_list else _KIND_TENSOR
        codec = qctx.leaf_code(i) if qctx is not None else 0
        rec[2 + _MAX_RANK] = kind | (codec << 1)
    tail_at = _HEADER_LEN + len(leaves) * _LEAF_REC_LEN
    if counters_vector is not None:
        vals = [int(v) for v in counters_vector]
        if len(vals) != n_fields:
            raise ValueError(f"counters vector must have {n_fields} entries, got {len(vals)}")
        _pack_halves(vec[tail_at : tail_at + 2 * n_fields], vals)
    if hist_vector is not None:
        vals = [int(v) for v in hist_vector]
        if len(vals) != _HIST_VEC_LEN:
            raise ValueError(f"histogram vector must have {_HIST_VEC_LEN} entries, got {len(vals)}")
        _pack_halves(vec[tail_at + 2 * n_fields : tail_at + 2 * n_fields + 2 * _HIST_VEC_LEN], vals)
    if qctx is not None:
        at = tail_at + 2 * n_fields + 2 * _HIST_VEC_LEN
        slots = _quantize.BUCKET_SCALE_SLOTS
        for dt, rec_len in zip(_quantize.QUANT_SECTION_DTYPES, quant_lens):
            vec[at] = qctx.config.codec_code
            vec[at + 1] = sum(qctx.bucket_blocks.get(dt, []))
            if qctx.config.codec == "int8":
                scales = qctx.bucket_scales.get(dt, np.zeros((0,), np.float32))
                zeros = qctx.bucket_zeros.get(dt, np.zeros((0,), np.float32))
                vec[at + 2 : at + 2 + len(scales)] = _quantize.f32_bits(scales)
                vec[at + 2 + slots : at + 2 + slots + len(zeros)] = _quantize.f32_bits(zeros)
            at += rec_len
    return vec


# ---------------------------------------------------------------------------
# world plan (decoded from the gathered metadata rows)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _LeafPlan:
    dtype: Optional[torch.dtype]  # None == every rank empty (leaf keeps its local value)
    dims: List[Tuple[int, ...]]  # per-rank shapes (empty ranks: zero-length)
    counts: List[int]  # per-rank element counts


@dataclasses.dataclass
class _QuantPlan:
    """Every rank's decoded quant announcements (``parallel/quantize.py``)."""

    codec: str  # the configured codec's name, agreed by every rank
    leaf_codes: List[List[int]]  # [leaf][rank] announced codec code
    # dtype -> per-rank (n_blocks used, scales f32, zeros f32)
    bucket_scales: Dict[torch.dtype, List[Tuple[int, np.ndarray, np.ndarray]]]


@dataclasses.dataclass
class _WorldPlan:
    world: int
    leaf_plans: List[_LeafPlan]
    buckets: Dict[torch.dtype, List[int]]  # dtype -> leaf indices, first-appearance order
    # False = the rank sent an all-zero tombstone row; the folds skip its segments
    alive: List[bool]
    epochs: List[int]  # 0 for dead ranks
    counter_rows: List[List[int]]  # per-rank counter vectors from the row tails
    hist_rows: List[List[int]]  # per-rank fleet histogram vectors, same tails
    quant: Optional[_QuantPlan] = None


def _decode_rows(rows: Sequence[Any], n_leaves: int, quant_len: int = 0) -> List[Optional[np.ndarray]]:
    decoded: List[Optional[np.ndarray]] = []
    expect_len = (_HEADER_LEN + n_leaves * _LEAF_REC_LEN + 2 * len(COUNTER_FIELDS) + 2 * _HIST_VEC_LEN
                  + quant_len)
    for row in rows:
        arr = np.asarray(row).ravel()
        if arr.size != expect_len or not np.issubdtype(arr.dtype, np.integer):
            raise CoalesceFallback("metadata row has unexpected length/dtype")
        if not arr.any():
            # a rank that died mid-collective contributes all zeros. This is read before
            # the magic check: a fallback would run the per-leaf plane, which has no
            # tombstones and would fold the dead rank's zero payloads as data
            decoded.append(None)
            continue
        if int(arr[0]) != _MAGIC or int(arr[1]) != _VERSION or int(arr[2]) != n_leaves:
            raise CoalesceFallback("metadata row failed validation")
        if int(arr[4]) != 1 or int(arr[5]) < 1:
            raise CoalesceFallback("metadata row carries an invalid liveness slot")
        decoded.append(arr.astype(np.int64))
    if decoded and all(r is None for r in decoded):
        raise CoalesceFallback("every rank's metadata row is a tombstone")
    return decoded


def _plan_from_rows(rows: Sequence[Any], leaves: Sequence[_Leaf],
                    qctx: Optional[_quantize.QuantContext] = None) -> _WorldPlan:
    quant_lens = _quant_record_lens(qctx)
    decoded = _decode_rows(rows, len(leaves), sum(quant_lens))
    world = len(decoded)
    leaf_plans: List[_LeafPlan] = []
    buckets: Dict[torch.dtype, List[int]] = {}
    leaf_codes: List[List[int]] = []
    cfg_code = qctx.config.codec_code if qctx is not None else 0
    for i, leaf in enumerate(leaves):
        # a dead rank's leaves decode as empty contributors (count 0, the leaf's own
        # kind), so padding totals and bucket offsets stay defined
        tomb = np.zeros((_LEAF_REC_LEN,), np.int64)
        tomb[0], tomb[1] = _CODE_EMPTY, 1
        tomb[2 + _MAX_RANK] = _KIND_LIST if leaf.is_list else _KIND_TENSOR
        recs = [
            tomb if row is None else row[_HEADER_LEN + i * _LEAF_REC_LEN :][:_LEAF_REC_LEN]
            for row in decoded
        ]
        kinds = {int(r[2 + _MAX_RANK]) & 1 for r in recs}
        leaf_codes.append([int(r[2 + _MAX_RANK]) >> 1 for r in recs])
        if kinds != {_KIND_LIST if leaf.is_list else _KIND_TENSOR}:
            raise CoalesceFallback("ranks disagree on the leaf kind table")
        # a codec announcement must be one this world could have produced: the
        # configured codec on a float32/float64 leaf with data, 0 everywhere else; a
        # corrupt row falls back to the exact per-leaf plane on every rank together
        for code, r in zip(leaf_codes[-1], recs):
            quantizable = (cfg_code != 0 and 0 <= int(r[0]) < len(GATHER_DTYPES)
                           and GATHER_DTYPES[int(r[0])] in (torch.float32, torch.float64))
            if code not in ((0, cfg_code) if quantizable else (0,)):
                raise CoalesceFallback("leaf record carries an impossible codec announcement")
        codes = sorted({int(r[0]) for r in recs})
        if _CODE_DIM_OVERFLOW in codes:
            # the per-leaf plane's int64 shape vector can express this: fall back
            raise CoalesceFallback("a leaf dimension does not fit the metadata encoding")
        if _CODE_RANK_OVERFLOW in codes:
            raise ValueError(f"coalesced sync supports rank <= {_MAX_RANK} state leaves")
        known = [c for c in codes if c >= 0]
        if _CODE_UNSUPPORTED in codes:
            raise ValueError(
                f"coalesced sync got an unsupported dtype on at least one process; supported: "
                f"{[str(d) for d in GATHER_DTYPES]}"
            )
        if len(known) > 1:
            raise ValueError(
                "coalesced sync requires the same dtype on every process, got "
                f"{[str(GATHER_DTYPES[c]) if c < len(GATHER_DTYPES) else c for c in known]}"
            )
        if not known:  # every rank empty: the leaf keeps its local value
            leaf_plans.append(_LeafPlan(None, [(0,)] * world, [0] * world))
            continue
        if any(not 0 <= c < len(GATHER_DTYPES) for c in known):
            raise CoalesceFallback("metadata row carries an invalid dtype code")
        dtype = GATHER_DTYPES[known[0]]
        ndims = {int(r[1]) for r in recs if int(r[0]) >= 0}
        if len(ndims) > 1:
            raise ValueError(f"coalesced sync requires equal ranks across processes, got {sorted(ndims)}")
        ndim = ndims.pop()
        if not 0 <= ndim <= _MAX_RANK:
            raise CoalesceFallback("metadata row carries an invalid ndim")
        template = next(tuple(int(d) for d in r[2 : 2 + ndim]) for r in recs if int(r[0]) >= 0)
        dims: List[Tuple[int, ...]] = []
        for r in recs:
            if int(r[0]) >= 0:
                shape = tuple(int(d) for d in r[2 : 2 + ndim])
                if any(d < 0 for d in shape):
                    raise CoalesceFallback("metadata row carries a negative dimension")
                dims.append(shape)
            else:  # empty contributor: zero length, the peers' trailing dims
                dims.append((0,) + template[1:] if ndim else ())
        counts = [0 if int(r[0]) < 0 else (int(np.prod(d)) if d else 1) for r, d in zip(recs, dims)]
        leaf_plans.append(_LeafPlan(dtype, dims, counts))
        buckets.setdefault(dtype, []).append(i)
    alive = [row is not None for row in decoded]
    epochs = [0 if row is None else int(row[5]) for row in decoded]
    tail_at = _HEADER_LEN + len(leaves) * _LEAF_REC_LEN
    hist_at = tail_at + 2 * len(COUNTER_FIELDS)
    quant_at = hist_at + 2 * _HIST_VEC_LEN
    # a dead rank contributes zero telemetry, like a rank without a session
    counter_rows = [[0] * len(COUNTER_FIELDS) if row is None else unpack_halves(row[tail_at:hist_at])
                    for row in decoded]
    hist_rows = [[0] * _HIST_VEC_LEN if row is None else unpack_halves(row[hist_at:quant_at]) for row in decoded]
    quant = None
    if qctx is not None:
        quant = _QuantPlan(qctx.config.codec, leaf_codes, _decode_quant_section(decoded, quant_at, qctx))
    return _WorldPlan(world=world, leaf_plans=leaf_plans, buckets=buckets, alive=alive, epochs=epochs,
                      counter_rows=counter_rows, hist_rows=hist_rows, quant=quant)


def _decode_quant_section(decoded: Sequence[Optional[np.ndarray]], quant_at: int,
                          qctx: _quantize.QuantContext) -> Dict[torch.dtype, List[Tuple[int, np.ndarray, np.ndarray]]]:
    """Every rank's per-dtype ``(n_blocks, scales, zeros)`` from the fixed quant
    section; a dead rank has no quantized segments."""
    bucket_scales: Dict[torch.dtype, List[Tuple[int, np.ndarray, np.ndarray]]] = {}
    slots = _quantize.BUCKET_SCALE_SLOTS if qctx.config.codec == "int8" else 0
    rec_len = 2 + 2 * slots
    empty = np.zeros((0,), np.float32)
    for row in decoded:
        if row is None:
            for dt in _quantize.QUANT_SECTION_DTYPES:
                bucket_scales.setdefault(dt, []).append((0, empty, empty))
            continue
        at = quant_at
        for dt in _quantize.QUANT_SECTION_DTYPES:
            code = int(row[at])
            if code not in (0, qctx.config.codec_code):
                raise CoalesceFallback("quant record carries an unknown codec code")
            n_blocks = int(row[at + 1])
            if not 0 <= n_blocks <= slots:  # bf16 records carry no blocks
                raise CoalesceFallback("quant record carries an invalid block count")
            if slots:
                scales = _quantize.bits_f32(row[at + 2 : at + 2 + n_blocks])
                zeros = _quantize.bits_f32(row[at + 2 + slots : at + 2 + slots + n_blocks])
            else:
                scales = zeros = empty
            bucket_scales.setdefault(dt, []).append((n_blocks, scales, zeros))
            at += rec_len
        if at != row.size:
            raise CoalesceFallback("quant section does not match the fixed layout")
    return bucket_scales


def build_bucket_payload(
    states: Sequence[Dict[str, Any]],
    reductions_list: Sequence[Mapping[str, Reduction]],
    bucket_index: int,
    metadata_rows: Sequence[Any],
    sync_config: Optional[Any] = None,
) -> torch.Tensor:
    """This rank's padded flat payload for bucket ``bucket_index`` under the gathered
    ``metadata_rows``: the replay API with which a test fake plays each rank of a world.
    With an enabled ``sync_config`` it is the quantized byte stream the rank would ship
    (its scales match what ``build_local_metadata`` announced while the config's
    residual store is unchanged)."""
    leaves = _prepare_leaves(states, reductions_list)
    qctx = _make_qctx(leaves, sync_config)
    plan = _plan_from_rows(metadata_rows, leaves, qctx)
    dtype = list(plan.buckets)[bucket_index]
    if _bucket_quantized(plan, dtype):
        return _local_bucket_bytes(leaves, plan, dtype, qctx)
    return _local_bucket_flat(leaves, plan, dtype)


def _leaves_device(leaves: Sequence[_Leaf]) -> torch.device:
    """Where this rank's leaves live (the first that holds data); the CPU if none does."""
    return next((leaf.array.device for leaf in leaves if leaf.array is not None), torch.device("cpu"))


def _local_bucket_flat(leaves: Sequence[_Leaf], plan: _WorldPlan, dtype: torch.dtype) -> torch.Tensor:
    device = _leaves_device(leaves)
    parts = [leaves[li].array.reshape(-1).to(device) for li in plan.buckets[dtype] if leaves[li].array is not None]
    flat = (torch.cat(parts) if parts else torch.zeros((0,), dtype=dtype, device=device)).to(dtype)
    totals = [sum(plan.leaf_plans[li].counts[r] for li in plan.buckets[dtype]) for r in range(plan.world)]
    pad = max(totals) - int(flat.shape[0])
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=dtype, device=device)])
    return flat


def _bucket_quantized(plan: _WorldPlan, dtype: torch.dtype) -> bool:
    """Whether a bucket ships as a quantized byte stream: some rank announced a codec
    for one of its leaves, and there is more than one rank (a world of one skips the
    codec: a lossy round trip with nobody to ship to would be pure error)."""
    if plan.quant is None or plan.world <= 1:
        return False
    return any(code != 0 for li in plan.buckets[dtype] for code in plan.quant.leaf_codes[li])


def _bucket_byte_totals(plan: _WorldPlan, dtype: torch.dtype) -> List[int]:
    """Per-rank wire bytes of a quantized bucket (metadata only)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return [
        sum(plan.leaf_plans[li].counts[r] * _quantize.codec_width(plan.quant.leaf_codes[li][r], itemsize)
            for li in plan.buckets[dtype])
        for r in range(plan.world)
    ]


def _local_bucket_bytes(leaves: Sequence[_Leaf], plan: _WorldPlan, dtype: torch.dtype,
                        qctx: _quantize.QuantContext) -> torch.Tensor:
    """This rank's byte-stream payload of a quantized bucket: exact leaves as their raw
    bytes (bit for bit), quantized leaves as their codec payloads, zero-padded to the
    world's largest byte total."""
    device = _leaves_device(leaves)
    parts = []
    for li in plan.buckets[dtype]:
        leaf = leaves[li]
        if leaf.array is None:
            continue
        if qctx.leaf_code(li) == 0:
            parts.append(_quantize.to_bytes(leaf.array.to(device=device, dtype=dtype)))
        else:
            parts.append(qctx.payloads[li].to(device))
    flat = torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.uint8, device=device)
    pad = max(_bucket_byte_totals(plan, dtype)) - int(flat.shape[0])
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=torch.uint8, device=device)])
    return flat


def _decode_bucket_rows(plan: _WorldPlan, dtype: torch.dtype,
                        rows_b: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Per-(rank, leaf) tensors of one quantized bucket: each rank's segment decodes
    under that rank's own announced codes and scales (exact segments bitcast back bit
    for bit, int8 segments through the rank's block scales split by the allocation its
    encoder ran)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    leaf_idxs = plan.buckets[dtype]
    out: List[List[torch.Tensor]] = [[] for _ in leaf_idxs]
    for r in range(plan.world):
        if not plan.alive[r]:
            continue  # tombstoned rank: its row is zeros, the survivors fold on
        row = rows_b[r].to(torch.uint8)
        n_blocks_r, scales_r, zeros_r = plan.quant.bucket_scales[dtype][r]
        q_counts = [plan.leaf_plans[li].counts[r] for li in leaf_idxs
                    if plan.quant.leaf_codes[li][r] == _quantize.CODEC_INT8]
        blocks = _quantize.allocate_blocks(q_counts, _quantize.BUCKET_SCALE_SLOTS)
        if q_counts and sum(blocks) != n_blocks_r:
            raise CoalesceFallback("quant scales do not match the announced block count")
        offset = scale_off = qi = 0
        for j, li in enumerate(leaf_idxs):
            lp = plan.leaf_plans[li]
            n = lp.counts[r]
            code = plan.quant.leaf_codes[li][r]
            width = _quantize.codec_width(code, itemsize)
            seg = row[offset : offset + n * width]
            offset += n * width
            if code == _quantize.CODEC_BF16:
                arr = _quantize.from_bytes(seg, n, torch.bfloat16).to(dtype)
            elif code == _quantize.CODEC_INT8:
                nb = blocks[qi]
                arr = _quantize.block_dequantize(seg, scales_r[scale_off : scale_off + nb],
                                                 zeros_r[scale_off : scale_off + nb], n, dtype)
                scale_off += nb
                qi += 1
            else:
                arr = _quantize.from_bytes(seg, n, dtype)
            out[j].append(arr.reshape(lp.dims[r]))
    return out


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _transport_device(group: Any) -> torch.device:
    """NCCL collectives run on the card; every other backend (gloo) on the CPU."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_rows(value: Any, process_group: Any = None) -> List[torch.Tensor]:
    """Per-process rows of one all-gather over ``process_group`` (the default group if
    None), each on the device ``value`` came from. With a group initialized the
    collective always runs, a world of one included; without one the process is a world
    of one. Shared by both sync planes."""
    value = torch.as_tensor(value)
    if not (dist.is_available() and dist.is_initialized()):
        return [value]
    staged = value.to(_transport_device(process_group)).contiguous()
    rows = [torch.empty_like(staged) for _ in range(dist.get_world_size(process_group))]
    dist.all_gather(rows, staged, group=process_group)
    return [r.to(value.device) for r in rows]


def _make_gather(process_group: Any, dist_sync_fn: Optional[Callable]) -> Callable:
    if dist_sync_fn is not None:
        def gather(arr):
            return [torch.as_tensor(r) for r in dist_sync_fn(arr, process_group)]

        return gather
    return lambda arr: process_rows(arr, process_group)


def _gather_metadata(gather: Callable, meta: np.ndarray, process_group: Any, real: bool) -> List[np.ndarray]:
    """Collective #1: the metadata rows, back on the host. The real transport ships the
    row from the transport's device and brings all rows back in one device-to-host copy;
    an injected gather gets it on the CPU and may answer rows of any length."""
    vec = torch.from_numpy(meta)
    if not real:
        return [np.asarray(torch.as_tensor(r).cpu()) for r in gather(vec)]
    if dist.is_available() and dist.is_initialized():
        vec = vec.to(_transport_device(process_group))
    return list(torch.stack(gather(vec)).cpu().numpy())


def coalesced_process_sync(
    states: Sequence[Dict[str, Any]],
    reductions_list: Sequence[Mapping[str, Reduction]],
    process_group: Any = None,
    dist_sync_fn: Optional[Callable] = None,
    sync_config: Optional[Any] = None,
) -> List[Dict[str, Any]]:
    """Synchronize one or many state dicts across processes with one metadata
    collective plus one padded all-gather per dtype bucket.

    ``sync_config`` (:class:`~torchmetrics_tpu_torch.parallel.SyncConfig`) opts the
    eligible float buckets into the quantized byte-stream format: the same collectives,
    compressed payloads, the codecs and scales riding the metadata collective.
    Error-feedback residuals commit only after every bucket gathered.

    Returns new state dicts; the inputs are untouched, so a caller commits all of them
    or none. Raises :class:`CoalesceFallback` when the gathered metadata is unusable;
    the caller then runs the per-leaf plane (always exact).
    """
    from . import sync as _sync  # sync.py imports this module at its top

    leaves = _prepare_leaves(states, reductions_list)
    if sync_config is not None and dist_sync_fn is None and not _sync.distributed_available():
        # one process with the real transport: the world-of-one bypass would discard
        # the encoding anyway, so skip its cost (replay fakes keep theirs)
        sync_config = None
    qctx = _make_qctx(leaves, sync_config)
    rec = _observability._ACTIVE
    counters_vec = hist_vec = None
    if rec is not None and dist_sync_fn is None:
        counters_vec = rec.counters.counts_vector()
        hist_vec = rec.histograms.fleet_vector()
    meta = _encode_metadata(leaves, counters_vec, hist_vec, qctx)
    gather = _make_gather(process_group, dist_sync_fn)
    try:
        rows = _gather_metadata(gather, meta, process_group, real=dist_sync_fn is None)
    except Exception as err:
        # an injected gather written against the per-leaf seam may reject the metadata
        # vector (asserts on a state's dtype or shape): deterministic failures fall back
        # to the plane it was written for. Transient errors (FlakyGather and the like)
        # and errors of the real collective propagate to the retry layer: a local
        # fallback there would desynchronize the ranks and bypass the retry policy.
        if dist_sync_fn is not None and classify_exception(err) != TRANSIENT:
            raise CoalesceFallback(f"injected gather rejected the metadata vector: {err!r}") from err
        raise
    if rec is not None:  # counted at launch: a fallback keeps its collectives
        rec.counters.record_sync_collectives(1)
    plan = _plan_from_rows(rows, leaves, qctx)
    if dist_sync_fn is None:
        _deposit_fleet_rows(plan, rec)
    per_leaf_gathered: List[Optional[List[torch.Tensor]]] = [None] * len(leaves)
    quant_stats = {"buckets": 0, "raw_bytes": 0, "shipped_bytes": 0}
    for dtype, leaf_idxs in plan.buckets.items():
        quantized = _bucket_quantized(plan, dtype)
        if quantized:
            flat = _local_bucket_bytes(leaves, plan, dtype, qctx)
            quant_stats["buckets"] += 1
            quant_stats["shipped_bytes"] += int(flat.numel())
            quant_stats["raw_bytes"] += max(
                sum(plan.leaf_plans[li].counts[r] for li in leaf_idxs) for r in range(plan.world)
            ) * torch.empty((), dtype=dtype).element_size()
        else:
            flat = _local_bucket_flat(leaves, plan, dtype)
        rows_b = gather(flat)  # one collective serves every leaf of this dtype
        if rec is not None:
            rec.counters.record_sync_collectives(1)
            # the bucketed collective's payload size, from metadata
            rec.record_gather_payload("coalesced", flat.numel() * flat.element_size())
        if len(rows_b) != plan.world:
            raise CoalesceFallback("bucket gather returned a different world size than the metadata")
        if quantized:
            for j, gathered in enumerate(_decode_bucket_rows(plan, dtype, rows_b)):
                li = leaf_idxs[j]
                per_leaf_gathered[li] = (per_leaf_gathered[li] or []) + gathered
            continue
        for r in range(plan.world):
            if not plan.alive[r]:
                continue  # tombstoned rank: its row is zeros, the survivors fold on
            offset = 0
            row = rows_b[r]
            for li in leaf_idxs:
                lp = plan.leaf_plans[li]
                n = lp.counts[r]
                seg = row[offset : offset + n].reshape(lp.dims[r])
                offset += n
                if per_leaf_gathered[li] is None:
                    per_leaf_gathered[li] = []
                per_leaf_gathered[li].append(seg)
    if qctx is not None:
        # every bucket gathered: the sync succeeded and the residuals may commit (a
        # failure above left the store untouched, so a retry quantizes from the same base)
        commit_stats = qctx.commit(plan.world)
        if rec is not None and quant_stats["buckets"]:
            rec.record_quant(
                "coalesced_sync", sync_config.codec,
                buckets=quant_stats["buckets"],
                leaves=commit_stats["leaves_quantized"],
                raw_bytes=quant_stats["raw_bytes"],
                shipped_bytes=quant_stats["shipped_bytes"] + 4 * sum(_quant_record_lens(qctx)),
                feedback_norm=sync_config.residual_norm(),
            )
    outs = [dict(s) for s in states]
    for leaf, gathered in zip(leaves, per_leaf_gathered):
        if gathered is None:
            continue  # every rank empty: keep the local value (per-leaf semantics)
        if leaf.is_list:
            vals = [g for g in gathered if g.shape[0] > 0]
            outs[leaf.state_idx][leaf.name] = vals or leaf.original
        else:
            outs[leaf.state_idx][leaf.name] = _sync._fold_gathered(gathered, leaf.fx)
    if rec is not None:
        rec.counters.record_coalesced(sum(1 for g in per_leaf_gathered if g is not None))
    # liveness bookkeeping last: only a sync that fully committed may mark ranks dead
    # or reconcile a rejoin (a failed gather retries from scratch)
    dead = [r for r in range(plan.world) if not plan.alive[r]]
    rejoined = [r for r in range(plan.world) if plan.alive[r] and r in _DEAD_RANKS]
    for r in dead:
        _DEAD_RANKS[r] = _DEAD_RANKS.get(r, 0) + 1
    for r in rejoined:
        # the rejoined rank's whole accumulator was part of this gather, so its missed
        # contribution just reconciled: nothing is counted twice
        _DEAD_RANKS.pop(r, None)
    if rec is not None:
        if dead:
            rec.record_degraded_sync("coalesced_sync", dead, plan.world)
        for r in rejoined:
            rec.record_rank_rejoin("coalesced_sync", r, plan.epochs[r])
    return outs


# ---------------------------------------------------------------------------
# fleet-counter piggyback mailbox
# ---------------------------------------------------------------------------

_FLEET_MAILBOX: Dict[str, Any] = {"session_epoch": None, "rows": None, "hist_rows": None, "local_index": None}


def _deposit_fleet_rows(plan: _WorldPlan, rec: Any) -> None:
    if rec is None:
        return
    # keyed on the session epoch, not id(rec): a dead recorder's id can be reused by the
    # next allocation, which would leak stale rows across sessions
    _FLEET_MAILBOX["session_epoch"] = getattr(rec, "_epoch", None)
    _FLEET_MAILBOX["rows"] = [list(r) for r in plan.counter_rows]
    _FLEET_MAILBOX["hist_rows"] = [list(r) for r in plan.hist_rows]
    _FLEET_MAILBOX["local_index"] = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _fleet_rows(field: str, row_len: int) -> Optional[Tuple[List[List[int]], int]]:
    """The mailbox's rows of one kind, if they belong to the active session's epoch and
    have the expected length; else None (the caller launches a fresh collective)."""
    rec = _observability._ACTIVE
    if (
        rec is None
        or _FLEET_MAILBOX[field] is None
        or _FLEET_MAILBOX["session_epoch"] is None
        or _FLEET_MAILBOX["session_epoch"] != getattr(rec, "_epoch", None)
    ):
        return None
    rows = _FLEET_MAILBOX[field]
    if any(len(r) != row_len for r in rows):
        return None
    return [list(r) for r in rows], int(_FLEET_MAILBOX["local_index"])


def fleet_counter_rows() -> Optional[Tuple[List[List[int]], int]]:
    """Per-rank counter rows captured by the last coalesced sync's metadata collective,
    plus this process's index, or None when no coalesced sync ran under the active
    telemetry session. Remote rows are as of each rank's last sync (a rank without a
    session contributes zeros); the consumer replaces the local row with a fresh
    snapshot."""
    return _fleet_rows("rows", len(COUNTER_FIELDS))


def fleet_histogram_rows() -> Optional[Tuple[List[List[int]], int]]:
    """Per-rank fleet histogram vectors captured by the last coalesced sync's metadata
    collective (the discipline of :func:`fleet_counter_rows`), or None."""
    return _fleet_rows("hist_rows", _HIST_VEC_LEN)


def clear_fleet_mailbox() -> None:
    _FLEET_MAILBOX.update({"session_epoch": None, "rows": None, "hist_rows": None, "local_index": None})


def gather_host_rows(
    vector: Any, process_group: Any = None, dist_sync_fn: Optional[Callable] = None
) -> List[np.ndarray]:
    """One-collective gather of a fixed-length host metadata vector (equal length on
    every rank by contract, so no shape exchange). The rows come back on the host."""
    gather = _make_gather(process_group, dist_sync_fn)
    return [np.asarray(torch.as_tensor(r).cpu()) for r in gather(torch.as_tensor(np.asarray(vector)))]


# ---------------------------------------------------------------------------
# bucketed reduction over a process group
# ---------------------------------------------------------------------------

_NUMERIC_CLASS = {"sum": "sum", "mean": "sum", "max": "max", "min": "min"}
_REDUCE_OP = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _all_reduce(flat: torch.Tensor, cls: str, group: Any) -> torch.Tensor:
    staged = flat.to(_transport_device(group)).contiguous()
    dist.all_reduce(staged, op=_REDUCE_OP[cls], group=group)
    return staged.to(flat.device)


def reduce_many(
    pairs: Sequence[Tuple[Dict[str, Any], Mapping[str, Reduction]]], group: Any = None
) -> List[Dict[str, Any]]:
    """Reduce every leaf of one or many state dicts across the processes of ``group``
    (the default group if None) with one collective per (reduction class × dtype)
    bucket: an ``all_reduce`` for the sum (and mean), max and min buckets, and an
    ``all_gather`` per dtype for cat and custom leaves. Shapes are equal on every rank,
    so no metadata is exchanged. Requires an initialized process group.

    Produces what the per-leaf ``reduce_over_group`` would: the reductions are
    elementwise, so reducing the flat bucket and slicing it back changes nothing; cat
    and custom leaves are recovered from their gathered slice as ``(world, *shape)``.
    """
    outs = [dict(s) for s, _ in pairs]
    numeric: Dict[Tuple[str, torch.dtype], List[Tuple[int, str, torch.Tensor, Reduction]]] = {}
    gathered: Dict[torch.dtype, List[Tuple[int, str, torch.Tensor, Reduction, str]]] = {}
    for pi, (state, reds) in enumerate(pairs):
        for name, value in state.items():
            fx = reds.get(name)
            if fx is None:
                continue  # passthrough (per-leaf semantics)
            arr = torch.as_tensor(value)
            if callable(fx):
                gathered.setdefault(arr.dtype, []).append((pi, name, arr, fx, "custom"))
            elif fx in _NUMERIC_CLASS:
                numeric.setdefault((_NUMERIC_CLASS[fx], arr.dtype), []).append((pi, name, arr, fx))
            elif fx == "cat":
                arr = torch.atleast_1d(arr)
                gathered.setdefault(arr.dtype, []).append((pi, name, arr, fx, "cat"))
            else:
                raise ValueError(f"Unknown dist_reduce_fx: {fx!r}")
    world = dist.get_world_size(group)
    for (cls, _), leaves in numeric.items():
        red = _all_reduce(torch.cat([arr.reshape(-1) for _, _, arr, _ in leaves]), cls, group)
        offset = 0
        for pi, name, arr, fx in leaves:
            n = arr.numel()
            seg = red[offset : offset + n].reshape(arr.shape)
            offset += n
            outs[pi][name] = seg * (1.0 / world) if fx == "mean" else seg  # XLA's x / n is x * (1/n)
    for _, leaves in gathered.items():
        rows = process_rows(torch.cat([arr.reshape(-1) for _, _, arr, _, _ in leaves]), group)
        g = torch.stack(rows)  # (world, L)
        offset = 0
        for pi, name, arr, fx, mode in leaves:
            n = arr.numel()
            seg = g[:, offset : offset + n].reshape((world,) + tuple(arr.shape))
            offset += n
            if mode == "cat":
                outs[pi][name] = seg.reshape((world * arr.shape[0],) + tuple(arr.shape[1:]))
            else:
                outs[pi][name] = fx(seg)
    return outs


def quantized_payload_model(
    states: Sequence[Dict[str, Any]],
    reductions_list: Sequence[Mapping[str, Reduction]],
    sync_config: Optional[Any] = None,
    world: int = 2,
) -> Dict[str, int]:
    """Deterministic byte model of one sync over ``world`` identical ranks: what the
    exact plane would ship against what the quantized plane ships (payload plus scale
    metadata), in total and over the codec-eligible leaves alone. Metadata math and the
    scale computation only, no communication."""
    leaves = _prepare_leaves(states, reductions_list)
    qctx = _make_qctx(leaves, sync_config)
    meta = _encode_metadata(leaves, None, None, qctx)
    plan = _plan_from_rows([meta] * max(1, int(world)), leaves, qctx)
    out: Dict[str, int] = {
        "buckets": len(plan.buckets), "quantized_buckets": 0, "leaves_quantized": 0,
        "exact_bytes": 0, "shipped_bytes": 0, "quant_meta_bytes": 0,
        "eligible_exact_bytes": 0, "eligible_shipped_bytes": 0,
    }
    for dtype, leaf_idxs in plan.buckets.items():
        itemsize = torch.empty((), dtype=dtype).element_size()
        exact = max(sum(plan.leaf_plans[li].counts[r] for li in leaf_idxs) for r in range(plan.world)) * itemsize
        out["exact_bytes"] += exact
        if _bucket_quantized(plan, dtype):
            out["quantized_buckets"] += 1
            out["shipped_bytes"] += max(_bucket_byte_totals(plan, dtype))
        else:
            out["shipped_bytes"] += exact
    if qctx is not None and plan.world > 1:
        out["quant_meta_bytes"] = 4 * sum(_quant_record_lens(qctx))
        out["shipped_bytes"] += out["quant_meta_bytes"]
        for dt in qctx.bucket_order:
            quant_lis = [li for li in qctx.bucket_leaves[dt] if qctx.leaf_code(li) != 0]
            blocks = dict(zip(quant_lis, qctx.bucket_blocks[dt]))
            for li in quant_lis:
                code = qctx.leaf_code(li)
                arr = leaves[li].array
                out["leaves_quantized"] += 1
                out["eligible_exact_bytes"] += arr.numel() * arr.element_size()
                out["eligible_shipped_bytes"] += arr.numel() * _quantize.codec_width(code, arr.element_size())
                if code == _quantize.CODEC_INT8:
                    out["eligible_shipped_bytes"] += 8 * blocks[li]
    return out


def collective_counts(
    states: Sequence[Dict[str, Any]], reductions_list: Sequence[Mapping[str, Reduction]]
) -> Dict[str, int]:
    """Static collective-count model of a sync of these states: how many collectives
    each plane launches, coalesced and per leaf. No communication happens here. The
    ``in_graph_*`` keys keep the JAX package's names for the bucketed reduction over a
    group (:func:`reduce_many`). A quantized sync launches as many: its codecs and scales
    ride the metadata row."""
    in_graph_buckets: set = set()
    process_buckets: set = set()
    n_leaves = 0
    per_leaf_in_graph = 0
    for state, reds in zip(states, reductions_list):
        for name, value in state.items():
            fx = reds.get(name)
            n_leaves += 1
            if isinstance(value, list):
                arr = torch.as_tensor(value[0]) if value else None
            else:
                arr = torch.as_tensor(value)
            if arr is not None:
                process_buckets.add(arr.dtype)
            if fx is None:
                continue
            per_leaf_in_graph += 1
            if callable(fx) or fx == "cat":
                in_graph_buckets.add(("gather", arr.dtype if arr is not None else "?"))
            else:
                in_graph_buckets.add((_NUMERIC_CLASS[fx], arr.dtype))
    return {
        "leaves": n_leaves,
        "in_graph_coalesced": len(in_graph_buckets),
        "in_graph_per_leaf": per_leaf_in_graph,
        "process_coalesced": 1 + len(process_buckets),  # metadata + one per dtype
        # gather_all_arrays pays a shape exchange and a payload gather per leaf
        "process_per_leaf": 2 * n_leaves,
    }
