"""Quantized sync plane: opt-in compressed collective buckets (counterpart of
``torchmetrics_tpu/parallel/quantize.py``).

The coalesced sync plane (``parallel/coalesce.py``) ships one collective per dtype
bucket, each still at full f32/f64 width. This module is its compression tier:

- **bf16 codec**: eligible f32/f64 leaves cast to bfloat16 on the wire (2x / 4x) and
  back after the gather. Relative error <= 2^-8 per element (8 explicit mantissa bits,
  round to nearest even).
- **int8 codec**: eligible leaves block-quantized to uint8 with a per-block affine
  ``(scale, zero_point)`` (4x / 8x). Blocks come from a per-bucket slot pool and never
  cross leaf boundaries, so a leaf's worst-case error is ``scale/2`` of its own widest
  block: ``scale = block_range / 255``, absolute error <= ``range/510``.

**Metadata rides the metadata collective.** Each leaf's codec is announced in its leaf
record and each bucket's scale/zero vectors in a quant section of the same up-front
metadata row, so a quantized sync launches as many collectives as an exact one. Every
rank decodes rank ``r``'s segment with rank ``r``'s announced codes and scales, so no
cross-rank agreement on eligibility is needed.

**The exact path is forced for** integer/bool/bf16/f16 leaves (counts stay bit for bit),
custom-callable and ``fx=None`` leaves, leaves below :attr:`SyncConfig.min_leaf_bytes`,
leaves whose single-block worst-case error exceeds the caller's per-tag
:attr:`SyncConfig.error_budget`, and world-of-one syncs (a lossy round trip with nobody
to ship to would be pure error).

**Error feedback**: for additive tags (``sum``/``mean``) each sync's quantization
residual ``r_t = x'_t - dequant(quant(x'_t))`` is carried into the next sync's payload
(``x'_{t+1} = x_{t+1} + r_t``), so the drift of repeated syncs stays within one
quantization step: ``sum_t dequant_t = sum_t x_t + r_0 - r_N``. Residuals commit only
after every bucket of a sync gathered; a transient failure (``FlakyGather``), an
exhausted retry budget or a per-leaf ``CoalesceFallback`` leaves them untouched.

The sync codecs run as torch ops on the states' device (the JAX package's ``jnp``);
the per-block scales and the residuals live on the host, as there. The tenant-spill
codec at the end stays on the host (numpy; bfloat16 through a CPU torch cast, since
numpy has no bfloat16).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# wire codec codes (packed into the leaf records' kind slot, see coalesce.py)
CODEC_NONE = 0
CODEC_BF16 = 1
CODEC_INT8 = 2
CODEC_NAMES: Dict[str, int] = {"none": CODEC_NONE, "bf16": CODEC_BF16, "int8": CODEC_INT8}
_CODE_TO_NAME = {v: k for k, v in CODEC_NAMES.items()}

# reduction tags whose leaves may compress at all, and the subset that carries
# error-feedback residuals (feedback telescopes only through additive folds)
ELIGIBLE_TAGS = ("sum", "mean", "max", "min", "cat")
FEEDBACK_TAGS = ("sum", "mean")

# dtypes the codecs apply to (everything else ships exact)
_ELIGIBLE_DTYPES = (torch.float32, torch.float64)

# the metadata quant section carries one record per dtype in this tuple: a fixed layout,
# so the metadata row's length is the same on every rank even where empty list leaves
# hide a dtype on some ranks (the all-gather needs equal row shapes)
QUANT_SECTION_DTYPES = _ELIGIBLE_DTYPES

# reserved (scale, zero) slot pairs per dtype record: the int8 block pool a bucket's
# quantized leaves allocate from (every quantized leaf needs at least one block, so at
# most this many leaves of a bucket compress; the smallest candidates beyond it ship exact)
BUCKET_SCALE_SLOTS = 64

# spill-codec block cap (per leaf; the spill format is self-describing)
MIN_SCALE_SLOTS = 16

# equal to metric.QUANT_RESIDUAL_KEY (pinned by test): the residual store's keys
RESIDUAL_KEY_PREFIX = "__quant_err:"

_BF16_REL_ERR = 2.0 ** -8  # conservative per-element bound of the bf16 cast


@dataclasses.dataclass
class SyncConfig:
    """Opt-in compression knobs for one logical sync target (a metric or a collection).
    The instance owns the error-feedback residual store, so use one config per target
    (sharing one across unrelated syncs would cross-apply residuals) and call
    :meth:`clear_residuals` when the target starts a new epoch (``reset()``).

    Args:
        codec: ``"none"`` (exact, the default), ``"bf16"`` or ``"int8"``.
        error_feedback: carry quantization residuals across repeated syncs of additive
            (``sum``/``mean``) leaves (see the module docstring).
        error_budget: optional per-tag map (``{"sum": 1e-3}``) of the largest
            acceptable per-element absolute error; a leaf whose worst-case bound
            exceeds its tag's budget ships exact. Tags not in the map have no budget.
        min_leaf_bytes: leaves smaller than this ship exact (the scale metadata would
            cost more than the compression saves).

    Example:
        >>> from torchmetrics_tpu_torch.parallel import SyncConfig
        >>> cfg = SyncConfig(codec="int8", error_budget={"sum": 1e-3})
        >>> cfg.enabled, cfg.codec_code, cfg.residual_norm()
        (True, 2, 0.0)
    """

    codec: str = "none"
    error_feedback: bool = True
    error_budget: Optional[Mapping[str, float]] = None
    min_leaf_bytes: int = 64

    def __post_init__(self) -> None:
        if self.codec not in CODEC_NAMES:
            raise ValueError(f"codec must be one of {sorted(CODEC_NAMES)}, got {self.codec!r}")
        if self.min_leaf_bytes < 0:
            raise ValueError(f"min_leaf_bytes must be >= 0, got {self.min_leaf_bytes}")
        # residual key -> np.ndarray, guarded for the async worker, which commits from
        # its background thread
        self._residuals: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.codec != "none"

    @property
    def codec_code(self) -> int:
        return CODEC_NAMES[self.codec]

    # ------------------------------------------------------ residual store

    def _residual_key(self, state_idx: int, name: str) -> str:
        return f"{RESIDUAL_KEY_PREFIX}{state_idx}:{name}"

    def residual(self, state_idx: int, name: str) -> Optional[np.ndarray]:
        with self._lock:
            r = self._residuals.get(self._residual_key(state_idx, name))
            return None if r is None else np.array(r)

    def _commit_residuals(self, updates: Dict[str, np.ndarray]) -> None:
        with self._lock:
            self._residuals.update(updates)

    def residual_norm(self) -> float:
        """L2 norm over every stored residual: the ``quant_error_feedback_norm`` gauge
        (how much shipped value is owed to future syncs)."""
        with self._lock:
            total = 0.0
            for r in self._residuals.values():
                total += float(np.sum(np.square(np.asarray(r, np.float64))))
            return math.sqrt(total)

    def clear_residuals(self) -> None:
        with self._lock:
            self._residuals.clear()

    # residuals and the lock do not ride pickles: a SyncConfig is a knob object, the
    # residuals are session-local transport state
    def __getstate__(self) -> Dict[str, Any]:
        state = dict(self.__dict__)
        state["_residuals"] = {}
        state.pop("_lock", None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._residuals = {}
        self._lock = threading.Lock()


# ---------------------------------------------------------------------------
# block quantization (sync plane)
# ---------------------------------------------------------------------------


def codec_width(code: int, itemsize: int) -> int:
    """Wire bytes per element of a leaf announced under ``code``."""
    if code == CODEC_BF16:
        return 2
    if code == CODEC_INT8:
        return 1
    return itemsize


def allocate_blocks(counts: Sequence[int], slots: int) -> List[int]:
    """Deterministic per-leaf block allocation from a bucket's slot pool: every leaf
    gets at least one block (blocks never cross leaf boundaries, which keeps each leaf's
    error bound independent of its neighbours), extra slots go to bigger leaves by
    largest remainder, and no leaf gets more blocks than elements. Encoder and decoder
    both run this on the announced counts, so the scale vector needs no framing."""
    n = len(counts)
    if n == 0:
        return []
    blocks = [1] * n
    remaining = slots - n
    total = sum(counts)
    if remaining > 0 and total > 0:
        want = [c * remaining / total for c in counts]
        base = [int(w) for w in want]
        blocks = [b + w for b, w in zip(blocks, base)]
        leftover = remaining - sum(base)
        order = sorted(range(n), key=lambda i: (-(want[i] - base[i]), i))
        for i in order[:leftover]:
            blocks[i] += 1
    return [min(b, c) if c else 1 for b, c in zip(blocks, counts)]


def _block_edges(count: int, n_blocks: int) -> int:
    """Padded block length (edge-padded, so padding never widens a range)."""
    return -(-count // n_blocks)  # ceil


def block_quantize(flat: Any, n_blocks: int) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Affine uint8 block quantization of a flat float vector, on its device. Returns
    the unpadded uint8 payload and the host ``(scale, zero)`` float32 vectors, one entry
    per block (the values that ride the metadata collective)."""
    x = torch.as_tensor(flat).reshape(-1)
    count = int(x.shape[0])
    bl = _block_edges(count, n_blocks)
    pad = n_blocks * bl - count
    xp = (torch.cat([x, x[-1:].expand(pad)]) if pad else x).reshape(n_blocks, bl)
    mn = xp.amin(dim=1)
    mx = xp.amax(dim=1)
    scale = torch.where(mx > mn, (mx - mn) / 255.0, torch.ones_like(mn)).to(torch.float32)
    q = torch.clamp(torch.round((xp - mn[:, None]) / scale[:, None].to(xp.dtype)), 0, 255).to(torch.uint8)
    return q.reshape(-1)[:count], scale.cpu().numpy(), mn.to(torch.float32).cpu().numpy()


def block_dequantize(q_flat: Any, scale: np.ndarray, zero: np.ndarray, count: int, dtype: Any) -> torch.Tensor:
    """Inverse of :func:`block_quantize`, on the payload's device (the scales are
    float32, so f64 leaves dequantize with f32-precision offsets, dominated by the
    block error)."""
    q = torch.as_tensor(q_flat)
    n_blocks = len(scale)
    bl = _block_edges(count, n_blocks)
    pad = n_blocks * bl - count
    qf = q.reshape(-1).to(torch.float32)
    if pad:
        qf = torch.cat([qf, qf.new_zeros(pad)])
    s = torch.as_tensor(np.asarray(scale, np.float32)).to(q.device)
    z = torch.as_tensor(np.asarray(zero, np.float32)).to(q.device)
    x = qf.reshape(n_blocks, bl) * s[:, None] + z[:, None]
    return x.reshape(-1)[:count].to(dtype)


def int8_error_bound(flat: Any) -> float:
    """Worst-case per-element absolute error of int8-quantizing ``flat`` with a single
    block: the monotone upper bound the eligibility check uses (more blocks can only
    shrink the per-block ranges). One host read."""
    x = torch.as_tensor(flat).reshape(-1)
    if int(x.shape[0]) == 0:
        return 0.0
    return float((x.max() - x.min()) / 255.0) / 2.0


def bf16_error_bound(flat: Any) -> float:
    """Worst-case per-element absolute error of the bf16 cast. One host read."""
    x = torch.as_tensor(flat).reshape(-1)
    if int(x.shape[0]) == 0:
        return 0.0
    return float(x.abs().max()) * _BF16_REL_ERR


def to_bytes(arr: Any) -> torch.Tensor:
    """Bitwise view of a tensor as a flat uint8 vector, on its device (exact leaves in
    a byte-stream bucket round-trip bit for bit)."""
    x = torch.as_tensor(arr).reshape(-1)
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x.contiguous().view(torch.uint8)


def from_bytes(seg: Any, count: int, dtype: Any) -> torch.Tensor:
    """Inverse of :func:`to_bytes` for a ``count``-element vector."""
    u8 = torch.as_tensor(seg).to(torch.uint8).reshape(-1)
    if dtype == torch.bool:
        return u8[:count].to(torch.bool)
    itemsize = torch.empty((), dtype=dtype).element_size()
    u8 = u8[: count * itemsize]
    if u8.storage_offset() % itemsize:
        u8 = u8.clone()  # a view to a wider dtype needs an aligned offset
    return u8.view(dtype)


# ---------------------------------------------------------------------------
# per-sync encode context (built by coalesce.py before the metadata gather)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _LeafEnc:
    """One leaf's local encode decision."""

    code: int  # announced codec (CODEC_NONE when ineligible)
    feedback: bool = False
    x_eff: Any = None  # flat payload with the residual folded in (quantized leaves)
    new_residual: Optional[np.ndarray] = None  # committed only when the sync succeeds


class QuantContext:
    """Everything one rank announces and ships for one quantized sync: the per-leaf
    codec decisions, the per-bucket block allocations and scale vectors, and the
    candidate residuals (committed only after every bucket of the sync gathered)."""

    def __init__(self, config: SyncConfig, leaves: Sequence[Any]) -> None:
        self.config = config
        self.leaves = leaves
        self.encs: List[_LeafEnc] = [self._decide(leaf) for leaf in leaves]
        # bucket layout mirrors coalesce: dtype -> leaf indices in first-appearance
        # order over the leaves that hold data
        self.bucket_order: List[torch.dtype] = []
        self.bucket_leaves: Dict[torch.dtype, List[int]] = {}
        for i, leaf in enumerate(leaves):
            if leaf.array is None:
                continue
            dt = leaf.array.dtype
            if dt not in self.bucket_leaves:
                self.bucket_order.append(dt)
                self.bucket_leaves[dt] = []
            self.bucket_leaves[dt].append(i)
        self.bucket_blocks: Dict[torch.dtype, List[int]] = {}
        self.bucket_scales: Dict[torch.dtype, np.ndarray] = {}
        self.bucket_zeros: Dict[torch.dtype, np.ndarray] = {}
        self.payloads: Dict[int, torch.Tensor] = {}  # leaf idx -> wire uint8 payload
        for dt in self.bucket_order:
            self._encode_bucket(dt)

    # ------------------------------------------------------------ decisions

    def _decide(self, leaf: Any) -> _LeafEnc:
        cfg = self.config
        arr = leaf.array
        if arr is None:
            return _LeafEnc(CODEC_NONE)
        fx = leaf.fx
        tag = fx if isinstance(fx, str) else None
        if tag not in ELIGIBLE_TAGS:
            return _LeafEnc(CODEC_NONE)  # custom _merge / fx=None: exact
        if arr.dtype not in _ELIGIBLE_DTYPES:
            return _LeafEnc(CODEC_NONE)  # ints/bool/bf16/f16: exact
        if arr.numel() == 0 or arr.numel() * arr.element_size() < cfg.min_leaf_bytes:
            return _LeafEnc(CODEC_NONE)  # nothing to compress / under the floor
        feedback = cfg.error_feedback and tag in FEEDBACK_TAGS
        x = arr.reshape(-1)
        if feedback:
            r = cfg.residual(leaf.state_idx, leaf.name)
            if r is not None and r.shape == (int(x.shape[0]),):
                x = x + torch.as_tensor(r).to(device=x.device, dtype=x.dtype)
        budget = (cfg.error_budget or {}).get(tag)
        if budget is not None:
            bound = int8_error_bound(x) if cfg.codec == "int8" else bf16_error_bound(x)
            if bound > budget:
                return _LeafEnc(CODEC_NONE)
        return _LeafEnc(cfg.codec_code, feedback=feedback, x_eff=x)

    # ------------------------------------------------------------- encoding

    def _empty_bucket(self, dt: torch.dtype) -> None:
        self.bucket_blocks[dt] = []
        self.bucket_scales[dt] = np.zeros((0,), np.float32)
        self.bucket_zeros[dt] = np.zeros((0,), np.float32)

    def _encode_bucket(self, dt: torch.dtype) -> None:
        cfg = self.config
        quant_lis = [li for li in self.bucket_leaves[dt] if self.encs[li].code != CODEC_NONE]
        if cfg.codec == "int8" and len(quant_lis) > BUCKET_SCALE_SLOTS:
            # more candidates than the int8 block pool holds: the smallest leaves ship
            # exact (peers see it in the per-leaf announcements). bf16 needs no slots.
            by_size = sorted(quant_lis, key=lambda li: (-int(self.encs[li].x_eff.shape[0]), li))
            for li in by_size[BUCKET_SCALE_SLOTS:]:
                self.encs[li] = _LeafEnc(CODEC_NONE)
            quant_lis = sorted(by_size[:BUCKET_SCALE_SLOTS])
        if not quant_lis or cfg.codec == "bf16":
            for li in quant_lis:
                enc = self.encs[li]
                y = enc.x_eff.to(torch.bfloat16)
                self.payloads[li] = to_bytes(y)
                if enc.feedback:
                    enc.new_residual = (enc.x_eff - y.to(enc.x_eff.dtype)).to(torch.float32).cpu().numpy()
            self._empty_bucket(dt)
            return
        counts = [int(self.encs[li].x_eff.shape[0]) for li in quant_lis]
        blocks = allocate_blocks(counts, BUCKET_SCALE_SLOTS)
        scales: List[np.ndarray] = []
        zeros: List[np.ndarray] = []
        for li, nb in zip(quant_lis, blocks):
            enc = self.encs[li]
            q, s, z = block_quantize(enc.x_eff, nb)
            self.payloads[li] = q
            scales.append(s)
            zeros.append(z)
            if enc.feedback:
                deq = block_dequantize(q, s, z, int(enc.x_eff.shape[0]), enc.x_eff.dtype)
                enc.new_residual = (enc.x_eff - deq).to(torch.float32).cpu().numpy()
        self.bucket_blocks[dt] = blocks
        self.bucket_scales[dt] = np.concatenate(scales)
        self.bucket_zeros[dt] = np.concatenate(zeros)

    def leaf_code(self, li: int) -> int:
        return self.encs[li].code

    # -------------------------------------------------------------- commit

    def commit(self, world: int) -> Dict[str, Any]:
        """Install the candidate residuals (the sync succeeded end to end) and return
        the local compression stats. A world-of-one sync never shipped a compressed
        byte, so nothing commits."""
        stats = {"leaves_quantized": 0, "feedback_leaves": 0}
        if world <= 1:
            return stats
        updates: Dict[str, np.ndarray] = {}
        for leaf, enc in zip(self.leaves, self.encs):
            if enc.code == CODEC_NONE:
                continue
            stats["leaves_quantized"] += 1
            if enc.new_residual is not None:
                updates[self.config._residual_key(leaf.state_idx, leaf.name)] = enc.new_residual
                stats["feedback_leaves"] += 1
        if updates:
            self.config._commit_residuals(updates)
        return stats


def f32_bits(values: np.ndarray) -> np.ndarray:
    """f32 vector -> int32 bit patterns (the metadata row is int32)."""
    return np.asarray(values, np.float32).view(np.int32)


def bits_f32(values: Sequence[int]) -> np.ndarray:
    """Inverse of :func:`f32_bits` (takes the decoder's int64 upcast)."""
    return np.asarray(list(values), np.int64).astype(np.int32).view(np.float32)


# ---------------------------------------------------------------------------
# tenant-spill codec (serving/engine.py LRU spill payloads), on the host
# ---------------------------------------------------------------------------

_SPILL_MARK = "__codec__"


def _np_block_quantize(x: np.ndarray, n_blocks: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy mirror of :func:`block_quantize`: the spill path relieves device pressure,
    so its codec never sends the host rows back through the card."""
    x = np.ravel(x)
    count = x.size
    bl = _block_edges(count, n_blocks)
    xp = np.pad(x, (0, n_blocks * bl - count), mode="edge").reshape(n_blocks, bl)
    mn = xp.min(axis=1)
    mx = xp.max(axis=1)
    rng = mx - mn
    scale = np.where(rng > 0, rng / 255.0, 1.0).astype(np.float32)
    q = np.clip(np.round((xp - mn[:, None]) / scale[:, None].astype(xp.dtype)), 0, 255).astype(np.uint8)
    return q.ravel()[:count], scale, mn.astype(np.float32)


def _np_block_dequantize(q: np.ndarray, scale: np.ndarray, zero: np.ndarray, count: int, dtype: Any) -> np.ndarray:
    n_blocks = len(scale)
    bl = _block_edges(count, n_blocks)
    qp = np.pad(np.ravel(q).astype(np.float32), (0, n_blocks * bl - count)).reshape(n_blocks, bl)
    x = qp * scale[:, None] + zero[:, None]
    return x.ravel()[:count].astype(dtype)


def _bf16_bits(arr: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even bfloat16 of a host array, as its uint16 bit patterns (what
    ``ml_dtypes``' cast stores, byte for byte)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_values(bits: np.ndarray, dtype: Any) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)
    return t.to(torch.float64 if np.dtype(dtype) == np.float64 else torch.float32).numpy().astype(dtype)


def encode_spill_state(state: Dict[str, Any], codec: str) -> Dict[str, Any]:
    """Compress one spilled tenant's host state rows, on the host. Float32/float64
    leaves compress under ``codec``; everything else (int/bool counts, sub-f32 floats)
    stays raw, so count states survive spill and readmission bit for bit. Each
    spill-readmit cycle is one bounded quantization round trip (no error feedback:
    spill is storage, not an additive fold)."""
    if codec == "none":
        return dict(state)
    out: Dict[str, Any] = {}
    for name, value in state.items():
        arr = np.asarray(value)
        if arr.dtype not in (np.float32, np.float64) or arr.size < 32:
            # tiny leaves: the scale/shape envelope would cost more than it saves
            out[name] = arr
            continue
        if codec == "bf16":
            out[name] = {_SPILL_MARK: "bf16", "q": _bf16_bits(arr), "dtype": arr.dtype.str, "shape": arr.shape}
        else:  # int8
            n_blocks = min(MIN_SCALE_SLOTS, max(1, arr.size // 64 or 1))
            q, s, z = _np_block_quantize(arr, n_blocks)
            out[name] = {
                _SPILL_MARK: "int8", "q": q, "scale": s, "zero": z, "dtype": arr.dtype.str, "shape": arr.shape,
            }
    return out


def decode_spill_state(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Decompress a (possibly codec-encoded) spilled state back to raw host arrays. Raw
    states pass through untouched, so every reader takes both."""
    out: Dict[str, np.ndarray] = {}
    for name, value in state.items():
        if isinstance(value, dict) and _SPILL_MARK in value:
            dtype = np.dtype(value["dtype"])
            shape = tuple(value["shape"])
            if value[_SPILL_MARK] == "bf16":
                out[name] = _bf16_values(value["q"], dtype).reshape(shape)
            else:
                count = int(np.prod(shape)) if shape else 1
                out[name] = _np_block_dequantize(value["q"], value["scale"], value["zero"], count, dtype).reshape(shape)
        else:
            out[name] = np.asarray(value)
    return out


def spill_state_bytes(state: Dict[str, Any]) -> int:
    """Host bytes a (possibly encoded) spilled state occupies, from metadata (shape x
    itemsize of what is stored, scales included)."""
    total = 0
    for value in state.values():
        if isinstance(value, dict) and _SPILL_MARK in value:
            for part in ("q", "scale", "zero"):
                arr = value.get(part)
                if arr is not None:
                    a = np.asarray(arr)
                    total += int(a.size) * a.dtype.itemsize
        else:
            a = np.asarray(value)
            total += int(a.size) * a.dtype.itemsize
    return total
