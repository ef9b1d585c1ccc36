"""``sepconv7``: the 7-tap "SAME" convolution of InceptionV3's 1x7 and 7x1 convs.

The Hopper port of ``tools/exp_sepconv.py:make_pallas_sepconv``. The kernel is
``torchmetrics_tpu_torch/csrc/sepconv7.cu``; its header states the bound and the design.
``sepconv7_reference`` is the plain PyTorch version of the same arithmetic: the wrapper
uses it for CPU tensors only, and on a CUDA tensor it launches the kernel or raises.

``sepconv7_rows`` is the same conv as a ``torch.library`` op with a ``torch.func.vmap``
batching rule: the serving engine's megabatch runs the trunk under ``vmap`` over its
tenant rows, and the rule folds the rows into the conv's batch axis, so one launch serves
every row (a ctypes launch cannot take a batched tensor's ``data_ptr``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..observability import costs as _obs_costs
from ._build import NativeKernel

TAPS = 7
_AXIS_DIM = {"W": 3, "H": 2}  # 1x7 convs run along W, 7x1 convs along H
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# positions along the conv axis: one line must fit one tile (csrc/sepconv7.cu tc::MAX_ROWS)
# and one strip with its halo (tc::STRIP_ROWS = 400 rows)
_MAX_LINE = 384
# a packed weight slice: 64 outputs x 64 bytes of channels x 7 taps, per (O-tile, channel
# chunk); float32 packs two parts, TF32 hi and lo (csrc/sepconv7.cu tc::N_TILE,
# tc::CHUNK_BYTES, Tf32::W_PARTS)
_PACK_O, _PACK_BYTES = 64, 64
_PACK_PARTS = {torch.float32: 2, torch.bfloat16: 1}

KERNEL = NativeKernel(
    "sepconv7.cu",
    "sepconv7_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
)


def packed_weight_numel(channels: int, out_channels: int, dtype: torch.dtype) -> int:
    """Values of ``dtype`` of scratch the kernel packs ``w`` into: zero-padded
    (O-tile, channel chunk) slices in the tensor cores' layout. A chunk is 32 bfloat16
    or 16 float32 channels; a float32 slice holds the TF32 hi and lo parts."""
    chunk = _PACK_BYTES // dtype.itemsize
    return -(-out_channels // _PACK_O) * -(-channels // chunk) * _PACK_PARTS[dtype] * TAPS * chunk * _PACK_O


def _axis_dim(axis: str) -> int:
    if axis not in _AXIS_DIM:
        raise ValueError(f"sepconv7: axis must be 'W' (a 1x7 conv) or 'H' (a 7x1 conv), got {axis!r}")
    return _AXIS_DIM[axis]


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 4 or w.ndim != 3 or w.shape[2] != TAPS or w.shape[1] != x.shape[1]:
        raise ValueError(
            f"sepconv7: expected x (B, C, H, W) and w (O, C, {TAPS}), got {tuple(x.shape)} and {tuple(w.shape)}"
        )


def sepconv7_reference(x: torch.Tensor, w: torch.Tensor, axis: str) -> torch.Tensor:
    """Plain PyTorch version: 7 shifted slices of the zero-padded input, each times its
    weight slice, summed in f32; the result has ``x``'s dtype."""
    dim = _axis_dim(axis)
    _check_shapes(x, w)
    length = x.shape[dim]
    xp = F.pad(x.float(), (3, 3) if dim == 3 else (0, 0, 3, 3))
    wf = w.float()
    out = sum(torch.einsum("bchw,oc->bohw", xp.narrow(dim, k, length), wf[:, :, k]) for k in range(TAPS))
    return out.to(x.dtype)


def sepconv7(x: torch.Tensor, w: torch.Tensor, axis: str) -> torch.Tensor:
    """7-tap "SAME" conv of ``x (B, C, H, W)`` with ``w (O, C, 7)`` along ``axis``
    (``"W"`` for a 1x7 conv, ``"H"`` for a 7x1 conv) -> ``(B, O, H, W)`` in ``x``'s dtype.

    CUDA tensors (float32 or bfloat16, contiguous) launch the kernel on the tensor cores
    (``wgmma``) and count one in ``sepconv7.launches``: bfloat16 directly, float32 as three
    TF32 products of split operands (hi and lo), to f32 accuracy. CPU tensors take
    ``sepconv7_reference``. A launch adds its ``2·B·C·O·H·W·7`` flops to every open
    telemetry cost harvest: the ctypes launch is invisible to ``FlopCounterMode``.
    """
    dim = _axis_dim(axis)
    _check_shapes(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return sepconv7_reference(x, w, axis)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"sepconv7: x and w must both lie on one CUDA device, got {x.device} and {w.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"sepconv7: x and w must both be float32 or bfloat16, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("sepconv7: x and w must be contiguous")
    if x.shape[dim] > _MAX_LINE:
        raise ValueError(f"sepconv7: at most {_MAX_LINE} positions along the conv axis, got {x.shape[dim]}")
    batch, channels, height, width = x.shape
    out_channels = w.shape[0]
    out = torch.empty((batch, out_channels, height, width), dtype=x.dtype, device=x.device)
    wpack = torch.empty(packed_weight_numel(channels, out_channels, x.dtype), dtype=x.dtype, device=x.device)
    launch = KERNEL.function()
    with torch.cuda.device(x.device):
        rc = launch(
            x.data_ptr(), w.data_ptr(), wpack.data_ptr(), out.data_ptr(),
            batch, channels, height, width, out_channels, dim, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sepconv7: kernel launch failed with CUDA error {rc}")
    sepconv7.launches += 1
    _obs_costs.add_flops(2 * batch * channels * out_channels * height * width * TAPS)
    return out


sepconv7.launches = 0


@torch.library.custom_op("torchmetrics_tpu_torch::sepconv7_rows", mutates_args=())
def sepconv7_rows(x: torch.Tensor, w: torch.Tensor, axis: str) -> torch.Tensor:
    """:func:`sepconv7` as an op that batches under ``torch.func.vmap`` (one launch for
    every vmapped row); outside ``vmap`` it is :func:`sepconv7`."""
    return sepconv7(x.contiguous(), w.contiguous(), axis)


@sepconv7_rows.register_fake
def _(x: torch.Tensor, w: torch.Tensor, axis: str) -> torch.Tensor:
    return x.new_empty((x.shape[0], w.shape[0], x.shape[2], x.shape[3]))


@sepconv7_rows.register_vmap
def _(info, in_dims, x, w, axis):
    """Rows of a vmapped ``x (rows, B, C, H, W)`` fold into one ``(rows·B, C, H, W)``
    launch. Batched weights (never the trunk's: its weights are buffers) take one launch
    a row."""
    rows = info.batch_size
    x_dim, w_dim = in_dims[0], in_dims[1]
    if w_dim is not None:
        xs = x.movedim(x_dim, 0) if x_dim is not None else x.expand(rows, *x.shape)
        ws = w.movedim(w_dim, 0)
        return torch.stack([sepconv7_rows(xs[r], ws[r], axis) for r in range(rows)]), 0
    xs = x.movedim(x_dim, 0)
    out = sepconv7_rows(xs.reshape((-1,) + tuple(xs.shape[2:])), w, axis)
    return out.reshape((rows, xs.shape[1]) + tuple(out.shape[1:])), 0
