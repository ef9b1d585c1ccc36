"""``sepconv7``: the 7-tap "SAME" convolution of InceptionV3's 1x7 and 7x1 convs.

The Hopper port of ``tools/exp_sepconv.py:make_pallas_sepconv``. The kernel is
``torchmetrics_tpu_torch/csrc/sepconv7.cu``; its header states the bound and the design.
``sepconv7_reference`` is the plain PyTorch version of the same arithmetic: the wrapper
uses it for CPU tensors only, and on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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
    ``sepconv7_reference``.
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
    return out


sepconv7.launches = 0
