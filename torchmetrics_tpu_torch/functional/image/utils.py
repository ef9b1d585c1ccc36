"""Image kernel utilities (counterpart of ``torchmetrics_tpu/functional/image/utils.py``).

Gaussian and uniform filtering are grouped ``F.conv2d``/``F.conv3d`` calls run at full
float32 precision: TF32 is switched off for the call in cuDNN and cuBLAS alike and the
caller's settings come back after it, so a process that turns TF32 on globally gets
the same bits. The three padding flavours of the JAX package (``jnp.pad`` in
``"reflect"`` and ``"symmetric"`` mode, and the symmetric mode with an asymmetric tail)
are one index gather per axis: the indices are computed on the device from the
period of the mode, which is ``jnp.pad``'s result for any pad, also one as large as
the image or larger (``F.pad`` has no symmetric mode and refuses such reflect pads).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...utilities.checks import _as_tensor, resolve_device
from ...utilities.data import _jax_dtype


def _jax_tensor(x) -> torch.Tensor:
    """``x`` as the JAX package's ``jnp.asarray`` gives it, with 64-bit types off: a
    tensor stays on its device, anything else becomes one on the default device, and
    float64 rounds to float32 (int64 wraps to int32). So float64 input gives float32
    results, and a float64 image beside a float32 one is a float32 pair."""
    return _jax_dtype(_as_tensor(x))


def _image_device(img) -> torch.device:
    """Where a function of images runs: a tensor's device, else the default (CUDA)."""
    return img.device if isinstance(img, torch.Tensor) else resolve_device(None)


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """1D gaussian kernel ``(1, kernel_size)``, computed in float64 and rounded once to
    ``dtype``: the card's and the CPU's ``exp`` then give the same weights, where float32
    ``exp`` differs by a unit between them, a difference that UQI's variance terms
    amplify on smooth images. An integer dtype raises ``OverflowError`` where the window's
    first tap is negative, as ``jnp.arange`` does."""
    start = (1 - kernel_size) / 2
    if not dtype.is_floating_point and start < 0:
        raise OverflowError(f"Python integer {int(start)} out of bounds for {str(dtype).replace('torch.', '')}")
    dist = torch.arange(start, (1 + kernel_size) / 2, 1.0, dtype=torch.float64, device=device)
    gauss = torch.exp(-((dist / sigma) ** 2) / 2)
    return (gauss / gauss.sum()).to(dtype)[None, :]


def _gaussian_kernel_2d(channel: int, kernel_size: Sequence[int], sigma: Sequence[float],
                        dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Separable 2D gaussian kernel ``(channel, 1, h, w)``: the outer product of two 1D
    windows, one rounded product a tap (an elementwise product, never a matmul that
    TF32 could take)."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype, device)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel = kernel_x.reshape(-1, 1) * kernel_y.reshape(1, -1)
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1]).contiguous()


def _gaussian_kernel_3d(channel: int, kernel_size: Sequence[int], sigma: Sequence[float],
                        dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Separable 3D gaussian kernel ``(channel, 1, d, h, w)``: ``kernel_size[i]`` /
    ``sigma[i]`` act on spatial axis ``i`` of NCDHW — (depth, height, width)."""
    g_d = _gaussian(kernel_size[0], sigma[0], dtype, device).reshape(-1)
    g_h = _gaussian(kernel_size[1], sigma[1], dtype, device).reshape(-1)
    g_w = _gaussian(kernel_size[2], sigma[2], dtype, device).reshape(-1)
    kernel = g_d[:, None, None] * g_h[None, :, None] * g_w[None, None, :]
    return kernel.expand(channel, 1, *kernel.shape).contiguous()


@contextmanager
def _ieee_float32() -> Iterator[None]:
    """TF32 off in cuDNN and cuBLAS for the block; the caller's settings come back after."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


class _Conv2dFullPrecision(torch.autograd.Function):
    """``F.conv2d`` with TF32 off in its forward and in its backward: a backward runs
    when the caller asks for it, outside any ``_ieee_float32`` block of the forward, and
    would otherwise take the process's TF32 settings (cuDNN's default is on)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, groups, bias is not None)
        with _ieee_float32():
            return F.conv2d(x, weight, bias, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, groups, has_bias = ctx.conf
        grad_x = grad_w = grad_b = None
        with _ieee_float32():
            if ctx.needs_input_grad[0]:
                grad_x = torch.nn.grad.conv2d_input(x.shape, weight, grad, stride, padding, 1, groups)
            if ctx.needs_input_grad[1]:
                grad_w = torch.nn.grad.conv2d_weight(x, weight.shape, grad, stride, padding, 1, groups)
        if has_bias and ctx.needs_input_grad[2]:
            grad_b = grad.sum(dim=(0, 2, 3))
        return grad_x, grad_w, grad_b, None, None, None


def conv2d_full(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` at full float32 precision in the forward and in the backward."""
    return _Conv2dFullPrecision.apply(x, weight, bias, stride, padding, groups)


def _conv(conv, inputs: torch.Tensor, kernel: torch.Tensor, groups: int) -> torch.Tensor:
    """``conv`` at full float32 precision. A depthwise kernel (one input and one output
    channel a group, as every metric's window is) runs with the batch folded into the
    channel axis, ``(B, C, ...)`` as ``(1, B C, ...)``: the same sums a pixel, but on the
    card PyTorch's depthwise kernels, where a batch of single-channel images would go
    to cuDNN's implicit GEMM (``chip_smoke.py``'s image phases on an NVIDIA H100 80GB
    HBM3 at 700 W: a VIF update of 4 DIV2K images 30 ms against 181, a 3-D SSIM update
    of two BraTS volumes 72 ms against 399)."""
    batch, channels = inputs.shape[:2]
    with _ieee_float32():
        if kernel.shape[:2] == (channels, 1) and groups == channels:
            kernel = kernel.repeat(batch, *(1,) * (kernel.ndim - 1))
            out = conv(inputs.reshape(1, batch * channels, *inputs.shape[2:]), kernel, groups=batch * channels)
            return out.reshape(batch, channels, *out.shape[2:])
        return conv(inputs, kernel, groups=groups)


def conv2d(inputs: torch.Tensor, kernel: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """NCHW valid conv with an OIHW kernel (grouped when groups == channels), in full
    float32 precision whatever the process's TF32 settings."""
    return _conv(F.conv2d, inputs, kernel, groups)


def conv3d(inputs: torch.Tensor, kernel: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """NCDHW valid conv with an OIDHW kernel (full float32 precision, see ``conv2d``)."""
    return _conv(F.conv3d, inputs, kernel, groups)


def _pad_index(size: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """Source index of every padded position along one axis, as ``jnp.pad`` reads it:
    ``"reflect"`` repeats with period ``2 (size - 1)`` (no edge twice), ``"symmetric"``
    with period ``2 size`` (edges twice)."""
    i = torch.arange(-before, size + after, device=device)
    if mode == "reflect":
        if size == 1:
            return torch.zeros_like(i)
        period = 2 * (size - 1)
        m = i.remainder(period)
        return torch.where(m < size, m, period - m)
    period = 2 * size
    m = i.remainder(period)
    return torch.where(m < size, m, period - 1 - m)


def _pad(inputs: torch.Tensor, pads: Sequence[Tuple[int, int]], mode: str) -> torch.Tensor:
    """Pad the trailing ``len(pads)`` axes by ``(before, after)`` each in ``mode``."""
    first = inputs.ndim - len(pads)
    for axis, (before, after) in enumerate(pads, start=first):
        if before or after:
            inputs = inputs.index_select(axis, _pad_index(inputs.shape[axis], before, after, mode, inputs.device))
    return inputs


def reflect_pad_2d(inputs: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """``jnp.pad(mode="reflect")`` over H and W (no edge duplication)."""
    return _pad(inputs, ((pad_h, pad_h), (pad_w, pad_w)), "reflect")


def reflect_pad_3d(inputs: torch.Tensor, pad_d: int, pad_h: int, pad_w: int) -> torch.Tensor:
    return _pad(inputs, ((pad_d, pad_d), (pad_h, pad_h), (pad_w, pad_w)), "reflect")


def _symmetric_pad_2d(inputs: torch.Tensor, pad: int, outer_pad: int = 0) -> torch.Tensor:
    """scipy-style symmetric padding with an asymmetric tail: left ``pad``, right
    ``pad + outer_pad - 1``."""
    right = pad + outer_pad - 1
    return _pad(inputs, ((pad, right), (pad, right)), "symmetric")


def uniform_filter(inputs: torch.Tensor, window_size: int) -> torch.Tensor:
    """Uniform (box) filter with scipy-style symmetric padding; the output has the
    input's spatial shape."""
    padded = _symmetric_pad_2d(inputs, window_size // 2, window_size % 2)
    channel = inputs.shape[1]
    kernel = torch.ones((channel, 1, window_size, window_size), dtype=inputs.dtype, device=inputs.device)
    return conv2d(padded, kernel / (window_size**2), groups=channel)


def avg_pool2d(inputs: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool (NCHW), floor mode."""
    return F.avg_pool2d(inputs, 2, 2)


def avg_pool3d(inputs: torch.Tensor) -> torch.Tensor:
    return F.avg_pool3d(inputs, 2, 2)


def _sum64(x: torch.Tensor, dim=None) -> torch.Tensor:
    """A float sum accumulated in float64 and rounded once to ``x``'s dtype, so the
    card's and the CPU's orders of addition agree in the result's bits."""
    total = x.sum(dtype=torch.float64) if dim is None else x.sum(dim, dtype=torch.float64)
    return total.to(x.dtype)


def _mean64(x: torch.Tensor, dim=None) -> torch.Tensor:
    """A float mean accumulated in float64 and rounded once to ``x``'s dtype."""
    mean = x.mean(dtype=torch.float64) if dim is None else x.mean(dim, dtype=torch.float64)
    return mean.to(x.dtype)


def reduce(x: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    """``'elementwise_mean'`` (alias ``'mean'``), ``'sum'`` or ``'none'``/None; float
    reductions accumulate in float64."""
    if reduction in ("elementwise_mean", "mean"):
        return _mean64(x) if x.is_floating_point() else x.float().mean()
    if reduction == "none" or reduction is None:
        return x
    if reduction == "sum":
        return _sum64(x) if x.is_floating_point() else x.sum()
    raise ValueError("Reduction parameter unknown.")


def _check_image_pair(preds, target, require_dtype_match: bool = True, ndim: Tuple[int, ...] = (4,)):
    preds, target = _jax_tensor(preds), _jax_tensor(target)
    if require_dtype_match and preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    if tuple(preds.shape) != tuple(target.shape):
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    if preds.ndim not in ndim:
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {preds.shape} and target: {target.shape}."
        )
    return preds, target
