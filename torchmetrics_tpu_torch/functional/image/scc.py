"""Spatial Correlation Coefficient (counterpart of ``torchmetrics_tpu/functional/image/scc.py``).

The JAX package loops over the channels; the port stacks them into the batch axis, so
the high-pass filter is one convolution over every channel and the local moments are
one more over the five stacked moment images (each channel alone, as there)."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .utils import _jax_tensor, _mean64, _pad, conv2d


def _default_hp_filter(device) -> torch.Tensor:
    """The 3x3 Laplacian ``[[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]]``, made on ``device``."""
    kernel = torch.full((3, 3), -1.0, device=device)
    kernel[1, 1] = 8.0
    return kernel


def _scc_update(preds, target, hp_filter, window_size: int):
    preds, target = _jax_tensor(preds), _jax_tensor(target)
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    if tuple(preds.shape) != tuple(target.shape):
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    if preds.ndim not in (3, 4):
        raise ValueError(
            "Expected `preds` and `target` to have batch of colored images with BxCxHxW shape"
            "  or batch of grayscale images of BxHxW shape."
            f" Got preds: {preds.shape} and target: {target.shape}."
        )
    if preds.ndim == 3:
        preds = preds[:, None]
        target = target[:, None]
    if not window_size > 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got {window_size}.")
    if window_size > preds.shape[2] or window_size > preds.shape[3]:
        raise ValueError(
            f"Expected `window_size` to be less than or equal to the size of the image."
            f" Got window_size: {window_size} and image size: {preds.shape[2]}x{preds.shape[3]}."
        )
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    hp_filter = _default_hp_filter(preds.device) if hp_filter is None else hp_filter
    hp_filter = torch.as_tensor(hp_filter, dtype=preds.dtype, device=preds.device)[None, None, :]
    return preds, target, hp_filter


def _symmetric_reflect_pad_2d(img: torch.Tensor, pad: Union[int, Tuple[int, ...]]) -> torch.Tensor:
    """``jnp.pad(mode="symmetric")`` by ``(left, right, top, bottom)``."""
    if isinstance(pad, int):
        pad = (pad, pad, pad, pad)
    if len(pad) != 4:
        raise ValueError(f"Expected padding to have length 4, but got {len(pad)}")
    return _pad(img, ((pad[2], pad[3]), (pad[0], pad[1])), "symmetric")


def _signal_convolve_2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """scipy.signal-style 2D convolution: symmetric pad and flipped kernel."""
    left = math.floor((kernel.shape[3] - 1) / 2)
    right = math.ceil((kernel.shape[3] - 1) / 2)
    top = math.floor((kernel.shape[2] - 1) / 2)
    bottom = math.ceil((kernel.shape[2] - 1) / 2)
    padded = _symmetric_reflect_pad_2d(img, pad=(left, right, top, bottom))
    return conv2d(padded, kernel.flip((2, 3)))


def _hp_2d_laplacian(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    return _signal_convolve_2d(img, kernel) * 2.0


def _local_variance_covariance(preds: torch.Tensor, target: torch.Tensor, window: torch.Tensor):
    left = math.ceil((window.shape[3] - 1) / 2)
    right = math.floor((window.shape[3] - 1) / 2)
    preds = F.pad(preds, (left, right, left, right))
    target = F.pad(target, (left, right, left, right))
    moments = torch.cat([preds, target, preds**2, target**2, target * preds])
    preds_mean, target_mean, preds_sq, target_sq, target_preds = conv2d(moments, window).split(preds.shape[0])
    preds_var = preds_sq - preds_mean**2
    target_var = target_sq - target_mean**2
    target_preds_cov = target_preds - target_mean * preds_mean
    return preds_var, target_var, target_preds_cov


def _scc_map(preds: torch.Tensor, target: torch.Tensor, hp_filter: torch.Tensor, window_size: int) -> torch.Tensor:
    """The per-pixel SCC map ``(B, C, H, W)``; every channel alone, stacked in the batch."""
    batch, channels, height, width = preds.shape
    window = torch.ones((1, 1, window_size, window_size), dtype=preds.dtype, device=preds.device) / (window_size**2)
    stacked = torch.cat([preds.reshape(-1, 1, height, width), target.reshape(-1, 1, height, width)])
    preds_hp, target_hp = _hp_2d_laplacian(stacked, hp_filter).split(batch * channels)
    preds_var, target_var, target_preds_cov = _local_variance_covariance(preds_hp, target_hp, window)
    preds_var = torch.clamp(preds_var, min=0)
    target_var = torch.clamp(target_var, min=0)
    den = torch.sqrt(target_var) * torch.sqrt(preds_var)
    zero = den == 0
    scc = torch.where(zero, torch.zeros_like(den), target_preds_cov / torch.where(zero, torch.ones_like(den), den))
    return scc.reshape(batch, channels, *scc.shape[2:])


def spatial_correlation_coefficient(
    preds,
    target,
    hp_filter: Optional[torch.Tensor] = None,
    window_size: int = 8,
    reduction: Optional[str] = "mean",
) -> torch.Tensor:
    """SCC: local correlation of high-pass-filtered images (sewar semantics).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spatial_correlation_coefficient
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> spatial_correlation_coefficient(preds, target)
        tensor(-0.0327)
    """
    if reduction is None:
        reduction = "none"
    if reduction not in ("mean", "none"):
        raise ValueError(f"Expected reduction to be 'mean' or 'none', but got {reduction}")
    preds, target, hp_filter = _scc_update(preds, target, hp_filter, window_size)
    scc = _scc_map(preds, target, hp_filter, window_size)
    if reduction == "none":
        return _mean64(scc, (1, 2, 3))
    return _mean64(scc)
