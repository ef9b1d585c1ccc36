"""Spatial Distortion Index, D_s (counterpart of ``torchmetrics_tpu/functional/image/d_s.py``).

Without ``pan_lr`` the panchromatic image is box-filtered and resized to the
multispectral size with the antialiased bilinear filter of ``jax.image.resize`` (the
triangle filter of ``_resize.py``), as two float64 products rounded once: no TF32. The
bands' UQIs are one batched call, each band alone."""

from __future__ import annotations

from typing import Optional

import torch

from ._resize import resize_bilinear_antialias
from .uqi import _uqi_map
from .utils import _jax_tensor, _mean64, reduce, uniform_filter


def _spatial_distortion_index_update(preds, ms, pan, pan_lr=None):
    preds, ms, pan = _jax_tensor(preds), _jax_tensor(ms), _jax_tensor(pan)
    pan_lr = _jax_tensor(pan_lr) if pan_lr is not None else None
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` to have BxCxHxW shape. Got preds: {preds.shape}.")
    for name, other in (("ms", ms), ("pan", pan)) + ((("pan_lr", pan_lr),) if pan_lr is not None else ()):
        if preds.dtype != other.dtype:
            raise TypeError(
                f"Expected `preds` and `{name}` to have the same data type."
                f" Got preds: {preds.dtype} and {name}: {other.dtype}."
            )
        if other.ndim != 4:
            raise ValueError(f"Expected `{name}` to have BxCxHxW shape. Got {name}: {other.shape}.")
        if preds.shape[:2] != other.shape[:2]:
            raise ValueError(
                f"Expected `preds` and `{name}` to have the same batch and channel sizes."
                f" Got preds: {preds.shape} and {name}: {other.shape}."
            )
    pan_h, pan_w = pan.shape[-2:]
    ms_h, ms_w = ms.shape[-2:]
    if preds.shape[-2:] != pan.shape[-2:]:
        raise ValueError(
            f"Expected `preds` and `pan` to have the same dimension. Got preds: {preds.shape} and pan: {pan.shape}."
        )
    if pan_h % ms_h != 0:
        raise ValueError(
            f"Expected height of `pan` to be multiple of height of `ms`. Got preds: {pan_h} and ms: {ms_h}."
        )
    if pan_w % ms_w != 0:
        raise ValueError(f"Expected width of `pan` to be multiple of width of `ms`. Got preds: {pan_w} and ms: {ms_w}.")
    if pan_lr is not None and tuple(pan_lr.shape[-2:]) != (ms_h, ms_w):
        raise ValueError(
            f"Expected `ms` and `pan_lr` to have the same height and width."
            f" Got ms: {ms.shape} and pan_lr: {pan_lr.shape}."
        )
    return preds, ms, pan, pan_lr


def _resize_antialias(imgs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Antialiased bilinear resize of the trailing (H, W) axes, in float64 rounded once."""
    return resize_bilinear_antialias(imgs.to(torch.float64), (height, width)).to(imgs.dtype)


def _band_uqi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The mean UQI of each band of ``a`` against the same band of ``b``: ``(C,)``."""
    batch, length = a.shape[:2]
    a = a.transpose(0, 1).reshape(length * batch, 1, *a.shape[2:])
    b = b.transpose(0, 1).reshape(length * batch, 1, *b.shape[2:])
    return _mean64(_uqi_map(a, b).reshape(length, -1), 1)


def _spatial_distortion_index_compute(
    preds: torch.Tensor, ms: torch.Tensor, pan: torch.Tensor, pan_lr: Optional[torch.Tensor] = None,
    norm_order: int = 1, window_size: int = 7, reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    ms_h, ms_w = ms.shape[-2:]
    if window_size >= ms_h or window_size >= ms_w:
        raise ValueError(
            f"Expected `window_size` to be smaller than dimension of `ms`. Got window_size: {window_size}."
        )
    if pan_lr is None:
        pan_degraded = _resize_antialias(uniform_filter(pan, window_size=window_size), ms_h, ms_w)
    else:
        pan_degraded = pan_lr
    m1 = _band_uqi(ms, pan_degraded)
    m2 = _band_uqi(preds, pan)
    diff = torch.abs(m1 - m2) ** norm_order
    return reduce(diff, reduction) ** (1 / norm_order)


def spatial_distortion_index(
    preds, ms, pan, pan_lr=None, norm_order: int = 1, window_size: int = 7,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """D_s: the spatial distortion of a pan-sharpened image against its panchromatic
    source.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import spatial_distortion_index
        >>> preds = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 37 % 97) / 97
        >>> ms = (torch.arange(3 * 16 * 16, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> pan = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 29 % 83) / 83
        >>> spatial_distortion_index(preds, ms, pan)
        tensor(0.0871)
    """
    if not isinstance(norm_order, int) or norm_order <= 0:
        raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
    if not isinstance(window_size, int) or window_size <= 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got window_size: {window_size}.")
    preds, ms, pan, pan_lr = _spatial_distortion_index_update(preds, ms, pan, pan_lr)
    return _spatial_distortion_index_compute(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
