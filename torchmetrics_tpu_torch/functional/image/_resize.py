"""Interpolation-parity resize for feature-extractor metrics (counterpart of
``torchmetrics_tpu/functional/image/_resize.py``).

Both forks of the reference extractor's resize are separable, so each is two dense
products with 1-D weight tables built on the host in numpy:

- ``resize_bilinear_antialias``: torch ``F.interpolate(mode="bilinear",
  align_corners=False, antialias=True)``, the PIL-style triangle filter;
- ``resize_bilinear_tf1``: torch-fidelity's TF1-compatible bilinear
  (``half_pixel_centers=False``).

The products run in the images' dtype: float32 at full precision (``torch.matmul``
does not use TF32 unless a caller enables it), or float64 where a caller wants no TF32
at all (D_s's degraded pan).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["resize_bilinear_antialias", "resize_bilinear_tf1"]


@lru_cache(maxsize=64)
def _antialias_weights_1d(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) row-normalized triangle-filter weights, PIL/torch-aa semantics."""
    scale = in_size / out_size
    support = max(scale, 1.0)  # filter widens only when downscaling
    centers = (np.arange(out_size) + 0.5) * scale  # continuous source coordinate + 0.5
    lo = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    hi = np.minimum((centers + support + 0.5).astype(np.int64), in_size)
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        taps = np.arange(lo[i], hi[i])
        dist = (taps + 0.5 - centers[i]) / support
        vals = np.maximum(0.0, 1.0 - np.abs(dist))
        total = vals.sum()
        if total > 0:
            w[i, taps] = vals / total
    return w.astype(np.float32)


@lru_cache(maxsize=64)
def _tf1_weights_1d(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) two-tap bilinear weights with TF1 legacy coordinates (no half-pixel
    offset): ``src = i * in/out``, clamped to the last source row."""
    scale = in_size / out_size if out_size > 1 else 0.0
    src = np.arange(out_size) * scale
    lo = np.floor(src).astype(np.int64)
    lo = np.minimum(lo, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float64)
    w = np.zeros((out_size, in_size), np.float64)
    w[np.arange(out_size), lo] += 1.0 - frac
    w[np.arange(out_size), hi] += frac
    return w.astype(np.float32)


def _separable_resize(
    imgs: torch.Tensor, size: Tuple[int, int], weights_fn: Callable[[int, int], np.ndarray]
) -> torch.Tensor:
    """Apply (out_h, in_h) and (out_w, in_w) weight matrices over the last two axes."""
    out_h, out_w = size
    in_h, in_w = imgs.shape[-2:]
    wh = torch.from_numpy(weights_fn(in_h, out_h)).to(imgs.device, imgs.dtype)
    ww = torch.from_numpy(weights_fn(in_w, out_w)).to(imgs.device, imgs.dtype)
    out = torch.einsum("...hw,Hh->...Hw", imgs, wh)
    return torch.einsum("...Hw,Ww->...HW", out, ww)


def resize_bilinear_antialias(imgs: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize over the trailing (H, W) axes."""
    return _separable_resize(imgs, size, _antialias_weights_1d)


def resize_bilinear_tf1(imgs: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """TF1-compatible bilinear resize over the trailing (H, W) axes."""
    return _separable_resize(imgs, size, _tf1_weights_1d)
