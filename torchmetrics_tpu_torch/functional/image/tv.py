"""Total variation (counterpart of ``torchmetrics_tpu/functional/image/tv.py``).

Float images sum in float64 and round once. Integer images keep JAX's integer
arithmetic: the differences wrap in the input's dtype (uint8 modulo 256) and the sums
come out in JAX's sum dtype, uint32 for unsigned inputs and int32 for signed ones,
added in int64 and wrapped once, as a 32-bit accumulator wraps."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .utils import _jax_tensor

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """``jnp.sum``'s result dtype for an integer input with x64 off."""
    return torch.uint32 if dtype in _UNSIGNED else torch.int32


def _total_variation_update(img) -> Tuple[torch.Tensor, int]:
    img = _jax_tensor(img)
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {tuple(img.shape)}")
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    if img.is_floating_point():
        score = diff1.abs().sum((1, 2, 3), dtype=torch.float64) + diff2.abs().sum((1, 2, 3), dtype=torch.float64)
        return score.to(img.dtype), img.shape[0]
    score = diff1.abs().sum((1, 2, 3), dtype=torch.int64) + diff2.abs().sum((1, 2, 3), dtype=torch.int64)
    return score.to(_sum_dtype(img.dtype)), img.shape[0]


def _total_variation_compute(score: torch.Tensor, num_elements, reduction: Optional[str]) -> torch.Tensor:
    if reduction in ("mean", "sum"):
        if score.is_floating_point():
            total = score.sum(dtype=torch.float64).to(score.dtype)
        else:
            total = score.to(torch.int64).sum().to(score.dtype)  # wraps as JAX's 32-bit sum does
        return total / num_elements if reduction == "mean" else total
    if reduction is None or reduction == "none":
        return score
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def total_variation(img, reduction: Optional[str] = "sum") -> torch.Tensor:
    """Anisotropic total variation of an NCHW image batch.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import total_variation
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> total_variation(preds)
        tensor(471.7835)
    """
    score, num_elements = _total_variation_update(img)
    return _total_variation_compute(score, num_elements, reduction)
