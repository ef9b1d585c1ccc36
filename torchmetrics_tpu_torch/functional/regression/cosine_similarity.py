"""Cosine similarity (counterpart of
``torchmetrics_tpu/functional/regression/cosine_similarity.py``).

The dot products and squared norms are float64 sums of float32 products, rounded once,
so no matmul runs and TF32 cannot change a bit."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum
from .utils import _mean32


def _cosine_similarity_update(preds: torch.Tensor, target: torch.Tensor):
    _check_same_shape(preds, target)
    if preds.ndim != 2:
        raise ValueError(
            "Expected input to cosine similarity to be 2D tensors of shape `[N,D]` where `N` is the number of samples "
            f"and `D` is the number of dimensions, but got tensor of shape {tuple(preds.shape)}"
        )
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: torch.Tensor, target: torch.Tensor,
                               reduction: Optional[str] = "sum") -> torch.Tensor:
    dot = _float32_sum(preds * target, -1)
    denom = torch.sqrt(_float32_sum(preds * preds, -1)) * torch.sqrt(_float32_sum(target * target, -1))
    sim = dot / denom
    if reduction == "sum":
        return _float32_sum(sim)
    if reduction == "mean":
        return _mean32(sim)
    if reduction in (None, "none"):
        return sim
    raise ValueError(f"Expected reduction to be one of `['sum', 'mean', 'none', None]` but got {reduction}")


def cosine_similarity(preds, target, reduction: Optional[str] = "sum") -> torch.Tensor:
    """Cosine similarity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cosine_similarity
        >>> preds = torch.tensor([[1.0, 2.0, 3.0], [1.0, 0.0, 1.0]])
        >>> target = torch.tensor([[1.0, 2.0, 2.0], [0.5, 0.0, 1.0]])
        >>> cosine_similarity(preds, target, reduction='mean')
        tensor(0.9643)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
