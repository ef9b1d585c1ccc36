"""Confusion matrix, multiclass (counterpart of
``torchmetrics_tpu/functional/classification/confusion_matrix.py``; binary and
multilabel are not ported yet).

The multiclass kernel is one bincount over the fused (target, pred) index with the 0/1
weights (``ignore_index`` is a zero weight), so, as in the JAX package, a batch's counts
are float32; the stateful class casts them back to its int32 state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.compute import _safe_divide
from ...utilities.data import _bincount_2d


def _confusion_matrix_reduce(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument `normalize` needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.float()
        if normalize == "true":
            return _safe_divide(confmat, confmat.sum(dim=-1, keepdim=True))
        if normalize == "pred":
            return _safe_divide(confmat, confmat.sum(dim=-2, keepdim=True))
        if normalize == "all":
            return _safe_divide(confmat, confmat.sum(dim=(-2, -1), keepdim=True))
    return confmat


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in ("true", "pred", "all", "none", None):
        raise ValueError("Argument `normalize` needs to one of the following: ('true', 'pred', 'all', 'none', None)")


def _multiclass_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    from .stat_scores import _multiclass_stat_scores_tensor_validation

    _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)


def _multiclass_confusion_matrix_format(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (pred labels, target labels with ignored points remapped to 0, 0/1 weights), flat."""
    if preds.ndim == target.ndim + 1:
        preds = preds.argmax(dim=1)
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    if ignore_index is not None:
        w = (target != ignore_index).to(torch.int32)
        target = torch.where(w == 1, target, torch.zeros_like(target))
    else:
        w = torch.ones(target.shape, dtype=torch.int32, device=target.device)
    return preds, target.to(torch.int32), w


def _multiclass_confusion_matrix_update(
    preds: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, num_classes: int
) -> torch.Tensor:
    return _bincount_2d(target, preds, num_classes, num_classes, weights=weights)


def _multiclass_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)
