"""Intersection over Union, functional (counterpart of
``torchmetrics_tpu/functional/detection/iou.py``). Computed on the device of the boxes
it is given; thresholding is a ``torch.where``."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...utilities.checks import _as_tensor
from ._box_ops import box_iou_matrix


def _family_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    iou_threshold: Optional[float],
    replacement_val: float,
    matrix_fn: Callable,
) -> torch.Tensor:
    """Shared update of the IoU family: validate, return the square zero matrix of the
    non-empty side when one side is empty, compute the pairwise matrix, apply the
    threshold floor."""
    preds = _as_tensor(preds).float()
    target = _as_tensor(target).to(device=preds.device, dtype=torch.float32)
    if preds.ndim != 2 or preds.shape[-1] != 4:
        raise ValueError(f"Expected preds to be of shape (N, 4) but got {tuple(preds.shape)}")
    if target.ndim != 2 or target.shape[-1] != 4:
        raise ValueError(f"Expected target to be of shape (N, 4) but got {tuple(target.shape)}")
    if preds.numel() == 0:
        return torch.zeros((target.shape[0], target.shape[0]), dtype=torch.float32, device=preds.device)
    if target.numel() == 0:
        return torch.zeros((preds.shape[0], preds.shape[0]), dtype=torch.float32, device=preds.device)
    iou = matrix_fn(preds, target)
    if iou_threshold is not None:
        iou = torch.where(iou < iou_threshold, torch.full_like(iou, replacement_val), iou)
    return iou


def _family_compute(iou: torch.Tensor, aggregate: bool = True) -> torch.Tensor:
    if not aggregate:
        return iou
    if iou.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=iou.device)
    return torch.diagonal(iou).mean()


def _iou_update(preds, target, iou_threshold: Optional[float], replacement_val: float = 0) -> torch.Tensor:
    return _family_update(preds, target, iou_threshold, replacement_val, box_iou_matrix)


def _iou_compute(iou: torch.Tensor, aggregate: bool = True) -> torch.Tensor:
    return _family_compute(iou, aggregate)


def intersection_over_union(
    preds: torch.Tensor,
    target: torch.Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> torch.Tensor:
    """IoU between two sets of xyxy boxes. ``aggregate=True`` returns the mean of the
    matrix diagonal; otherwise the full ``(N, M)`` matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79], [328.94, 97.05, 342.49, 122.98]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00], [330.00, 100.00, 350.00, 125.00]])
        >>> round(float(intersection_over_union(preds, target)), 4)
        0.5992
    """
    return _iou_compute(_iou_update(preds, target, iou_threshold, replacement_val), aggregate)
