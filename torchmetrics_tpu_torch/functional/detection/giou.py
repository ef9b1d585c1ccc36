"""Generalized IoU, functional (counterpart of
``torchmetrics_tpu/functional/detection/giou.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ._box_ops import generalized_box_iou_matrix
from .iou import _family_compute, _family_update


def _giou_update(preds, target, iou_threshold: Optional[float], replacement_val: float = 0) -> torch.Tensor:
    return _family_update(preds, target, iou_threshold, replacement_val, generalized_box_iou_matrix)


def _giou_compute(iou: torch.Tensor, aggregate: bool = True) -> torch.Tensor:
    return _family_compute(iou, aggregate)


def generalized_intersection_over_union(
    preds: torch.Tensor,
    target: torch.Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> torch.Tensor:
    """GIOU between two sets of xyxy boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import generalized_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79], [328.94, 97.05, 342.49, 122.98]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00], [330.00, 100.00, 350.00, 125.00]])
        >>> round(float(generalized_intersection_over_union(preds, target)), 4)
        0.5784
    """
    return _giou_compute(_giou_update(preds, target, iou_threshold, replacement_val), aggregate)
