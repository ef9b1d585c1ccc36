"""Complete IoU, functional (counterpart of
``torchmetrics_tpu/functional/detection/ciou.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ._box_ops import complete_box_iou_matrix
from .iou import _family_compute, _family_update


def _ciou_update(preds, target, iou_threshold: Optional[float], replacement_val: float = 0) -> torch.Tensor:
    return _family_update(preds, target, iou_threshold, replacement_val, complete_box_iou_matrix)


def _ciou_compute(iou: torch.Tensor, aggregate: bool = True) -> torch.Tensor:
    return _family_compute(iou, aggregate)


def complete_intersection_over_union(
    preds: torch.Tensor,
    target: torch.Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> torch.Tensor:
    """CIOU between two sets of xyxy boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import complete_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79], [328.94, 97.05, 342.49, 122.98]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00], [330.00, 100.00, 350.00, 125.00]])
        >>> round(float(complete_intersection_over_union(preds, target)), 4)
        0.5882
    """
    return _ciou_compute(_ciou_update(preds, target, iou_threshold, replacement_val), aggregate)
