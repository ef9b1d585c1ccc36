"""Mean IoU for semantic segmentation (counterpart of
``torchmetrics_tpu/functional/segmentation/mean_iou.py``).

Intersection and union per (sample, class) are exact int64 counts cast once to float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _safe_divide
from .dice import _nansum
from .utils import _overlap_counts, _segmentation_inputs_format


def _mean_iou_reshape_args(preds, target, input_format: str = "one-hot") -> Tuple[torch.Tensor, torch.Tensor]:
    """Promote 1-D and 2-D index inputs to a leading batch axis."""
    if input_format == "one-hot":
        return preds, target
    if preds.ndim == 1:
        preds = preds[None, None]
    elif preds.ndim == 2:
        preds = preds[None]
    if target.ndim == 1:
        target = target[None, None]
    elif target.ndim == 2:
        target = target[None]
    return preds, target


def _mean_iou_validate_args(
    num_classes: Optional[int],
    include_background: bool,
    per_class: bool,
    input_format: str = "one-hot",
) -> None:
    if input_format == "index" and num_classes is None:
        raise ValueError("Argument `num_classes` must be provided when `input_format` is 'index'.")
    if num_classes is not None and num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be `None` or a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    if not isinstance(per_class, bool):
        raise ValueError(f"Expected argument `per_class` must be a boolean, but got {per_class}.")
    if input_format not in ["one-hot", "index", "mixed"]:
        raise ValueError(
            f"Expected argument `input_format` to be one of 'one-hot', 'index', 'mixed', but got {input_format}."
        )


def _mean_iou_update(
    preds,
    target,
    num_classes: Optional[int] = None,
    include_background: bool = False,
    input_format: str = "one-hot",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (sample, class) intersection and union, float32."""
    preds = _as_tensor(preds)
    preds, target = _mean_iou_reshape_args(preds, _as_tensor(target).to(preds.device), input_format)
    preds, target = _segmentation_inputs_format(preds, target, include_background, num_classes, input_format)
    intersection, target_sum, pred_sum = _overlap_counts(preds, target)
    union = target_sum + pred_sum - intersection
    return intersection.to(torch.float32), union.to(torch.float32)


def _mean_iou_compute(intersection: torch.Tensor, union: torch.Tensor, zero_division) -> torch.Tensor:
    return _safe_divide(intersection, union, zero_division=zero_division)


def mean_iou(
    preds,
    target,
    num_classes: Optional[int] = None,
    include_background: bool = True,
    per_class: bool = False,
    input_format: str = "one-hot",
) -> torch.Tensor:
    """Mean intersection over union per sample; with ``per_class`` one score a class,
    -1 for a class absent from both, which the averaged value skips.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_iou
        >>> preds = torch.tensor([[[0, 1, 1, 0], [1, 1, 0, 0], [2, 2, 1, 0], [2, 0, 0, 0]]])
        >>> target = torch.tensor([[[0, 1, 1, 0], [1, 0, 0, 0], [2, 2, 0, 0], [2, 2, 0, 0]]])
        >>> mean_iou(preds, target, num_classes=3, input_format='index')
        tensor([0.6833])
    """
    _mean_iou_validate_args(num_classes, include_background, per_class, input_format)
    intersection, union = _mean_iou_update(preds, target, num_classes, include_background, input_format)
    scores = _mean_iou_compute(intersection, union, zero_division=float("nan"))
    if per_class:
        return torch.nan_to_num(scores, nan=-1.0)
    return _nansum(scores, -1) / (union > 0).sum(-1)
