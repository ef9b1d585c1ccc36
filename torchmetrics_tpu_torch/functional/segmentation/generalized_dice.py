"""Generalized Dice score (counterpart of
``torchmetrics_tpu/functional/segmentation/generalized_dice.py``).

Where a class is absent from a sample's target its infinite weight (``1 / 0``) is
replaced by that class's largest finite weight over the batch, as in the JAX package.
The counts are exact (int64, cast once to float32); the weighting is float32, as there;
the sum over classes is taken in float64 and rounded once.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...utilities.compute import _float32_sum, _safe_divide
from .utils import _overlap_counts, _segmentation_inputs_format


def _generalized_dice_validate_args(
    num_classes: int,
    include_background: bool,
    per_class: bool,
    weight_type: str,
    input_format: str,
) -> None:
    if not isinstance(num_classes, int) or num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    if not isinstance(per_class, bool):
        raise ValueError(f"Expected argument `per_class` must be a boolean, but got {per_class}.")
    if weight_type not in ["square", "simple", "linear"]:
        raise ValueError(
            f"Expected argument `weight_type` to be one of 'square', 'simple', 'linear', but got {weight_type}."
        )
    if input_format not in ["one-hot", "index", "mixed"]:
        raise ValueError(
            f"Expected argument `input_format` to be one of 'one-hot', 'index', 'mixed', but got {input_format}."
        )


def _generalized_dice_update(
    preds,
    target,
    num_classes: int,
    include_background: bool,
    weight_type: str = "square",
    input_format: str = "one-hot",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per (sample, class) numerator and denominator, float32."""
    preds, target = _segmentation_inputs_format(preds, target, include_background, num_classes, input_format)
    intersection, target_sum, pred_sum = _overlap_counts(preds, target)
    cardinality = (target_sum + pred_sum).to(torch.float32)
    intersection, target_sum = intersection.to(torch.float32), target_sum.to(torch.float32)

    if weight_type == "simple":
        weights = 1.0 / target_sum
    elif weight_type == "linear":
        weights = torch.ones_like(target_sum)
    else:  # square
        weights = 1.0 / (target_sum * target_sum)

    infs = weights.isinf()
    class_max = torch.where(infs, 0.0, weights).max(0, keepdim=True).values  # (1, C)
    weights = torch.where(infs, class_max.expand_as(weights), weights)
    return 2.0 * intersection * weights, cardinality * weights


def _generalized_dice_compute(numerator: torch.Tensor, denominator: torch.Tensor, per_class: bool = True) -> torch.Tensor:
    if not per_class:
        numerator = _float32_sum(numerator, 1)
        denominator = _float32_sum(denominator, 1)
    return _safe_divide(numerator, denominator)


def generalized_dice_score(
    preds,
    target,
    num_classes: int,
    include_background: bool = True,
    per_class: bool = False,
    weight_type: str = "square",
    input_format: str = "one-hot",
) -> torch.Tensor:
    """Generalized Dice score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import generalized_dice_score
        >>> preds = torch.tensor([[[0, 1, 1, 0], [1, 1, 0, 0], [2, 2, 1, 0], [2, 0, 0, 0]]])
        >>> target = torch.tensor([[[0, 1, 1, 0], [1, 0, 0, 0], [2, 2, 0, 0], [2, 2, 0, 0]]])
        >>> generalized_dice_score(preds, target, num_classes=3, input_format='index')
        tensor([0.7906])
    """
    _generalized_dice_validate_args(num_classes, include_background, per_class, weight_type, input_format)
    numerator, denominator = _generalized_dice_update(
        preds, target, num_classes, include_background, weight_type, input_format
    )
    return _generalized_dice_compute(numerator, denominator, per_class)
