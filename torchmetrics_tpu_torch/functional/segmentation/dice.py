"""Dice score for semantic segmentation (counterpart of
``torchmetrics_tpu/functional/segmentation/dice.py``).

Per (sample, class) statistics: ``2 * intersection``, ``pred + target`` sums and the
target sum (the support), counted exactly in int64 and cast once to float32; every
averaging mode is a reduction over these ``(N, C)`` matrices, NaN marking an absent
class. The float sums over classes are taken in float64 and rounded once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.compute import _float32_sum, _safe_divide
from .utils import _overlap_counts, _segmentation_inputs_format


def _dice_score_validate_args(
    num_classes: int,
    include_background: bool,
    average: Optional[str] = "micro",
    input_format: str = "one-hot",
    aggregation_level: Optional[str] = "samplewise",
) -> None:
    if not isinstance(num_classes, int) or num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    allowed_average = ["micro", "macro", "weighted", "none"]
    if average is not None and average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average} or None, but got {average}.")
    if input_format not in ["one-hot", "index", "mixed"]:
        raise ValueError(
            f"Expected argument `input_format` to be one of 'one-hot', 'index', 'mixed', but got {input_format}."
        )
    if aggregation_level not in ("samplewise", "global"):
        raise ValueError(
            f"Expected argument `aggregation_level` to be one of `samplewise`, `global`, but got {aggregation_level}"
        )


def _dice_score_update(
    preds,
    target,
    num_classes: int,
    include_background: bool,
    input_format: str = "one-hot",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per (sample, class): ``2 * intersection``, cardinality and support, float32."""
    preds, target = _segmentation_inputs_format(preds, target, include_background, num_classes, input_format)
    intersection, target_sum, pred_sum = _overlap_counts(preds, target)
    f32 = torch.float32
    return (2 * intersection).to(f32), (pred_sum + target_sum).to(f32), target_sum.to(f32)


def _nanmean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.nanmean`` with the sum in float64, rounded once (NaN where all are NaN)."""
    keep = ~x.isnan()
    total = torch.where(keep, x, 0.0).sum(dim, dtype=torch.float64)
    return (total / keep.sum(dim)).to(torch.float32)


def _nansum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _float32_sum(torch.where(x.isnan(), 0.0, x), dim)


def _dice_score_compute(
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    average: Optional[str] = "micro",
    aggregation_level: Optional[str] = "samplewise",
    support: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dice by ``average``; NaN marks absent classes, which every averaging mode skips."""
    if aggregation_level == "global":
        numerator = _float32_sum(numerator, 0)[None]
        denominator = _float32_sum(denominator, 0)[None]
        support = _float32_sum(support, 0) if support is not None else None

    if average == "micro":
        return _safe_divide(_float32_sum(numerator, -1), _float32_sum(denominator, -1), zero_division=float("nan"))

    dice = _safe_divide(numerator, denominator, zero_division=float("nan"))
    if average == "macro":
        return _nanmean(dice, -1)
    if average == "weighted":
        if support is None:
            raise ValueError("Expected argument `support` to be provided for weighted averaging.")
        weights = _safe_divide(support, _float32_sum(support, -1)[..., None], zero_division=float("nan"))
        nan_mask = dice.isnan().all(-1)
        return torch.where(nan_mask, float("nan"), _nansum(dice * weights, -1))
    if average in ("none", None):
        return dice
    raise ValueError(f"Invalid value for `average`: {average}.")


def dice_score(
    preds,
    target,
    num_classes: int,
    include_background: bool = True,
    average: Optional[str] = "macro",
    input_format: str = "one-hot",
    aggregation_level: Optional[str] = "samplewise",
) -> torch.Tensor:
    """Dice score for semantic segmentation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import dice_score
        >>> preds = torch.tensor([[[0, 1, 1, 0], [1, 1, 0, 0], [2, 2, 1, 0], [2, 0, 0, 0]]])
        >>> target = torch.tensor([[[0, 1, 1, 0], [1, 0, 0, 0], [2, 2, 0, 0], [2, 2, 0, 0]]])
        >>> dice_score(preds, target, num_classes=3, input_format='index')
        tensor([0.8102])
    """
    _dice_score_validate_args(num_classes, include_background, average, input_format, aggregation_level)
    numerator, denominator, support = _dice_score_update(preds, target, num_classes, include_background, input_format)
    return _dice_score_compute(numerator, denominator, average, aggregation_level=aggregation_level, support=support)
