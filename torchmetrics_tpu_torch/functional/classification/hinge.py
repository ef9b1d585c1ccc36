"""Hinge loss (counterpart of ``torchmetrics_tpu/functional/classification/hinge.py``).

The states are the weighted sum of the per-sample losses (a scalar, or a vector over
the classes for ``one-vs-all``) and the weight total, float32. Each batch's sums are
accumulated in float64 and rounded once, so the card and the CPU give the same bits;
against the JAX package's float32 sums they agree within float32 rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum, normalize_logits_if_needed
from ...utilities.enums import ClassificationTaskNoMultilabel
from .stat_scores import _ignore_weights, _multiclass_stat_scores_tensor_validation


def _hinge_loss_compute(measure: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return measure / total


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_hinge_loss_tensor_validation(preds: torch.Tensor, target: torch.Tensor,
                                         ignore_index: Optional[int] = None) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError("Expected argument `preds` to be floating tensor with probabilities/logits"
                         f" but got tensor with dtype {preds.dtype}")


def _binary_hinge_loss_format(preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None):
    """-> (float32 scores after one batch-wide sigmoid when needed, int32 targets,
    float32 weights), flat."""
    preds = normalize_logits_if_needed(preds.reshape(-1).to(torch.float32), "sigmoid")
    target, w = _ignore_weights(target.reshape(-1), ignore_index)
    return preds, target.to(torch.int32), w.to(torch.float32)


def _binary_hinge_loss_update(preds: torch.Tensor, target: torch.Tensor, squared: bool,
                              weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    w = torch.ones(target.shape, dtype=torch.float32, device=target.device) if weights is None else weights
    margin = torch.where(target == 1, preds, -preds)
    measures = (1 - margin).clamp(min=0)
    if squared:
        measures = measures**2
    return _float32_sum(w * measures), _float32_sum(w)


def binary_hinge_loss(
    preds, target, squared: bool = False, ignore_index: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Binary hinge loss.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_hinge_loss
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_hinge_loss(preds, target)
        tensor(0.6950)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
        _binary_hinge_loss_tensor_validation(preds, target, ignore_index)
    preds, target, w = _binary_hinge_loss_format(preds, target, ignore_index)
    return _hinge_loss_compute(*_binary_hinge_loss_update(preds, target, squared, w))


def _multiclass_hinge_loss_arg_validation(
    num_classes: int, squared: bool = False, multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_hinge_loss_arg_validation(squared, ignore_index)
    if multiclass_mode not in ("crammer-singer", "one-vs-all"):
        raise ValueError(
            f"Expected argument `multiclass_mode` to be one of ('crammer-singer', 'one-vs-all') but got {multiclass_mode}"
        )


def _multiclass_hinge_loss_format(preds: torch.Tensor, target: torch.Tensor, num_classes: int,
                                  ignore_index: Optional[int] = None):
    """-> (``(N, C)`` float32 scores after one batch-wide softmax when needed, int64
    targets with ignored points set to 0 and then clipped into the classes, float32
    weights)."""
    preds = normalize_logits_if_needed(preds.to(torch.float32), "softmax")
    target, w = _ignore_weights(target.reshape(-1), ignore_index)
    return preds, target.clamp(0, num_classes - 1).to(torch.int64), w.to(torch.float32)


def _multiclass_hinge_loss_update(
    preds: torch.Tensor, target: torch.Tensor, squared: bool, multiclass_mode: str = "crammer-singer",
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``crammer-singer``: one margin per sample, the true score against the best other
    (a scalar sum); ``one-vs-all``: a margin per (sample, class) (a sum per class)."""
    w = torch.ones(target.shape, dtype=torch.float32, device=target.device) if weights is None else weights
    target = target.long()
    is_true = target[:, None] == torch.arange(preds.shape[1], device=preds.device)
    if multiclass_mode == "crammer-singer":
        true_score = preds.gather(1, target[:, None])[:, 0]
        other_max = torch.where(is_true, float("-inf"), preds).amax(1)
        measures = (1 - (true_score - other_max)).clamp(min=0)
        if squared:
            measures = measures**2
        return _float32_sum(w * measures), _float32_sum(w)
    measures = (1 - torch.where(is_true, preds, -preds)).clamp(min=0)
    if squared:
        measures = measures**2
    return _float32_sum(w[:, None] * measures, 0), _float32_sum(w)


def multiclass_hinge_loss(
    preds, target, num_classes: int, squared: bool = False, multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass hinge loss.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_hinge_loss
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_hinge_loss(preds, target, num_classes=3)
        tensor(0.6250)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)
    preds, target, w = _multiclass_hinge_loss_format(preds, target, num_classes, ignore_index)
    return _hinge_loss_compute(*_multiclass_hinge_loss_update(preds, target, squared, multiclass_mode, w))


def hinge_loss(
    preds, target, task: str, num_classes: Optional[int] = None, squared: bool = False,
    multiclass_mode: str = "crammer-singer", ignore_index: Optional[int] = None, validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch (binary or multiclass).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import hinge_loss
        >>> hinge_loss(torch.tensor([0.25, 0.75]), torch.tensor([0, 1]), task="binary")
        tensor(0.7500)
    """
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
    return multiclass_hinge_loss(preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args)
