"""Log-scale partial AUROC, LogAUC (counterpart of
``torchmetrics_tpu/functional/classification/logauc.py``): the area under TPR against
``log10(FPR)`` over ``fpr_range``, over the width of that range on the log axis.

The JAX package's steps, row by row on the curve core's padded layout: the curve's two
rates at the range's bounds are interpolated and appended, the false and the true
positive rates are then sorted each on its own (the JAX package's order, kept as it
is), and the points whose false positive rate lies in the range are integrated by the
trapezoid rule. A curve of fewer than two points scores 0, with a warning.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import interp
from ...utilities.enums import ClassificationTask
from ...utilities.prints import rank_zero_warn
from ._operating_point import _roc_rows
from .precision_recall_curve import (
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _filter_ignored,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from .stat_scores import _check_task_args


def _validate_fpr_range(fpr_range: Tuple[float, float]) -> None:
    if not isinstance(fpr_range, tuple) or len(fpr_range) != 2:
        raise ValueError(f"The `fpr_range` should be a tuple of two floats, but got {type(fpr_range)}.")
    if not (0 <= fpr_range[0] < fpr_range[1] <= 1):
        raise ValueError(f"The `fpr_range` should be a tuple of two floats in the range [0, 1], but got {fpr_range}.")


def _logauc_rows(fpr: torch.Tensor, tpr: torch.Tensor, points: torch.Tensor,
                 fpr_range: Tuple[float, float] = (0.001, 0.1)) -> torch.Tensor:
    """``(K,)`` float32: the LogAUC of each row's first ``points`` points. The rows have
    at least two points each, or (a curve of one threshold) one each."""
    k, width = fpr.shape
    if width < 2:
        rank_zero_warn(
            "At least two values on for the fpr and tpr are required to compute the log AUC. Returns 0 score."
        )
        return torch.zeros(k, dtype=torch.float32, device=fpr.device)
    bounds = torch.tensor(fpr_range, dtype=torch.promote_types(fpr.dtype, torch.float32), device=fpr.device)
    at = torch.stack([points, points + 1], 1)
    column = torch.arange(width + 2, device=fpr.device)
    inside = column < (points + 2)[:, None]

    def extended(x: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
        """The row's points, then ``tail``, sorted, with +inf past them."""
        x = torch.cat([x.to(tail.dtype), tail.new_zeros(k, 2)], 1).scatter(1, at, tail)
        return torch.where(inside, x, float("inf")).sort(1).values

    fpr_s = extended(fpr, bounds.expand(k, 2))
    tpr_s = extended(tpr, interp(bounds, fpr, tpr, points))
    keep = inside & (fpr_s >= bounds[0]) & (fpr_s <= bounds[1])
    x = torch.log10(torch.where(keep, fpr_s, 1.0))
    pair = keep[:, 1:] & keep[:, :-1]
    area = 0.5 * torch.where(pair, (x[:, 1:] - x[:, :-1]) * (tpr_s[:, 1:] + tpr_s[:, :-1]), 0.0).sum(1)
    log_bounds = torch.log10(bounds)
    return area / (log_bounds[1] - log_bounds[0])


def _reduce_logauc(scores: torch.Tensor, average: Optional[str] = "macro") -> torch.Tensor:
    if average == "macro":
        return scores.mean()
    if average in (None, "none"):
        return scores
    raise ValueError(f"Expected argument `average` to be one of ('macro', 'none', None) but got {average}")


def _binary_logauc_compute(state, thresholds: Optional[torch.Tensor],
                           fpr_range: Tuple[float, float]) -> torch.Tensor:
    fpr, tpr, _, points = _roc_rows(state, thresholds, "binary")
    return _logauc_rows(fpr, tpr, points, fpr_range)[0]


def _multiclass_logauc_compute(state, num_classes: int, thresholds: Optional[torch.Tensor],
                               fpr_range: Tuple[float, float], average: Optional[str] = "macro") -> torch.Tensor:
    fpr, tpr, _, points = _roc_rows(state, thresholds, "multiclass", num_classes)
    return _reduce_logauc(_logauc_rows(fpr, tpr, points, fpr_range), average)


def _multilabel_logauc_compute(state, num_labels: int, thresholds: Optional[torch.Tensor],
                               fpr_range: Tuple[float, float], average: Optional[str] = "macro",
                               ignore_index: Optional[int] = None) -> torch.Tensor:
    fpr, tpr, _, points = _roc_rows(state, thresholds, "multilabel", ignore_index=ignore_index)
    return _reduce_logauc(_logauc_rows(fpr, tpr, points, fpr_range), average)


def binary_logauc(
    preds, target, fpr_range: Tuple[float, float] = (0.001, 0.1), thresholds=None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary LogAUC.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_logauc
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_logauc(preds, target)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _validate_fpr_range(fpr_range)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, w = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, w)
    return _binary_logauc_compute(state, thresholds, fpr_range)


def multiclass_logauc(
    preds, target, num_classes: int, fpr_range: Tuple[float, float] = (0.001, 0.1), average: Optional[str] = "macro",
    thresholds=None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass LogAUC, one-vs-rest per class, then ``average``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_logauc
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_logauc(preds, target, num_classes=3)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _validate_fpr_range(fpr_range)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, w = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, w)
    return _multiclass_logauc_compute(state, num_classes, thresholds, fpr_range, average)


def multilabel_logauc(
    preds, target, num_labels: int, fpr_range: Tuple[float, float] = (0.001, 0.1), average: Optional[str] = "macro",
    thresholds=None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel LogAUC, per label, then ``average``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_logauc
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_logauc(preds, target, num_labels=3)
        tensor(0.6667)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _validate_fpr_range(fpr_range)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, w = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, w)
    return _multilabel_logauc_compute(state, num_labels, thresholds, fpr_range, average, ignore_index)


def logauc(
    preds, target, task: str, thresholds=None, num_classes: Optional[int] = None, num_labels: Optional[int] = None,
    fpr_range: Tuple[float, float] = (0.001, 0.1), average: Optional[str] = None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch over the three LogAUCs; its ``average`` defaults to None (per class),
    as the JAX package's does, where the per-task functions default to macro.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import logauc
        >>> logauc(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 0, 1]), task="binary")
        tensor(0.5000)
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_logauc(preds, target, fpr_range, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_logauc(preds, target, num_classes, fpr_range, average, thresholds, ignore_index,
                                 validate_args)
    return multilabel_logauc(preds, target, num_labels, fpr_range, average, thresholds, ignore_index, validate_args)
