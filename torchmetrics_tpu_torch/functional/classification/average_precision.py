"""Average precision, the step integral of the PR curve (counterpart of
``torchmetrics_tpu/functional/classification/average_precision.py``).

As in the JAX package, a binned curve's NaN points count as 0, while an exact curve's
NaN propagates: a class with no positives then has a NaN score, which the macro and
weighted averages skip.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor
from ...utilities.enums import ClassificationTask
from .auroc import (
    _binned_support,
    _flatten_multilabel,
    _multiclass_auroc_arg_validation,
    _multilabel_auroc_arg_validation,
    _multilabel_support,
)
from .precision_recall_curve import (
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _binned_pr,
    _exact_pr_curve_rows,
    _filter_ignored,
    _multiclass_exact_rows,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_exact_rows,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
    _reduce_class_scores,
)
from .stat_scores import _check_task_args

_multiclass_average_precision_arg_validation = _multiclass_auroc_arg_validation
_multilabel_average_precision_arg_validation = _multilabel_auroc_arg_validation


def _nan_to_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.isnan(), torch.zeros_like(x), x)


def _step_area(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    """``-sum((r[1:] - r[:-1]) * p[:-1])`` along the last axis."""
    return -((recall[..., 1:] - recall[..., :-1]) * precision[..., :-1]).sum(-1)


def _reduce_average_precision(
    precision: torch.Tensor, recall: torch.Tensor, average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The APs of the binned curves in the rows of ``(precision, recall)``, NaN points
    counted as 0 -> ``average``."""
    return _reduce_class_scores(_step_area(_nan_to_zero(precision), _nan_to_zero(recall)), average, weights)


def _exact_class_aps(preds: torch.Tensor, positive: torch.Tensor, all_negative: torch.Tensor,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every row's exact AP, from the padded rows of its PR curve (a padded point
    repeats (1, 0), which adds nothing); NaN propagates."""
    precision, recall, _, _ = _exact_pr_curve_rows(preds, positive, all_negative, keep)
    return _step_area(precision, recall)


def _binary_average_precision_compute(state, thresholds: Optional[torch.Tensor]) -> torch.Tensor:
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds)
    return _step_area(_nan_to_zero(precision), _nan_to_zero(recall))


def binary_average_precision(
    preds, target, thresholds=None, ignore_index: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Binary average precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_average_precision
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_average_precision(preds, target)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, w = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, w)
    return _binary_average_precision_compute(state, thresholds)


def _multiclass_average_precision_compute(
    state, num_classes: int, average: Optional[str] = "macro", thresholds: Optional[torch.Tensor] = None
) -> torch.Tensor:
    if not isinstance(state, tuple) and thresholds is not None:
        precision, recall = _binned_pr(state)
        return _reduce_average_precision(precision.T, recall.T, average, _binned_support(state))
    weights = torch.bincount(state[1].long(), minlength=num_classes).to(torch.float32)
    return _reduce_class_scores(_exact_class_aps(*_multiclass_exact_rows(state[0], state[1], num_classes)), average,
                                weights)


def multiclass_average_precision(
    preds,
    target,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds=None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass average precision, one-vs-rest.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_average_precision
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_average_precision(preds, target, num_classes=3)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, w = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, w)
    return _multiclass_average_precision_compute(state, num_classes, average, thresholds)


def _multilabel_average_precision_compute(
    state,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Optional[torch.Tensor] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    binned = not isinstance(state, tuple) and thresholds is not None
    if average == "micro":
        if binned:
            return _binary_average_precision_compute(state.sum(1).to(torch.int32), thresholds)
        return _binary_average_precision_compute(_flatten_multilabel(state, ignore_index), None)
    if binned:
        precision, recall = _binned_pr(state)
        return _reduce_average_precision(precision.T, recall.T, average, _binned_support(state))
    res = _exact_class_aps(*_multilabel_exact_rows(state[0], state[1], ignore_index))
    return _reduce_class_scores(res, average, _multilabel_support(state[1], ignore_index))


def multilabel_average_precision(
    preds,
    target,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds=None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel average precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_average_precision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_average_precision(preds, target, num_labels=3)
        tensor(0.8333)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_average_precision_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, w = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, w)
    return _multilabel_average_precision_compute(state, num_labels, average, thresholds, ignore_index)


def average_precision(
    preds,
    target,
    task: str,
    thresholds=None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch over the three average precisions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import average_precision
        >>> average_precision(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1]), task="binary")
        tensor(1.)
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_average_precision(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_average_precision(preds, target, num_classes, average, thresholds, ignore_index,
                                            validate_args)
    return multilabel_average_precision(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
