"""Highest precision at a recall floor (counterpart of
``torchmetrics_tpu/functional/classification/precision_fixed_recall.py``): on each PR
curve, the best precision where recall reaches ``min_recall``, and its threshold, under
``_masked_lex_best``'s tie rule, for every class at once."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor
from ._operating_point import _masked_lex_best, _per_class, _pr_rows
from .precision_recall_curve import (
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _filter_ignored,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from .recall_fixed_precision import Point, _validate_min


def _precision_at_recall(precision, recall, thresholds, points, min_recall: float) -> Point:
    return _masked_lex_best(precision, recall, thresholds, points, min_recall)


def _binary_precision_at_fixed_recall_arg_validation(min_recall: float, thresholds=None,
                                                     ignore_index: Optional[int] = None) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _validate_min("min_recall", min_recall)


def _multiclass_precision_at_fixed_recall_arg_validation(num_classes: int, min_recall: float, thresholds=None,
                                                         ignore_index: Optional[int] = None) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _validate_min("min_recall", min_recall)


def _multilabel_precision_at_fixed_recall_arg_validation(num_labels: int, min_recall: float, thresholds=None,
                                                         ignore_index: Optional[int] = None) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _validate_min("min_recall", min_recall)


def _binary_precision_at_fixed_recall_compute(state, thresholds: Optional[torch.Tensor], min_recall: float) -> Point:
    return _per_class(_precision_at_recall(*_pr_rows(state, thresholds, "binary"), min_recall), "binary")


def binary_precision_at_fixed_recall(
    preds, target, min_recall: float, thresholds=None, ignore_index: Optional[int] = None, validate_args: bool = True
) -> Point:
    """Binary precision at fixed recall: (precision, threshold).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_precision_at_fixed_recall
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_precision_at_fixed_recall(preds, target, min_recall=0.5)
        (tensor(1.), tensor(0.7300))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _validate_min("min_recall", min_recall)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, w = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, w)
    return _binary_precision_at_fixed_recall_compute(state, thresholds, min_recall)


def _multiclass_precision_at_fixed_recall_compute(state, num_classes: int, thresholds: Optional[torch.Tensor],
                                                  min_recall: float) -> Point:
    rows = _pr_rows(state, thresholds, "multiclass", num_classes)
    return _per_class(_precision_at_recall(*rows, min_recall), "multiclass")


def multiclass_precision_at_fixed_recall(
    preds, target, num_classes: int, min_recall: float, thresholds=None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Point:
    """Multiclass precision at fixed recall, one-vs-rest: (precisions, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_precision_at_fixed_recall
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_precision_at_fixed_recall(preds, target, num_classes=3, min_recall=0.5)
        (tensor([1., 1., 1.]), tensor([0.7500, 0.4000, 0.5000]))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_precision_at_fixed_recall_arg_validation(num_classes, min_recall, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, w = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, w)
    return _multiclass_precision_at_fixed_recall_compute(state, num_classes, thresholds, min_recall)


def _multilabel_precision_at_fixed_recall_compute(state, num_labels: int, thresholds: Optional[torch.Tensor],
                                                  ignore_index: Optional[int], min_recall: float) -> Point:
    rows = _pr_rows(state, thresholds, "multilabel", ignore_index=ignore_index)
    return _per_class(_precision_at_recall(*rows, min_recall), "multilabel")


def multilabel_precision_at_fixed_recall(
    preds, target, num_labels: int, min_recall: float, thresholds=None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Point:
    """Multilabel precision at fixed recall: (precisions, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_precision_at_fixed_recall
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_precision_at_fixed_recall(preds, target, num_labels=3, min_recall=0.5)
        (tensor([1.0000, 0.5000, 1.0000]), tensor([0.7500, 0.6500, 0.3500]))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_precision_at_fixed_recall_arg_validation(num_labels, min_recall, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, w = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, w)
    return _multilabel_precision_at_fixed_recall_compute(state, num_labels, thresholds, ignore_index, min_recall)
