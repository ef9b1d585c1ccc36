"""Highest recall at a precision floor (counterpart of
``torchmetrics_tpu/functional/classification/recall_fixed_precision.py``): on each PR
curve, the best recall where precision reaches ``min_precision``, and its threshold,
under ``_masked_lex_best``'s tie rule, for every class at once."""

from __future__ import annotations

from typing import Optional, Tuple

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

Point = Tuple[torch.Tensor, torch.Tensor]


def _recall_at_precision(precision, recall, thresholds, points, min_precision: float) -> Point:
    return _masked_lex_best(recall, precision, thresholds, points, min_precision)


def _validate_min(name: str, value: float) -> None:
    if not isinstance(value, float) or not (0 <= value <= 1):
        raise ValueError(f"Expected argument `{name}` to be an float in the [0,1] range, but got {value}")


def _binary_recall_at_fixed_precision_arg_validation(min_precision: float, thresholds=None,
                                                     ignore_index: Optional[int] = None) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _validate_min("min_precision", min_precision)


def _binary_recall_at_fixed_precision_compute(state, thresholds: Optional[torch.Tensor],
                                              min_precision: float) -> Point:
    return _per_class(_recall_at_precision(*_pr_rows(state, thresholds, "binary"), min_precision), "binary")


def binary_recall_at_fixed_precision(
    preds, target, min_precision: float, thresholds=None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Point:
    """Binary recall at fixed precision: (recall, threshold).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_recall_at_fixed_precision
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_recall_at_fixed_precision(preds, target, min_precision=0.5)
        (tensor(1.), tensor(0.7300))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, w = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, w)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_precision)


def _multiclass_recall_at_fixed_precision_arg_validation(num_classes: int, min_precision: float, thresholds=None,
                                                         ignore_index: Optional[int] = None) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _validate_min("min_precision", min_precision)


def _multiclass_recall_at_fixed_precision_compute(state, num_classes: int, thresholds: Optional[torch.Tensor],
                                                  min_precision: float) -> Point:
    rows = _pr_rows(state, thresholds, "multiclass", num_classes)
    return _per_class(_recall_at_precision(*rows, min_precision), "multiclass")


def multiclass_recall_at_fixed_precision(
    preds, target, num_classes: int, min_precision: float, thresholds=None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Point:
    """Multiclass recall at fixed precision, one-vs-rest: (recalls, thresholds), each ``(C,)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_recall_at_fixed_precision
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_recall_at_fixed_precision(preds, target, num_classes=3, min_precision=0.5)
        (tensor([1., 1., 1.]), tensor([0.7500, 0.4000, 0.5000]))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, w = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, w)
    return _multiclass_recall_at_fixed_precision_compute(state, num_classes, thresholds, min_precision)


def _multilabel_recall_at_fixed_precision_arg_validation(num_labels: int, min_precision: float, thresholds=None,
                                                         ignore_index: Optional[int] = None) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _validate_min("min_precision", min_precision)


def _multilabel_recall_at_fixed_precision_compute(state, num_labels: int, thresholds: Optional[torch.Tensor],
                                                  ignore_index: Optional[int], min_precision: float) -> Point:
    rows = _pr_rows(state, thresholds, "multilabel", ignore_index=ignore_index)
    return _per_class(_recall_at_precision(*rows, min_precision), "multilabel")


def multilabel_recall_at_fixed_precision(
    preds, target, num_labels: int, min_precision: float, thresholds=None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Point:
    """Multilabel recall at fixed precision: (recalls, thresholds), each ``(C,)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_recall_at_fixed_precision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_recall_at_fixed_precision(preds, target, num_labels=3, min_precision=0.5)
        (tensor([1., 1., 1.]), tensor([0.7500, 0.6500, 0.3500]))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, w = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, w)
    return _multilabel_recall_at_fixed_precision_compute(state, num_labels, thresholds, ignore_index, min_precision)
