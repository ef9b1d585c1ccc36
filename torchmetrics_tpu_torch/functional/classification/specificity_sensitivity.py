"""Highest specificity at a sensitivity floor (counterpart of
``torchmetrics_tpu/functional/classification/specificity_sensitivity.py``): on each ROC
curve, the first best ``1 - fpr`` where the true positive rate reaches ``min_sensitivity``,
and its threshold, under ``_constrained_first_argmax``'s rule, for every class at once."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor
from ._operating_point import _constrained_first_argmax, _per_class, _roc_rows
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
from .recall_fixed_precision import Point, _validate_min


def _specificity_at_sensitivity(fpr, tpr, thresholds, points, min_sensitivity: float) -> Point:
    return _constrained_first_argmax(1 - fpr, tpr, thresholds, points, min_sensitivity)


def _binary_specificity_at_sensitivity_compute(state, thresholds: Optional[torch.Tensor],
                                               min_sensitivity: float) -> Point:
    return _per_class(_specificity_at_sensitivity(*_roc_rows(state, thresholds, "binary"), min_sensitivity), "binary")


def binary_specificity_at_sensitivity(
    preds, target, min_sensitivity: float, thresholds=None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Point:
    """Binary specificity at sensitivity: (specificity, threshold).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_specificity_at_sensitivity
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_specificity_at_sensitivity(preds, target, min_sensitivity=0.5)
        (tensor(1.), tensor(0.8400))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _validate_min("min_sensitivity", min_sensitivity)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, w = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, w)
    return _binary_specificity_at_sensitivity_compute(state, thresholds, min_sensitivity)


def _multiclass_specificity_at_sensitivity_compute(state, num_classes: int, thresholds: Optional[torch.Tensor],
                                                   min_sensitivity: float) -> Point:
    rows = _roc_rows(state, thresholds, "multiclass", num_classes)
    return _per_class(_specificity_at_sensitivity(*rows, min_sensitivity), "multiclass")


def multiclass_specificity_at_sensitivity(
    preds, target, num_classes: int, min_sensitivity: float, thresholds=None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Point:
    """Multiclass specificity at sensitivity, one-vs-rest: (specificities, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_specificity_at_sensitivity
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_specificity_at_sensitivity(preds, target, num_classes=3, min_sensitivity=0.5)
        (tensor([1., 1., 1.]), tensor([0.7500, 0.8000, 0.5000]))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _validate_min("min_sensitivity", min_sensitivity)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, w = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, w)
    return _multiclass_specificity_at_sensitivity_compute(state, num_classes, thresholds, min_sensitivity)


def _multilabel_specificity_at_sensitivity_compute(state, num_labels: int, thresholds: Optional[torch.Tensor],
                                                   ignore_index: Optional[int], min_sensitivity: float) -> Point:
    rows = _roc_rows(state, thresholds, "multilabel", ignore_index=ignore_index)
    return _per_class(_specificity_at_sensitivity(*rows, min_sensitivity), "multilabel")


def multilabel_specificity_at_sensitivity(
    preds, target, num_labels: int, min_sensitivity: float, thresholds=None, ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Point:
    """Multilabel specificity at sensitivity: (specificities, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_specificity_at_sensitivity
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_specificity_at_sensitivity(preds, target, num_labels=3, min_sensitivity=0.5)
        (tensor([1.0000, 0.5000, 1.0000]), tensor([0.7500, 0.6500, 0.7500]))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _validate_min("min_sensitivity", min_sensitivity)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, w = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, w)
    return _multilabel_specificity_at_sensitivity_compute(state, num_labels, thresholds, ignore_index,
                                                          min_sensitivity)
