"""Equal error rate (counterpart of ``torchmetrics_tpu/functional/classification/eer.py``):
on each ROC curve, the mean of the false positive and false negative rates at the first
point where they lie closest. Every class's curve is reduced at once, as a row of the
curve core's padded layout (``_operating_point.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor
from ...utilities.enums import ClassificationTask
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
from .roc import _multiclass_roc_compute
from .stat_scores import _check_task_args


def _eer_rows(fpr: torch.Tensor, tpr: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``(K,)``: each row's ``(fpr + fnr) / 2`` at the first of its valid points where
    ``|fpr - fnr|`` is least."""
    fnr = 1 - tpr
    valid = torch.arange(fpr.shape[1], device=fpr.device) < points[:, None]
    index = torch.where(valid, (fpr - fnr).abs(), float("inf")).argmin(1, keepdim=True)
    return ((fpr.gather(1, index) + fnr.gather(1, index)) / 2)[:, 0]


def _binary_eer_compute(state, thresholds: Optional[torch.Tensor]) -> torch.Tensor:
    fpr, tpr, _, points = _roc_rows(state, thresholds, "binary")
    return _eer_rows(fpr, tpr, points)[0]


def _multiclass_eer_compute(state, num_classes: int, thresholds: Optional[torch.Tensor],
                            average: Optional[str] = None) -> torch.Tensor:
    """Per class, or of the one curve that ``"micro"`` (the flattened one-vs-rest
    problem) or ``"macro"`` (the classes' interpolated mean) makes."""
    if average == "micro":
        return _binary_eer_compute(state, thresholds)
    if average == "macro":
        fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds, "macro")
        return _eer_rows(fpr[None], tpr[None], torch.tensor([fpr.numel()], device=fpr.device))[0]
    fpr, tpr, _, points = _roc_rows(state, thresholds, "multiclass", num_classes)
    return _eer_rows(fpr, tpr, points)


def _multilabel_eer_compute(state, num_labels: int, thresholds: Optional[torch.Tensor],
                            ignore_index: Optional[int] = None) -> torch.Tensor:
    fpr, tpr, _, points = _roc_rows(state, thresholds, "multilabel", ignore_index=ignore_index)
    return _eer_rows(fpr, tpr, points)


def binary_eer(preds, target, thresholds=None, ignore_index: Optional[int] = None,
               validate_args: bool = True) -> torch.Tensor:
    """Binary equal error rate.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_eer
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_eer(preds, target)
        tensor(0.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, w = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, w)
    return _binary_eer_compute(state, thresholds)


def multiclass_eer(
    preds, target, num_classes: int, thresholds=None, average: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass equal error rate, one-vs-rest per class (``average`` "micro" or
    "macro": of one curve).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_eer
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_eer(preds, target, num_classes=3)
        tensor([0., 0., 0.])
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        if average not in ("micro", "macro", None):
            raise ValueError(f"Expected argument `average` to be one of ('micro', 'macro', None), but got {average}")
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, w = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, w, average)
    return _multiclass_eer_compute(state, num_classes, thresholds, average)


def multilabel_eer(
    preds, target, num_labels: int, thresholds=None, ignore_index: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Multilabel equal error rate, per label.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_eer
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_eer(preds, target, num_labels=3)
        tensor([0.0000, 0.7500, 0.0000])
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, w = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, w)
    return _multilabel_eer_compute(state, num_labels, thresholds, ignore_index)


def eer(
    preds, target, task: str, thresholds=None, num_classes: Optional[int] = None, num_labels: Optional[int] = None,
    average: Optional[str] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch over the three equal error rates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import eer
        >>> eer(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 0, 1]), task="binary")
        tensor(0.5000)
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_eer(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_eer(preds, target, num_classes, thresholds, average, ignore_index, validate_args)
    return multilabel_eer(preds, target, num_labels, thresholds, ignore_index, validate_args)
