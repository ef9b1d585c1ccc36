"""Jaccard index, intersection over union of the confusion matrix (counterpart of
``torchmetrics_tpu/functional/classification/jaccard.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _safe_divide
from ...utilities.enums import ClassificationTask
from .confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from .stat_scores import _check_task_args

_AVERAGES = ("binary", "micro", "macro", "weighted", "none", None)


def _jaccard_index_reduce(
    confmat: torch.Tensor, average: Optional[str], ignore_index: Optional[int] = None, zero_division: float = 0.0
) -> torch.Tensor:
    """Confusion matrix (``(2, 2)``, ``(C, C)`` or multilabel ``(C, 2, 2)``) -> Jaccard
    index in float32. An ``ignore_index`` inside ``[0, C)`` leaves micro's denominator
    and macro's mean; macro also skips classes that never occur."""
    if average not in _AVERAGES:
        raise ValueError(f"The `average` has to be one of {list(_AVERAGES)}, got {average}.")
    confmat = confmat.to(torch.float32)
    if average == "binary":
        return _safe_divide(confmat[1, 1], confmat[0, 1] + confmat[1, 0] + confmat[1, 1], zero_division)
    ignore_index_cond = ignore_index is not None and 0 <= ignore_index < confmat.shape[0]
    multilabel = confmat.ndim == 3
    if multilabel:
        num = confmat[:, 1, 1]
        denom = confmat[:, 1, 1] + confmat[:, 0, 1] + confmat[:, 1, 0]
    else:
        num = torch.diagonal(confmat)
        denom = confmat.sum(0) + confmat.sum(1) - num
    if average == "micro":
        num = num.sum()
        denom = denom.sum() - (denom[ignore_index] if ignore_index_cond else 0.0)
    jaccard = _safe_divide(num, denom, zero_division)
    if average is None or average in ("none", "micro"):
        return jaccard
    if average == "weighted":
        weights = confmat[:, 1, 1] + confmat[:, 1, 0] if multilabel else confmat.sum(1)
    else:
        weights = torch.ones_like(jaccard)
        if ignore_index_cond:
            weights[ignore_index] = 0.0
        if not multilabel:
            weights = torch.where(confmat.sum(1) + confmat.sum(0) == 0, 0.0, weights)
    return ((weights * jaccard) / weights.sum()).sum()


def binary_jaccard_index(
    preds,
    target,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> torch.Tensor:
    """Binary Jaccard index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_jaccard_index
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_jaccard_index(preds, target)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, w = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target, w)
    return _jaccard_index_reduce(confmat, average="binary", zero_division=zero_division)


def multiclass_jaccard_index(
    preds,
    target,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> torch.Tensor:
    """Multiclass Jaccard index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_jaccard_index
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_jaccard_index(preds, target, num_classes=3)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, w = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, w, num_classes)
    return _jaccard_index_reduce(confmat, average, ignore_index, zero_division)


def multilabel_jaccard_index(
    preds,
    target,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> torch.Tensor:
    """Multilabel Jaccard index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_jaccard_index
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_jaccard_index(preds, target, num_labels=3)
        tensor(0.6667)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize=None)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, w = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, w, num_labels)
    return _jaccard_index_reduce(confmat, average, zero_division=zero_division)


def jaccard_index(
    preds,
    target,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> torch.Tensor:
    """Task dispatch over the three Jaccard indices.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import jaccard_index
        >>> jaccard_index(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1]), task="binary")
        tensor(1.)
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_jaccard_index(preds, target, threshold, ignore_index, validate_args, zero_division)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_jaccard_index(preds, target, num_classes, average, ignore_index, validate_args, zero_division)
    return multilabel_jaccard_index(preds, target, num_labels, threshold, average, ignore_index, validate_args,
                                    zero_division)
