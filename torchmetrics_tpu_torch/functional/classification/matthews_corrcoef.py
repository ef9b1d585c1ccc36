"""Matthews correlation coefficient (counterpart of
``torchmetrics_tpu/functional/classification/matthews_corrcoef.py``).

The JAX package reduces the confusion matrix on the host in float64, with eight special
cases for a binary matrix whose denominator is 0. Here the same float64 arithmetic runs
on the metric's device and ``torch.where`` picks the case, so nothing waits for the host;
a multilabel ``(C, 2, 2)`` matrix is folded to one binary matrix first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...utilities.checks import _as_tensor
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

# float32's epsilon and its float32 square root, both taken exactly into float64, as the
# JAX package's numpy mixes them into its float64 sums
_EPS = float(np.finfo(np.float32).eps)
_SQRT_EPS = float(np.sqrt(np.finfo(np.float32).eps))


def _matthews_corrcoef_reduce(confmat: torch.Tensor) -> torch.Tensor:
    """Unnormalised confusion matrix -> MCC, float32."""
    cm = confmat.to(torch.float64)
    if cm.ndim == 3:  # multilabel -> binary fold
        cm = cm.sum(0)
    tk, pk = cm.sum(-1), cm.sum(-2)
    c, s = torch.trace(cm), cm.sum()
    numerator = c * s - (tk * pk).sum()
    denom = (s**2 - (pk * pk).sum()) * (s**2 - (tk * tk).sum())
    if cm.numel() != 4:
        value = torch.where(denom == 0, 0.0, numerator / denom.sqrt())
        return value.to(torch.float32)
    tn, fp, fn, tp = cm.reshape(-1)
    # the denominator-zero cases, in the JAX package's order; none of them -> 0
    cases = [
        (fn == 0) & (tn == 0),
        (fp == 0) & (tn == 0),
        (tp == 0) & (fn == 0),
        (tp == 0) & (fp == 0),
        tp == 0,
        tn == 0,
        (fp == 0) | (fn == 0),
    ]
    numerators = [_SQRT_EPS * (tp - fp), _SQRT_EPS * (tp - fn), _SQRT_EPS * (tn - fp), _SQRT_EPS * (tn - fn),
                  tn - fp * fn, tp - fp * fn, tp * tn]
    zero_numerator = torch.zeros_like(tp)
    for case, value in zip(reversed(cases), reversed(numerators)):
        zero_numerator = torch.where(case, value, zero_numerator)
    any_case = torch.stack(cases).any()
    zero_denom = (tp + fp + _EPS) * (tp + fn + _EPS) * (tn + fp + _EPS) * (tn + fn + _EPS)
    degenerate = denom == 0
    value = torch.where(degenerate, zero_numerator, numerator) / torch.where(degenerate, zero_denom, denom).sqrt()
    value = torch.where(degenerate & ~any_case, 0.0, value)
    value = torch.where((tp + tn == 0) & (fp + fn != 0), -1.0, value)
    value = torch.where((tp + tn != 0) & (fp + fn == 0), 1.0, value)
    return value.to(torch.float32)


def binary_matthews_corrcoef(
    preds, target, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Binary MCC.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_matthews_corrcoef
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_matthews_corrcoef(preds, target)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, w = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_binary_confusion_matrix_update(preds, target, w))


def multiclass_matthews_corrcoef(
    preds, target, num_classes: int, ignore_index: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Multiclass MCC.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_matthews_corrcoef
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_matthews_corrcoef(preds, target, num_classes=3)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, w = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    return _matthews_corrcoef_reduce(_multiclass_confusion_matrix_update(preds, target, w, num_classes))


def multilabel_matthews_corrcoef(
    preds,
    target,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel MCC (the labels' confusion matrices summed into one).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_matthews_corrcoef
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_matthews_corrcoef(preds, target, num_labels=3)
        tensor(0.5500)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize=None)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, w = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_multilabel_confusion_matrix_update(preds, target, w, num_labels))


def matthews_corrcoef(
    preds,
    target,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch over the three MCCs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import matthews_corrcoef
        >>> matthews_corrcoef(torch.tensor([0.2, 0.8, 0.6, 0.1]), torch.tensor([0, 1, 1, 1]), task="binary")
        tensor(0.5774)
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args)
    return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args)
