"""Task-dispatch functions of the four operating points (counterpart of
``torchmetrics_tpu/functional/classification/_operating_point_facades.py``): one
dispatcher serves all four, which differ only in the floor's name and their binary,
multiclass and multilabel functions.
"""

from __future__ import annotations

from typing import Optional

from ...utilities.enums import ClassificationTask
from .precision_fixed_recall import (
    binary_precision_at_fixed_recall,
    multiclass_precision_at_fixed_recall,
    multilabel_precision_at_fixed_recall,
)
from .recall_fixed_precision import (
    binary_recall_at_fixed_precision,
    multiclass_recall_at_fixed_precision,
    multilabel_recall_at_fixed_precision,
)
from .sensitivity_specificity import (
    binary_sensitivity_at_specificity,
    multiclass_sensitivity_at_specificity,
    multilabel_sensitivity_at_specificity,
)
from .specificity_sensitivity import (
    binary_specificity_at_sensitivity,
    multiclass_specificity_at_sensitivity,
    multilabel_specificity_at_sensitivity,
)
from .stat_scores import _check_task_args


def _dispatch(
    triple,
    preds,
    target,
    task: str,
    floor: float,
    thresholds,
    num_classes: Optional[int],
    num_labels: Optional[int],
    ignore_index: Optional[int],
    validate_args: bool,
):
    binary_fn, multiclass_fn, multilabel_fn = triple
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_fn(preds, target, floor, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_fn(preds, target, num_classes, floor, thresholds, ignore_index, validate_args)
    return multilabel_fn(preds, target, num_labels, floor, thresholds, ignore_index, validate_args)


def precision_at_fixed_recall(
    preds,
    target,
    task: str,
    min_recall: float,
    thresholds=None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Highest precision (and its threshold) with recall >= ``min_recall``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import precision_at_fixed_recall
        >>> precision_at_fixed_recall(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 0]), task="binary", min_recall=0.5)
        (tensor(1.), tensor(0.6000))
    """
    return _dispatch(
        (binary_precision_at_fixed_recall, multiclass_precision_at_fixed_recall, multilabel_precision_at_fixed_recall),
        preds, target, task, min_recall, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )


def recall_at_fixed_precision(
    preds,
    target,
    task: str,
    min_precision: float,
    thresholds=None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Highest recall (and its threshold) with precision >= ``min_precision``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import recall_at_fixed_precision
        >>> recall_at_fixed_precision(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 0]), task="binary", min_precision=0.5)
        (tensor(1.), tensor(0.6000))
    """
    return _dispatch(
        (binary_recall_at_fixed_precision, multiclass_recall_at_fixed_precision, multilabel_recall_at_fixed_precision),
        preds, target, task, min_precision, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )


def sensitivity_at_specificity(
    preds,
    target,
    task: str,
    min_specificity: float,
    thresholds=None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Highest sensitivity (and its threshold) with specificity >= ``min_specificity``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import sensitivity_at_specificity
        >>> sensitivity_at_specificity(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 0]), task="binary", min_specificity=0.5)
        (tensor(1.), tensor(0.6000))
    """
    return _dispatch(
        (binary_sensitivity_at_specificity, multiclass_sensitivity_at_specificity, multilabel_sensitivity_at_specificity),
        preds, target, task, min_specificity, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )


def specificity_at_sensitivity(
    preds,
    target,
    task: str,
    min_sensitivity: float,
    thresholds=None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Highest specificity (and its threshold) with sensitivity >= ``min_sensitivity``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import specificity_at_sensitivity
        >>> specificity_at_sensitivity(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 0]), task="binary", min_sensitivity=0.5)
        (tensor(1.), tensor(0.8000))
    """
    return _dispatch(
        (binary_specificity_at_sensitivity, multiclass_specificity_at_sensitivity, multilabel_specificity_at_sensitivity),
        preds, target, task, min_sensitivity, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )
