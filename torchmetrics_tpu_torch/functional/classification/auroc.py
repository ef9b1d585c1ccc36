"""Area under the ROC curve (counterpart of
``torchmetrics_tpu/functional/classification/auroc.py``).

The exact multiclass and multilabel areas come from the padded rows of every class's
curve at once (a padded point repeats the row's last one, so it adds no area), not from a
loop over per-class curves. ``max_fpr``'s McClish correction reads the binary curve back
to the host, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _auc_compute
from ...utilities.enums import ClassificationTask
from .precision_recall_curve import (
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _filter_ignored,
    _multiclass_exact_rows,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_exact_rows,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
    _reduce_class_scores,
)
from .roc import _binary_roc_compute, _binned_roc, _exact_roc_curve_rows
from .stat_scores import _check_task_args


def _reduce_auroc(
    fpr: torch.Tensor, tpr: torch.Tensor, average: Optional[str] = "macro", weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The areas under the curves in the rows of ``(fpr, tpr)`` -> ``average``."""
    return _reduce_class_scores(_auc_compute(fpr, tpr, 1.0), average, weights)


def _binary_auroc_arg_validation(max_fpr: Optional[float] = None, thresholds=None, ignore_index=None) -> None:
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _binary_auroc_compute(
    state, thresholds: Optional[torch.Tensor], max_fpr: Optional[float] = None, pos_label: int = 1
) -> torch.Tensor:
    fpr, tpr, _ = _binary_roc_compute(state, thresholds, pos_label)
    if max_fpr is None or max_fpr == 1 or float(fpr.sum()) == 0 or float(tpr.sum()) == 0:
        return _auc_compute(fpr, tpr, 1.0)
    # partial area up to max_fpr with McClish's correction, on the host's copy of the curve
    fpr_h, tpr_h = fpr.cpu().numpy(), tpr.cpu().numpy()
    stop = int(np.searchsorted(fpr_h, max_fpr, side="right"))
    weight = (max_fpr - float(fpr_h[stop - 1])) / (float(fpr_h[stop]) - float(fpr_h[stop - 1]))
    interp_tpr = float(tpr_h[stop - 1]) * (1 - weight) + float(tpr_h[stop]) * weight
    tpr_p = torch.cat([tpr[:stop], torch.tensor([interp_tpr], dtype=tpr.dtype, device=tpr.device)])
    fpr_p = torch.cat([fpr[:stop], torch.tensor([max_fpr], dtype=fpr.dtype, device=fpr.device)])
    partial_auc = _auc_compute(fpr_p, tpr_p, 1.0)
    min_area = 0.5 * max_fpr**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_fpr - min_area))


def binary_auroc(
    preds,
    target,
    max_fpr: Optional[float] = None,
    thresholds=None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary AUROC (``max_fpr``: the standardised partial area up to that rate).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_auroc
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_auroc(preds, target)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, w = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, w)
    return _binary_auroc_compute(state, thresholds, max_fpr)


def _multiclass_auroc_arg_validation(num_classes, average="macro", thresholds=None, ignore_index=None) -> None:
    if average not in ("macro", "weighted", "none", None):
        raise ValueError(f"Expected argument `average` to be one of ('macro', 'weighted', 'none', None) but got {average}")
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)


def _binned_support(state: torch.Tensor) -> torch.Tensor:
    """Positives per class of a binned ``(T, C, 2, 2)`` state, float32."""
    return (state[0, :, 1, 0] + state[0, :, 1, 1]).to(torch.float32)


def _multiclass_auroc_compute(
    state, num_classes: int, average: Optional[str] = "macro", thresholds: Optional[torch.Tensor] = None
) -> torch.Tensor:
    if not isinstance(state, tuple) and thresholds is not None:
        fpr, tpr = _binned_roc(state)
        return _reduce_auroc(fpr.T, tpr.T, average, _binned_support(state))
    preds, positive, _ = _multiclass_exact_rows(state[0], state[1], num_classes)
    weights = torch.bincount(state[1].long(), minlength=num_classes).to(torch.float32)
    return _reduce_auroc(*_exact_roc_curve_rows(preds, positive)[:2], average, weights)


def multiclass_auroc(
    preds,
    target,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds=None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass AUROC, one-vs-rest.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_auroc
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_auroc(preds, target, num_classes=3)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, w = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, w)
    return _multiclass_auroc_compute(state, num_classes, average, thresholds)


def _multilabel_auroc_arg_validation(num_labels, average="macro", thresholds=None, ignore_index=None) -> None:
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None) but got {average}"
        )
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)


def _flatten_multilabel(state, ignore_index: Optional[int]):
    """The exact multilabel state as one binary problem, ignored entries dropped."""
    preds, target = state[0].reshape(-1), state[1].reshape(-1)
    if ignore_index is not None:
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    return preds, target


def _multilabel_support(target: torch.Tensor, ignore_index: Optional[int]) -> torch.Tensor:
    """Positives per label of an exact ``(M, C)`` target, float32."""
    if ignore_index is not None:
        target = torch.where(target == ignore_index, 0, target)
    return (target == 1).sum(0).to(torch.float32)


def _multilabel_auroc_compute(
    state,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Optional[torch.Tensor] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    binned = not isinstance(state, tuple) and thresholds is not None
    if average == "micro":
        if binned:
            return _binary_auroc_compute(state.sum(1).to(torch.int32), thresholds, max_fpr=None)
        return _binary_auroc_compute(_flatten_multilabel(state, ignore_index), None, max_fpr=None)
    if binned:
        fpr, tpr = _binned_roc(state)
        return _reduce_auroc(fpr.T, tpr.T, average, _binned_support(state))
    preds, positive, _, keep = _multilabel_exact_rows(state[0], state[1], ignore_index)
    return _reduce_auroc(*_exact_roc_curve_rows(preds, positive, keep)[:2], average,
                         _multilabel_support(state[1], ignore_index))


def multilabel_auroc(
    preds,
    target,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds=None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel AUROC.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_auroc
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_auroc(preds, target, num_labels=3)
        tensor(0.8333)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, w = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, w)
    return _multilabel_auroc_compute(state, num_labels, average, thresholds, ignore_index)


def auroc(
    preds,
    target,
    task: str,
    thresholds=None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch over the three AUROCs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import auroc
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> auroc(preds, target, task="binary")
        tensor(1.)
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    return multilabel_auroc(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
