"""ROC curves (counterpart of ``torchmetrics_tpu/functional/classification/roc.py``).

Built on the curve core of ``precision_recall_curve.py``: the binned path reads the
confusion per threshold, the exact path the batched sorted counts of every class at once.
The macro curve interpolates every class's curve onto the union of their false positive
rates, classes in chunks whose ``(chunk, points)`` interpolation stays near 2**22 entries.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _safe_divide, interp
from ...utilities.enums import ClassificationTask
from ...utilities.prints import rank_zero_warn
from .precision_recall_curve import (
    Curve,
    _binary_exact_rows,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _check_rows,
    _filter_ignored,
    _host_ints,
    _last,
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
    _numpy_order,
    _rows_to_list,
    _sorted_counts,
)
from .stat_scores import _check_task_args

_INTERP_ENTRIES = 1 << 22


def _binned_roc(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, ...) confusion -> fpr, tpr along the first axis, thresholds descending."""
    tps, fps, fns, tns = state[..., 1, 1], state[..., 0, 1], state[..., 1, 0], state[..., 0, 0]
    return _safe_divide(fps, fps + tns).flip(0), _safe_divide(tps, tps + fns).flip(0)


def _exact_roc_rows(preds: torch.Tensor, positive: torch.Tensor, keep: Optional[torch.Tensor] = None):
    """-> (fpr, tpr, thresholds, lengths, no_negatives, no_positives): padded rows of
    the exact ROC curves of the ``(K, N)`` scores, each starting at (0, 0) with the
    extra threshold 1; a row without negatives (positives) has fpr (tpr) 0."""
    fps, tps, thresholds, lengths = _sorted_counts(preds, positive, keep)
    fps_last, tps_last = _last(fps, lengths), _last(tps, lengths)
    zero = torch.zeros_like(fps[:, :1])
    fpr = torch.where(fps_last > 0, torch.cat([zero, fps], 1) / fps_last, 0.0)
    tpr = torch.where(tps_last > 0, torch.cat([zero, tps], 1) / tps_last, 0.0)
    thresholds = torch.cat([torch.ones_like(thresholds[:, :1]), thresholds], 1)
    return fpr, tpr, thresholds, lengths + 1, fps_last[:, 0] <= 0, tps_last[:, 0] <= 0


def _warn_roc(no_negatives: List[int], no_positives: List[int]) -> None:
    if any(no_negatives):
        rank_zero_warn("No negative samples in targets, false positive value should be meaningless.", UserWarning)
    if any(no_positives):
        rank_zero_warn("No positive samples in targets, true positive value should be meaningless.", UserWarning)


def _exact_roc_curve_rows(preds: torch.Tensor, positive: torch.Tensor, keep: Optional[torch.Tensor] = None):
    """-> (fpr, tpr, thresholds, points): ``_exact_roc_rows`` after one host read, which
    raises on an empty row and warns where a row has no negatives or no positives."""
    fpr, tpr, thresholds, points, no_negatives, no_positives = _exact_roc_rows(preds, positive, keep)
    (empty, no_negatives, no_positives), = _host_ints(
        torch.stack([(points == 1).any(), no_negatives.any(), no_positives.any()]))
    _check_rows(empty)
    _warn_roc([no_negatives], [no_positives])
    return fpr, tpr, thresholds, points


def _exact_roc_compute(preds: torch.Tensor, positive: torch.Tensor, keep: Optional[torch.Tensor] = None):
    """Per-row exact ROC curves as lists, and the rows themselves."""
    fpr, tpr, thresholds, lengths, no_negatives, no_positives = rows = _exact_roc_rows(preds, positive, keep)
    points, no_negatives, no_positives = _host_ints(lengths, no_negatives, no_positives)
    _check_rows(1 in points)
    _warn_roc(no_negatives, no_positives)
    fprs, tprs = _rows_to_list(fpr, points), _rows_to_list(tpr, points)
    if thresholds.dtype != fpr.dtype:  # a degenerate row is zeros in the thresholds' dtype, as in the JAX package
        fprs = [f.to(thresholds.dtype) if flag else f for f, flag in zip(fprs, no_negatives)]
        tprs = [t.to(thresholds.dtype) if flag else t for t, flag in zip(tprs, no_positives)]
    return (fprs, tprs, _rows_to_list(thresholds, points)), rows


def _binary_roc_compute(state, thresholds: Optional[torch.Tensor], pos_label: int = 1) -> Curve:
    if not isinstance(state, tuple) and thresholds is not None:
        fpr, tpr = _binned_roc(state)
        return fpr, tpr, thresholds.flip(0)
    preds, positive, _ = _binary_exact_rows(state[0], state[1], pos_label)
    ((fpr,), (tpr,), (thres,)), _ = _exact_roc_compute(preds, positive)
    return fpr, tpr, thres


def binary_roc(preds, target, thresholds=None, ignore_index: Optional[int] = None, validate_args: bool = True) -> Curve:
    """Binary ROC curve: (fpr, tpr, thresholds), thresholds descending.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_roc
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_roc(preds, target, thresholds=5)
        (tensor([0.0000, 0.0000, 0.0000, 0.3333, 1.0000]), tensor([0.0000, 0.6667, 1.0000, 1.0000, 1.0000]), tensor([1.0000, 0.7500, 0.5000, 0.2500, 0.0000]))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, w = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, w)
    return _binary_roc_compute(state, thresholds)


def _macro_interpolate_curves(
    fpr: torch.Tensor, tpr: torch.Tensor, thresholds: torch.Tensor, num_classes: int,
    lengths: Optional[torch.Tensor] = None,
) -> Curve:
    """Macro curve: every class's curve (padded ``(C, L)`` rows, the first
    ``lengths[i]`` points valid) interpolated onto the sorted union of their false
    positive rates, the true positive rates averaged. ``thresholds`` (flat) are sorted
    descending as the JAX package's ``-jnp.sort(-thres)`` sorts them: a stable sort in
    which the zeros tie and every NaN comes last."""
    thresholds = thresholds[_numpy_order(-thresholds)]
    if lengths is None:
        lengths = torch.full((fpr.shape[0],), fpr.shape[1], dtype=torch.int64, device=fpr.device)
    valid = torch.arange(fpr.shape[1], device=fpr.device) < lengths[:, None]
    mean_fpr = torch.sort(fpr[valid]).values
    mean_tpr = torch.zeros_like(mean_fpr)
    chunk = max(1, _INTERP_ENTRIES // max(mean_fpr.numel(), 1))
    for start in range(0, num_classes, chunk):
        rows = slice(start, start + chunk)
        mean_tpr = mean_tpr + interp(mean_fpr, fpr[rows], tpr[rows], lengths[rows]).sum(0)
    return mean_fpr, mean_tpr / num_classes, thresholds


def _multiclass_roc_compute(state, num_classes: int, thresholds: Optional[torch.Tensor], average: Optional[str] = None):
    if average == "micro":
        return _binary_roc_compute(state, thresholds)
    if not isinstance(state, tuple) and thresholds is not None:
        fpr, tpr = _binned_roc(state)
        fpr, tpr = fpr.T, tpr.T
        if average == "macro":
            return _macro_interpolate_curves(fpr, tpr, thresholds.flip(0).repeat(num_classes), num_classes)
        return fpr, tpr, thresholds.flip(0)
    lists, (fpr, tpr, thres, lengths, _, _) = _exact_roc_compute(*_multiclass_exact_rows(state[0], state[1],
                                                                                         num_classes)[:2])
    if average == "macro":
        return _macro_interpolate_curves(fpr, tpr, torch.cat(lists[2]), num_classes, lengths)
    return lists


def multiclass_roc(
    preds,
    target,
    num_classes: int,
    thresholds=None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Multiclass ROC curves, one-vs-rest (``average="micro"``: one flattened curve;
    ``"macro"``: the classes' curves averaged).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_roc
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> fpr, tpr, thresholds = multiclass_roc(preds, target, num_classes=3, thresholds=5)
        >>> tpr
        tensor([[0.0000, 1.0000, 1.0000, 1.0000, 1.0000],
                [0.0000, 0.5000, 0.5000, 1.0000, 1.0000],
                [0.0000, 0.0000, 1.0000, 1.0000, 1.0000]])
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, w = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, w, average)
    return _multiclass_roc_compute(state, num_classes, thresholds, average)


def _multilabel_roc_compute(
    state, num_labels: int, thresholds: Optional[torch.Tensor], ignore_index: Optional[int] = None
):
    if not isinstance(state, tuple) and thresholds is not None:
        return _multiclass_roc_compute(state, num_labels, thresholds, None)
    preds, positive, _, keep = _multilabel_exact_rows(state[0], state[1], ignore_index)
    lists, _ = _exact_roc_compute(preds, positive, keep)
    return lists


def multilabel_roc(
    preds, target, num_labels: int, thresholds=None, ignore_index: Optional[int] = None, validate_args: bool = True
):
    """Multilabel ROC curves, one per label.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_roc
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> fpr, tpr, thresholds = multilabel_roc(preds, target, num_labels=3, thresholds=5)
        >>> fpr
        tensor([[0.0000, 0.0000, 0.0000, 0.5000, 1.0000],
                [0.0000, 0.5000, 0.5000, 0.5000, 1.0000],
                [0.0000, 0.0000, 0.0000, 0.0000, 1.0000]])
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, w = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, w)
    return _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)


def roc(
    preds,
    target,
    task: str,
    thresholds=None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task dispatch over the three ROC curves.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import roc
        >>> roc(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1]), task="binary")
        (tensor([0., 0., 0., 1.]), tensor([0.0000, 0.5000, 1.0000, 1.0000]), tensor([1.0000, 0.8000, 0.6000, 0.2000]))
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_roc(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_roc(preds, target, num_classes, thresholds, average, ignore_index, validate_args)
    return multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
