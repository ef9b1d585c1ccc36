"""Confusion matrices (counterpart of
``torchmetrics_tpu/functional/classification/confusion_matrix.py``).

Binary and multiclass are one bincount over the fused (target, pred) index with the 0/1
weights (``ignore_index`` is a zero weight), so, as in the JAX package, a batch's counts
are float32; the stateful classes cast them back to their int32 state. Multilabel is
``(C, 2, 2)`` from elementwise sums, laid out ``[[tn, fp], [fn, tp]]``, in int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _safe_divide, normalize_logits_if_needed
from ...utilities.data import _bincount_2d
from ...utilities.enums import ClassificationTask
from .stat_scores import (
    _binary_stat_scores_tensor_validation,
    _check_task_args,
    _counts,
    _ignore_weights,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_tensor_validation,
)

_NORMALIZE = ("true", "pred", "all", "none", None)


def _confusion_matrix_reduce(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    if normalize not in _NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_NORMALIZE}")
    if normalize is not None and normalize != "none":
        confmat = confmat.float()
        if normalize == "true":
            return _safe_divide(confmat, confmat.sum(dim=-1, keepdim=True))
        if normalize == "pred":
            return _safe_divide(confmat, confmat.sum(dim=-2, keepdim=True))
        if normalize == "all":
            return _safe_divide(confmat, confmat.sum(dim=(-2, -1), keepdim=True))
    return confmat


def _check_confmat_args(ignore_index: Optional[int], normalize: Optional[str], threshold: Optional[float] = None) -> None:
    if threshold is not None and not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in _NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_NORMALIZE}")


# --------------------------------------------------------------------- binary


def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    _check_confmat_args(ignore_index, normalize, threshold)


def _binary_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> None:
    _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)


def _binary_confusion_matrix_format(
    preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (pred labels, target labels with ignored points remapped to 0, 0/1 weights),
    flat int32; float preds as in the binary stat scores."""
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid") > threshold
    target, w = _ignore_weights(target.reshape(-1), ignore_index)
    return preds.reshape(-1).to(torch.int32), target.to(torch.int32), w


def _binary_confusion_matrix_update(preds: torch.Tensor, target: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return _bincount_2d(target, preds, 2, 2, weights=weights)


def _binary_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def binary_confusion_matrix(
    preds,
    target,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary confusion matrix, float32 (rows = target).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_confusion_matrix
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_confusion_matrix(preds, target)
        tensor([[3., 0.],
                [0., 3.]])
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, w = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _binary_confusion_matrix_compute(_binary_confusion_matrix_update(preds, target, w), normalize)


# ------------------------------------------------------------------ multiclass


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _check_confmat_args(ignore_index, normalize)


def _multiclass_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)


def _multiclass_confusion_matrix_format(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (pred labels, target labels with ignored points remapped to 0, 0/1 weights), flat."""
    if preds.ndim == target.ndim + 1:
        preds = preds.argmax(dim=1)
    target, w = _ignore_weights(target.reshape(-1), ignore_index)
    return preds.reshape(-1), target.to(torch.int32), w


def _multiclass_confusion_matrix_update(
    preds: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, num_classes: int
) -> torch.Tensor:
    return _bincount_2d(target, preds, num_classes, num_classes, weights=weights)


def _multiclass_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multiclass_confusion_matrix(
    preds,
    target,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass confusion matrix, float32 (rows = target).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_confusion_matrix
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_confusion_matrix(preds, target, num_classes=3)
        tensor([[1., 0., 0.],
                [0., 2., 0.],
                [0., 0., 1.]])
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, w = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    return _multiclass_confusion_matrix_compute(_multiclass_confusion_matrix_update(preds, target, w, num_classes),
                                                normalize)


# ------------------------------------------------------------------ multilabel


def _multilabel_confusion_matrix_arg_validation(
    num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _check_confmat_args(ignore_index, normalize, threshold)


def _multilabel_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _multilabel_stat_scores_tensor_validation(preds, target, num_labels, "global", ignore_index)


def _multilabel_confusion_matrix_format(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (preds 0/1, target 0/1, weights), int32 ``(N * S, C)``."""
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid") > threshold
    n, c = preds.shape[0], preds.shape[1]
    preds = preds.reshape(n, c, -1).movedim(1, -1).reshape(-1, c)
    target, w = _ignore_weights(target.reshape(n, c, -1).movedim(1, -1).reshape(-1, c), ignore_index)
    return preds.to(torch.int32), target.to(torch.int32), w


def _multilabel_confusion_matrix_update(
    preds: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, num_labels: int
) -> torch.Tensor:
    """Per-label 2x2 confusion, int32 ``(C, 2, 2)``, from elementwise sums (no scatter)."""
    tp, fp, tn, fn = _counts(preds, target, weights, (0,))
    return torch.stack([tn, fp, fn, tp], dim=-1).reshape(num_labels, 2, 2)


def _multilabel_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multilabel_confusion_matrix(
    preds,
    target,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel confusion matrix, int32 ``(C, 2, 2)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_confusion_matrix
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_confusion_matrix(preds, target, num_labels=3)
        tensor([[[2, 0],
                 [0, 1]],
        <BLANKLINE>
                [[1, 1],
                 [0, 1]],
        <BLANKLINE>
                [[1, 0],
                 [1, 1]]], dtype=torch.int32)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, w = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    return _multilabel_confusion_matrix_compute(_multilabel_confusion_matrix_update(preds, target, w, num_labels),
                                                normalize)


def confusion_matrix(
    preds,
    target,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch over the three confusion matrices.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import confusion_matrix
        >>> confusion_matrix(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 0]), task="binary")
        tensor([[1., 1.],
                [0., 1.]])
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args)
    return multilabel_confusion_matrix(preds, target, num_labels, threshold, normalize, ignore_index, validate_args)
