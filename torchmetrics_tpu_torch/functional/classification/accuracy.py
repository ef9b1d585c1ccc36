"""Accuracy (counterpart of ``torchmetrics_tpu/functional/classification/accuracy.py``):
``_accuracy_reduce``, the three task entry points and the ``accuracy`` dispatch."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.compute import _adjust_weights_safe_divide, _safe_divide
from ._family import make_binary, make_multiclass, make_multilabel, make_task_dispatch


def _accuracy_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> torch.Tensor:
    """Reduce stat scores into accuracy."""
    if average == "binary":
        return _safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp_s, fn_s = tp.sum(dim), fn.sum(dim)
        if multilabel:
            fp_s, tn_s = fp.sum(dim), tn.sum(dim)
            return _safe_divide(tp_s + tn_s, tp_s + tn_s + fp_s + fn_s)
        return _safe_divide(tp_s, tp_s + fn_s)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def _reduce(tp, fp, tn, fn, average, multidim_average="global", multilabel=False, top_k=1, zero_division=0):
    return _accuracy_reduce(tp, fp, tn, fn, average, multidim_average, multilabel, top_k)


# accuracy has no ``zero_division`` argument: the public entry points below call these without it
_binary = make_binary(_reduce, "binary_accuracy")
_multiclass = make_multiclass(_reduce, "multiclass_accuracy")
_multilabel = make_multilabel(_reduce, "multilabel_accuracy")
_dispatch = make_task_dispatch(_binary, _multiclass, _multilabel, "accuracy")


def binary_accuracy(
    preds,
    target,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary accuracy.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_accuracy
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_accuracy(preds, target)
        tensor(1.)
    """
    return _binary(preds, target, threshold, multidim_average, ignore_index, validate_args)


def multiclass_accuracy(
    preds,
    target,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass accuracy.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_accuracy
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_accuracy(preds, target, num_classes=3)
        tensor(1.)
    """
    return _multiclass(preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args)


def multilabel_accuracy(
    preds,
    target,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel accuracy.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_accuracy
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_accuracy(preds, target, num_labels=3)
        tensor(0.7778)
    """
    return _multilabel(preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args)


def accuracy(
    preds,
    target,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: Optional[str] = "global",
    top_k: Optional[int] = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch over the three accuracy entry points.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import accuracy
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> accuracy(preds, target, task='multiclass', num_classes=3)
        tensor(1.)
    """
    return _dispatch(preds, target, task, threshold, num_classes, num_labels, average, multidim_average, top_k,
                     ignore_index, validate_args)
