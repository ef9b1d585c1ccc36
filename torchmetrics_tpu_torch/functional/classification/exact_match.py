"""Exact match, the share of samples whose every position is right (counterpart of
``torchmetrics_tpu/functional/classification/exact_match.py``).

A sample counts as correct when all its positions (multidim inputs) are; positions whose
target is ``ignore_index`` count as correct. Counts are int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _safe_divide
from ...utilities.enums import ClassificationTaskNoBinary
from .stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)


def _exact_match_reduce(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return _safe_divide(correct, total)


def _multiclass_exact_match_update(
    preds: torch.Tensor, target: torch.Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (correct, total): 0-d int32 counts (global) or ``(N,)`` (samplewise)."""
    if preds.ndim == target.ndim + 1:
        preds = preds.argmax(dim=1)
    n = target.shape[0]
    target = target.reshape(n, -1)
    ok = preds.reshape(n, -1) == target
    if ignore_index is not None:
        ok = ok | (target == ignore_index)
    correct = ok.all(dim=1).to(torch.int32)
    if multidim_average == "global":
        return correct.sum(dtype=torch.int32), torch.tensor(n, dtype=torch.int32, device=correct.device)
    return correct, torch.ones((n,), dtype=torch.int32, device=correct.device)


def multiclass_exact_match(
    preds,
    target,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass exact match.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_exact_match
        >>> preds = torch.tensor([[0, 1, 2], [1, 1, 2]])
        >>> target = torch.tensor([[0, 1, 2], [2, 1, 2]])
        >>> multiclass_exact_match(preds, target, num_classes=3)
        tensor(0.5000)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    correct, total = _multiclass_exact_match_update(preds, target, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def _multilabel_exact_match_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (correct, total) over the ``(N, S)`` samples and positions: 0-d int32 counts
    (global) or ``(N,)`` (samplewise)."""
    p, t, w = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)  # (N, C, S)
    correct = ((p == t) | (w == 0)).all(dim=1).to(torch.int32)  # (N, S)
    if multidim_average == "global":
        return correct.sum(dtype=torch.int32), torch.tensor(correct.numel(), dtype=torch.int32, device=correct.device)
    return correct.sum(dim=1, dtype=torch.int32), torch.full((correct.shape[0],), correct.shape[1],
                                                             dtype=torch.int32, device=correct.device)


def multilabel_exact_match(
    preds,
    target,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multilabel exact match.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_exact_match
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_exact_match(preds, target, num_labels=3)
        tensor(0.3333)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    correct, total = _multilabel_exact_match_update(preds, target, num_labels, threshold, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def exact_match(
    preds,
    target,
    task: str,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch (multiclass or multilabel).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import exact_match
        >>> exact_match(torch.tensor([[0, 1], [1, 1]]), torch.tensor([[0, 1], [0, 1]]), task="multiclass", num_classes=2)
        tensor(0.5000)
    """
    task = ClassificationTaskNoBinary.from_str(task)
    if task == ClassificationTaskNoBinary.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
    return multilabel_exact_match(preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args)
