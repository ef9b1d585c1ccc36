"""Multilabel ranking metrics: coverage error, label ranking average precision and
ranking loss (counterpart of ``torchmetrics_tpu/functional/classification/ranking.py``).

The JAX package compares every pair of labels of every sample at once, an ``(N, C, C)``
array that XLA may fuse away; eager PyTorch would build it (419M entries, 1.68 GB as
float32, at 65,536 samples of 80 labels). Here the samples go in chunks of at most
``_PAIR_ENTRIES`` pairs, and the pairs are counted with integer sums, never a float
matmul, so TF32 cannot touch them. PyTorch sums a boolean mask through an int64 copy, so
a chunk's temporaries are about 10 bytes a pair: 170 MB at ``2**24`` pairs. Ties rank
as in the JAX package (a label's rank counts every label scored at least as high).
Each batch's float sums are accumulated in float64 and rounded once to float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _float32_sum, normalize_logits_if_needed
from .stat_scores import _multilabel_stat_scores_tensor_validation

_PAIR_ENTRIES = 1 << 24


def _ranking_reduce(score: torch.Tensor, num_elements: torch.Tensor) -> torch.Tensor:
    return score / num_elements


def _row_chunks(n: int, c: int):
    """Slices of at most ``_PAIR_ENTRIES // c**2`` samples covering ``n``."""
    rows = max(1, _PAIR_ENTRIES // max(c * c, 1))
    return [slice(start, start + rows) for start in range(0, n, rows)]


def _multilabel_ranking_tensor_validation(preds: torch.Tensor, target: torch.Tensor, num_labels: int,
                                          ignore_index: Optional[int] = None) -> None:
    _multilabel_stat_scores_tensor_validation(preds, target, num_labels, "global", ignore_index)
    if not preds.is_floating_point():
        raise ValueError(f"Expected preds tensor to be floating point, but received input with dtype {preds.dtype}")


def _multilabel_ranking_format(preds: torch.Tensor, target: torch.Tensor, num_labels: int,
                               ignore_index: Optional[int] = None):
    """-> (``(N, C)`` float32 scores after one batch-wide sigmoid when needed, int32
    targets); ignored entries count as negatives."""
    preds = normalize_logits_if_needed(preds.reshape(-1, num_labels).to(torch.float32), "sigmoid")
    target = target.reshape(-1, num_labels)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, 0, target)
    return preds, target.to(torch.int32)


def _count(n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(float(n), dtype=torch.float32, device=device)


def _multilabel_coverage_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """How deep in each sample's ranking the last relevant label lies: the labels scored
    at least as high as its lowest-scored relevant one (float32 offsets, as in the JAX
    package, push the irrelevant ones out of the minimum)."""
    big = preds.min().abs() + 10
    lowest = torch.where(target == 0, preds + big, preds).amin(1)
    coverage = (preds >= lowest[:, None]).sum(1)
    return coverage.sum().to(torch.float32), _count(preds.shape[0], preds.device)


def multilabel_coverage_error(
    preds, target, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Multilabel coverage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_coverage_error
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_coverage_error(preds, target, num_labels=3)
        tensor(1.3333)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    return _ranking_reduce(*_multilabel_coverage_error_update(preds, target))


def _multilabel_ranking_average_precision_update(preds: torch.Tensor,
                                                 target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sample, the mean over its relevant labels of the share of relevant labels
    among those scored at least as high; 1 for a sample with none or all relevant."""
    n, c = preds.shape
    relevant = target == 1
    k = relevant.sum(-1)
    scores = []
    for rows in _row_chunks(n, c):
        p, rel = preds[rows], relevant[rows]
        at_least = p[:, :, None] <= p[:, None, :]  # [i, j, l]: label l scored at least as high as label j
        rank_all = at_least.sum(-1).to(torch.float32)
        rank_rel = (at_least & rel[:, None, :]).sum(-1).to(torch.float32)
        frac = torch.where(rel, rank_rel / rank_all.clamp(min=1.0), 0.0)
        scores.append(_float32_sum(frac, -1) / k[rows].clamp(min=1))
    score = torch.cat(scores) if scores else preds.new_zeros(0)
    score = torch.where((k > 0) & (k < c), score, 1.0)
    return _float32_sum(score), _count(n, preds.device)


def multilabel_ranking_average_precision(
    preds, target, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Multilabel label ranking average precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_ranking_average_precision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_ranking_average_precision(preds, target, num_labels=3)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    return _ranking_reduce(*_multilabel_ranking_average_precision_update(preds, target))


def _multilabel_ranking_loss_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sample, the share of (relevant, irrelevant) label pairs ordered wrongly (the
    irrelevant one scored at least as high); 0 for a sample with none or all relevant."""
    n, c = preds.shape
    relevant = target == 1
    wrong = []
    for rows in _row_chunks(n, c):
        p, rel = preds[rows], relevant[rows]
        at_least = p[:, None, :] >= p[:, :, None]  # [i, r, l]: label l scored at least as high as label r
        wrong.append((at_least & rel[:, :, None] & ~rel[:, None, :]).sum((1, 2)))
    wrong = torch.cat(wrong) if wrong else torch.zeros(0, dtype=torch.int64, device=preds.device)
    k = relevant.sum(-1)
    denom = k * (c - k)
    loss = torch.where(denom > 0, wrong.to(torch.float32) / denom.clamp(min=1).to(torch.float32), 0.0)
    return _float32_sum(loss), _count(n, preds.device)


def multilabel_ranking_loss(
    preds, target, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Multilabel ranking loss.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_ranking_loss
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_ranking_loss(preds, target, num_labels=3)
        tensor(0.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    return _ranking_reduce(*_multilabel_ranking_loss_update(preds, target))
