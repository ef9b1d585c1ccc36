"""Group fairness: per-group stat-score rates, demographic parity and equal opportunity
(counterpart of ``torchmetrics_tpu/functional/classification/group_fairness.py``).

Each (group, outcome) pair is one bin of a single ``index_add_`` pass: ``4 * group +
2 * target + pred`` counts tn, fp, fn and tp per group as int32, the JAX package's
dtype. Entries outside ``[0, num_groups)`` or ignored count nowhere, as the JAX
package's ``segment_sum`` drops them. The result dicts are keyed by the groups of the
lowest and highest rate, each the first such group on a tie.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _safe_divide
from ...utilities.prints import rank_zero_warn
from .precision_recall_curve import _host_ints
from .stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _groups_validation(groups: torch.Tensor, num_groups: int) -> None:
    if groups.is_floating_point() or groups.is_complex() or groups.dtype == torch.bool:
        raise ValueError(f"Expected dtype of argument groups to be integer, not {groups.dtype}.")
    largest = int(groups.max())
    if largest >= num_groups:
        raise ValueError(
            f"The largest number in the groups tensor is {largest}, which is out of range for the "
            f"specified number of groups {num_groups}. The group identifiers should be ``0, 1, ..., (num_groups - 1)``."
        )


def _binary_groups_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    groups: torch.Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Counts:
    """Per-group (tp, fp, tn, fn), each int32 ``(num_groups,)``."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target, w = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    g = groups.reshape(-1).to(torch.int64)
    counted = (w.reshape(-1) == 1) & (g >= 0) & (g < num_groups)
    bins = torch.where(counted, 4 * g + 2 * target.reshape(-1) + preds.reshape(-1), 4 * num_groups)
    counts = torch.zeros(4 * num_groups + 1, dtype=torch.int64, device=bins.device)
    counts.index_add_(0, bins, torch.ones_like(bins))
    tn, fp, fn, tp = counts[:-1].reshape(num_groups, 4).to(torch.int32).unbind(1)
    return tp, fp, tn, fn


def binary_groups_stat_rates(
    preds,
    target,
    groups,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """Each group's ``[tp, fp, tn, fn]`` over its count, keyed ``group_{g}``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_groups_stat_rates
        >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> binary_groups_stat_rates(preds, target, groups, num_groups=2)
        {'group_0': tensor([0.3333, 0.0000, 0.6667, 0.0000]), 'group_1': tensor([0.6667, 0.0000, 0.3333, 0.0000])}
    """
    preds, target, groups = _as_tensor(preds), _as_tensor(target), _as_tensor(groups)
    counts = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    return _groups_rates(*counts)


def _groups_rates(tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> Dict[str, torch.Tensor]:
    stats = torch.stack([tp, fp, tn, fn], dim=-1)
    rates = _safe_divide(stats, stats.sum(-1, keepdim=True))
    return {f"group_{g}": rates[g] for g in range(rates.shape[0])}


def _lowest_to_highest(rates: torch.Tensor, prefix: str) -> Dict[str, torch.Tensor]:
    """``{f"{prefix}_{lo}_{hi}": rates[lo] / rates[hi]}`` for the first groups of the
    lowest and the highest rate (one host read of the two indices)."""
    lo, hi = _host_ints(torch.stack([rates.argmin(), rates.argmax()]))[0]
    return {f"{prefix}_{lo}_{hi}": _safe_divide(rates[lo], rates[hi])}


def _compute_binary_demographic_parity(tp, fp, tn, fn) -> Dict[str, torch.Tensor]:
    """The lowest group's positive rate over the highest's."""
    return _lowest_to_highest(_safe_divide(tp + fp, tp + fp + tn + fn), "DP")


def _compute_binary_equal_opportunity(tp, fp, tn, fn) -> Dict[str, torch.Tensor]:
    """The lowest group's true positive rate over the highest's."""
    return _lowest_to_highest(_safe_divide(tp, tp + fn), "EO")


def _num_groups(groups: torch.Tensor) -> int:
    """The count of distinct group ids (a host read)."""
    return int(torch.unique(groups).numel())


def demographic_parity(
    preds, groups, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True
) -> Dict[str, torch.Tensor]:
    """Positive-rate parity across groups (no target needed).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import demographic_parity
        >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> demographic_parity(preds, groups)
        {'DP_0_1': tensor(0.5000)}
    """
    preds, groups = _as_tensor(preds), _as_tensor(groups)
    target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    stats = _binary_groups_stat_scores(preds, target, groups, _num_groups(groups), threshold, ignore_index,
                                       validate_args)
    return _compute_binary_demographic_parity(*stats)


def equal_opportunity(
    preds, target, groups, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True
) -> Dict[str, torch.Tensor]:
    """True-positive-rate parity across groups.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import equal_opportunity
        >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> equal_opportunity(preds, target, groups)
        {'EO_0_0': tensor(1.)}
    """
    preds, target, groups = _as_tensor(preds), _as_tensor(target), _as_tensor(groups)
    stats = _binary_groups_stat_scores(preds, target, groups, _num_groups(groups), threshold, ignore_index,
                                       validate_args)
    return _compute_binary_equal_opportunity(*stats)


def binary_fairness(
    preds,
    target,
    groups,
    task: str = "all",
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """Demographic parity and/or equal opportunity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_fairness
        >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> binary_fairness(preds, target, groups)
        {'DP_0_1': tensor(0.5000), 'EO_0_0': tensor(1.)}
    """
    if task not in ["demographic_parity", "equal_opportunity", "all"]:
        raise ValueError(
            f"Expected argument `task` to either be ``demographic_parity``,"
            f"``equal_opportunity`` or ``all`` but got {task}."
        )
    preds, groups = _as_tensor(preds), _as_tensor(groups)
    if task == "demographic_parity":
        if target is not None:
            rank_zero_warn("The task demographic_parity does not require a target.", UserWarning)
        target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    target = _as_tensor(target)
    stats = _binary_groups_stat_scores(preds, target, groups, _num_groups(groups), threshold, ignore_index,
                                       validate_args)
    if task == "demographic_parity":
        return _compute_binary_demographic_parity(*stats)
    if task == "equal_opportunity":
        return _compute_binary_equal_opportunity(*stats)
    return {**_compute_binary_demographic_parity(*stats), **_compute_binary_equal_opportunity(*stats)}
