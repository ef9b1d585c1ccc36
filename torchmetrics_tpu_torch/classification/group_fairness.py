"""Group fairness metric classes (counterpart of
``torchmetrics_tpu/classification/group_fairness.py``): the states are per-group int32
tp, fp, tn and fn, ``(num_groups,)`` each, sum-reduced and filled by one pass."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..functional.classification.group_fairness import (
    _binary_groups_stat_scores,
    _compute_binary_demographic_parity,
    _compute_binary_equal_opportunity,
    _groups_rates,
    _groups_validation,
)
from ..functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_tensor_validation,
)
from ..metric import Metric
from ..utilities.prints import rank_zero_warn


class _AbstractGroupStatScores(Metric):
    """Holds the per-group tp, fp, tn and fn states."""

    def __init__(
        self,
        num_groups: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_groups, int) or num_groups < 2:
            raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        for name in ("tp", "fp", "tn", "fn"):
            self.add_state(name, default=torch.zeros(num_groups, dtype=torch.int32), dist_reduce_fx="sum")

    def _prepare_inputs(self, preds, target, groups):
        if self.validate_args:
            _binary_stat_scores_arg_validation(self.threshold, "global", self.ignore_index)
            _binary_stat_scores_tensor_validation(preds, target, "global", self.ignore_index)
            _groups_validation(groups, self.num_groups)
        return (preds, target, groups), {}

    def _batch_state(self, preds, target, groups):
        tp, fp, tn, fn = _binary_groups_stat_scores(preds, target, groups, self.num_groups, self.threshold,
                                                    self.ignore_index, validate_args=False)
        return {"tp": tp, "fp": fp, "tn": tn, "fn": fn}


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """Each group's tp, fp, tn and fn rates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryGroupStatRates
        >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric = BinaryGroupStatRates(num_groups=2, device="cpu")
        >>> metric.update(preds, target, groups)
        >>> metric.compute()
        {'group_0': tensor([0.3333, 0.0000, 0.6667, 0.0000]), 'group_1': tensor([0.6667, 0.0000, 0.3333, 0.0000])}
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    _jittable_compute = False

    def _compute(self, state) -> Dict[str, torch.Tensor]:
        return _groups_rates(state["tp"], state["fp"], state["tn"], state["fn"])


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity and/or equal opportunity: the lowest group's rate over the
    highest's.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryFairness
        >>> preds = torch.tensor([0.11, 0.84, 0.22, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> groups = torch.tensor([0, 0, 0, 1, 1, 1])
        >>> metric = BinaryFairness(num_groups=2, device="cpu")
        >>> metric.update(preds, target, groups)
        >>> metric.compute()
        {'DP_0_1': tensor(0.5000), 'EO_0_0': tensor(1.)}
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    _jittable_compute = False

    def __init__(
        self,
        num_groups: int,
        task: str = "all",
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        if task not in ["demographic_parity", "equal_opportunity", "all"]:
            raise ValueError(
                f"Expected argument `task` to either be ``demographic_parity``,"
                f"``equal_opportunity`` or ``all`` but got {task}."
            )
        super().__init__(num_groups, threshold, ignore_index, validate_args, **kwargs)
        self.task = task

    def _prepare_inputs(self, preds, target=None, groups=None):
        if self.task == "demographic_parity":
            if target is not None:
                rank_zero_warn("The task demographic_parity does not require a target.", UserWarning)
            target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
        return super()._prepare_inputs(preds, target, groups)

    def _compute(self, state) -> Dict[str, torch.Tensor]:
        counts = state["tp"], state["fp"], state["tn"], state["fn"]
        if self.task == "demographic_parity":
            return _compute_binary_demographic_parity(*counts)
        if self.task == "equal_opportunity":
            return _compute_binary_equal_opportunity(*counts)
        return {**_compute_binary_demographic_parity(*counts), **_compute_binary_equal_opportunity(*counts)}
