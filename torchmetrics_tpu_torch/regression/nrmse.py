"""Normalized RMSE metric class (counterpart of ``torchmetrics_tpu/regression/nrmse.py``).

The running target statistics (count, min, max, mean, centred sum of squares, sum of
squares) merge by exact parallel formulas in ``_merge``, as Pearson's moments do, and
register ``dist_reduce_fx=None``: a sync over several processes stacks one row per rank
and ``_compute`` folds the stack in rank order; ``reduce_state`` gathers and folds."""

from __future__ import annotations

import math
from typing import Any

import torch

from ..functional.regression.mse import _mean_squared_error_update
from ..functional.regression.nrmse import _ALLOWED_NORM, _normalized_root_mean_squared_error_compute
from ..functional.regression.utils import _mean32
from ..metric import Metric
from ..utilities.compute import _float32_sum
from .mse import _check_num_outputs, _zeros
from .pearson import _gather_stacks

_KEYS = ("sum_squared_error", "total", "min_val", "max_val", "mean_val", "var_val", "target_squared")


class NormalizedRootMeanSquaredError(Metric):
    """Normalized root mean squared error (``normalization`` mean, range, std or l2).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import NormalizedRootMeanSquaredError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = NormalizedRootMeanSquaredError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.2130)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = True
    plot_lower_bound = 0.0

    def __init__(self, normalization: str = "mean", num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if normalization not in _ALLOWED_NORM:
            raise ValueError(
                f"Argument `normalization` should be either 'mean', 'range', 'std' or 'l2', but got {normalization}"
            )
        self.normalization = normalization
        _check_num_outputs(num_outputs)
        self.num_outputs = num_outputs
        d = num_outputs
        for key in _KEYS:
            default = {"min_val": math.inf, "max_val": -math.inf}.get(key, 0.0)
            self.add_state(key, default=_zeros(d) + default, dist_reduce_fx=None)

    def _batch_state(self, preds, target):
        sum_squared_error, num_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        target = target.to(torch.float32)
        target = target.reshape(-1, 1) if self.num_outputs == 1 else target
        mean = _mean32(target)
        centered = target - mean
        return {
            "sum_squared_error": torch.atleast_1d(sum_squared_error),
            "total": torch.full((self.num_outputs,), float(num_obs), dtype=torch.float32, device=target.device),
            "min_val": target.amin(0),
            "max_val": target.amax(0),
            "mean_val": mean,
            "var_val": _float32_sum(centered * centered, 0),
            "target_squared": _float32_sum(target * target, 0),
        }

    def _merge(self, a, b):
        n_a, n_b = a["total"], b["total"]
        n = n_a + n_b
        safe_n = torch.where(n == 0, torch.ones_like(n), n)
        delta = b["mean_val"] - a["mean_val"]
        return {**a, "total": n, "mean_val": a["mean_val"] + delta * n_b / safe_n,
                "var_val": a["var_val"] + b["var_val"] + delta * delta * n_a * n_b / safe_n,
                "min_val": torch.minimum(a["min_val"], b["min_val"]),
                "max_val": torch.maximum(a["max_val"], b["max_val"]),
                "sum_squared_error": a["sum_squared_error"] + b["sum_squared_error"],
                "target_squared": a["target_squared"] + b["target_squared"]}

    def _fold_rows(self, stacks: dict) -> dict:
        acc = {k: stacks[k][0] for k in _KEYS}
        for i in range(1, stacks["mean_val"].shape[0]):
            acc = self._merge(acc, {k: stacks[k][i] for k in _KEYS})
        return acc

    def reduce_state(self, state, group: Any = None):
        """The statistics of every process of ``group`` (the default group if None),
        gathered and folded by the exact parallel formulas."""
        return self._fold_rows(_gather_stacks(state, _KEYS, group))

    def _compute(self, state):
        if state["mean_val"].ndim > 1:  # one row per process, stacked by a sync
            state = self._fold_rows(state)
        if self.normalization == "mean":
            denom = state["mean_val"]
        elif self.normalization == "range":
            denom = state["max_val"] - state["min_val"]
        elif self.normalization == "std":
            denom = torch.sqrt(state["var_val"] / state["total"])
        else:
            denom = torch.sqrt(state["target_squared"])
        return _normalized_root_mean_squared_error_compute(state["sum_squared_error"], state["total"], denom).squeeze()
