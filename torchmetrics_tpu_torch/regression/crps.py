"""CRPS and critical success index metric classes (counterpart of
``torchmetrics_tpu/regression/crps.py``).

CRPS keeps three float32 sums: ``mean(diff - spread)`` over all rows is
``(sum diff - sum spread) / N``. CSI keeps float32 counts, summed, or per sequence
position in concat states with ``keep_sequence_dim``."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.regression.crps import _crps_update
from ..functional.regression.csi import _critical_success_index_compute, _critical_success_index_update
from ..metric import Metric
from ..utilities.compute import _float32_sum
from .mse import _count, _zeros


class ContinuousRankedProbabilityScore(Metric):
    """Continuous ranked probability score of ensemble forecasts.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import ContinuousRankedProbabilityScore
        >>> preds = torch.tensor([[1.0, 2.0, 3.0], [2.0, 3.0, 4.0]])
        >>> target = torch.tensor([2.0, 3.0])
        >>> metric = ContinuousRankedProbabilityScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.2222)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        for name in ("diff_sum", "ensemble_sum", "total"):
            self.add_state(name, default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        batch_size, diff, ensemble_sum = _crps_update(preds, target)
        return {"diff_sum": _float32_sum(diff), "ensemble_sum": _float32_sum(ensemble_sum),
                "total": _count(batch_size, diff)}

    def _compute(self, state):
        return (state["diff_sum"] - state["ensemble_sum"]) / state["total"]


class CriticalSuccessIndex(Metric):
    """Critical success index at ``threshold``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import CriticalSuccessIndex
        >>> preds = torch.tensor([0.2, 0.7, 0.9, 0.4])
        >>> target = torch.tensor([0.1, 0.8, 0.6, 0.7])
        >>> metric = CriticalSuccessIndex(0.5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, threshold: float, keep_sequence_dim: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.threshold = float(threshold)
        if keep_sequence_dim is not None and (not isinstance(keep_sequence_dim, int) or keep_sequence_dim < 0):
            raise ValueError(f"Expected keep_sequence_dim to be int or None but got {keep_sequence_dim}")
        self.keep_sequence_dim = keep_sequence_dim
        for name in ("hits", "misses", "false_alarms"):
            if keep_sequence_dim is None:
                self.add_state(name, default=_zeros(), dist_reduce_fx="sum")
            else:
                self.add_state(name, default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        counts = _critical_success_index_update(preds, target, self.threshold, self.keep_sequence_dim)
        return {name: c.to(torch.float32) for name, c in zip(("hits", "misses", "false_alarms"), counts)}

    def _compute(self, state):
        return _critical_success_index_compute(state["hits"], state["misses"], state["false_alarms"])
