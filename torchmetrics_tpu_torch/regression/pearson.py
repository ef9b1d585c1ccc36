"""Pearson and concordance correlation metric classes by running moments (counterpart of
``torchmetrics_tpu/regression/pearson.py``).

``_merge`` is the exact Chan combination, so one fold serves the batches,
``merge_state`` and the processes. The states register ``dist_reduce_fx=None``: a sync
over more than one process stacks one row of moments per rank, and ``_compute`` folds
that leading axis with ``_final_aggregation``, in rank order. ``reduce_state``
all-gathers the moments over a process group and folds them the same way (a sum would
be wrong for means and variances)."""

from __future__ import annotations

from typing import Any

import torch

from ..functional.regression.concordance import _concordance_corrcoef_compute
from ..functional.regression.pearson import (
    _batch_moments,
    _final_aggregation,
    _merge_moments,
    _pearson_corrcoef_compute,
)
from ..functional.regression.utils import _check_data_shape_to_num_outputs
from ..metric import Metric
from ..parallel import coalesce as _coalesce
from ..utilities.checks import _check_same_shape
from .mse import _zeros

_MOMENT_KEYS = ("mean_x", "mean_y", "max_abs_dev_x", "max_abs_dev_y", "var_x", "var_y", "corr_xy", "n_total")


def _gather_stacks(state: dict, keys, group: Any) -> dict:
    """Each key's value from every process of ``group``, stacked in rank order."""
    return {k: torch.stack(_coalesce.process_rows(state[k], group)) for k in keys}


class _MomentCorrelationBase(Metric):
    """Running-moment machinery shared by the Pearson-style correlations."""

    is_differentiable = True
    full_state_update = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError("Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        for key in _MOMENT_KEYS:
            self.add_state(key, default=_zeros(num_outputs), dist_reduce_fx=None)

    def _batch_state(self, preds, target):
        _check_same_shape(preds, target)
        _check_data_shape_to_num_outputs(preds, target, self.num_outputs)
        preds = preds.to(torch.float32).reshape(-1, self.num_outputs)
        target = target.to(torch.float32).reshape(-1, self.num_outputs)
        out = dict(zip(_MOMENT_KEYS, _batch_moments(preds, target)))
        out["n_total"] = out["n_total"].expand(self.num_outputs).clone()
        return out

    def _merge(self, a, b):
        merged = _merge_moments(tuple(a[k] for k in _MOMENT_KEYS), tuple(b[k] for k in _MOMENT_KEYS))
        return {**a, **dict(zip(_MOMENT_KEYS, merged))}

    def reduce_state(self, state, group: Any = None):
        """The moments of every process of ``group`` (the default group if None),
        gathered and folded by the exact parallel combination."""
        stacks = _gather_stacks(state, _MOMENT_KEYS, group)
        return dict(zip(_MOMENT_KEYS, _final_aggregation(*(stacks[k] for k in _MOMENT_KEYS))))

    def _final_moments(self, state):
        """The moments for compute: a stack of per-process moments is folded first."""
        if state["mean_x"].ndim > 1:
            return dict(zip(_MOMENT_KEYS, _final_aggregation(*(state[k] for k in _MOMENT_KEYS))))
        return state


class PearsonCorrCoef(_MomentCorrelationBase):
    """Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import PearsonCorrCoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = PearsonCorrCoef(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.9849)
    """

    higher_is_better = None

    def _compute(self, state):
        s = self._final_moments(state)
        return _pearson_corrcoef_compute(s["max_abs_dev_x"], s["max_abs_dev_y"], s["var_x"], s["var_y"], s["corr_xy"],
                                         s["n_total"])


class ConcordanceCorrCoef(_MomentCorrelationBase):
    """Concordance correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import ConcordanceCorrCoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = ConcordanceCorrCoef(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.9777)
    """

    higher_is_better = None

    def _compute(self, state):
        s = self._final_moments(state)
        return _concordance_corrcoef_compute(s["max_abs_dev_x"], s["max_abs_dev_y"], s["mean_x"], s["mean_y"],
                                             s["var_x"], s["var_y"], s["corr_xy"], s["n_total"]).squeeze()
