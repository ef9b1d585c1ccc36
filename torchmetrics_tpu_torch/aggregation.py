"""Stream aggregation metrics with a NaN policy (counterpart of
``torchmetrics_tpu/aggregation.py``).

``nan_strategy``: ``"error"`` raises and ``"warn"`` warns on a NaN and then drops it, as
``"ignore"`` does; a float imputes it; ``"disable"`` leaves it. Dropping maps a NaN to
the reduction's identity (-inf, +inf, 0) or to zero weight, so the shapes stay static;
``error`` and ``warn`` read the values on the host. ``RunningMean``/``RunningSum`` keep
a ring buffer of ``window`` batch values with a cyclic cursor.

Between them the aggregators carry every reduction tag: ``max``, ``min``, ``sum`` (the
weighted mean keeps its value and its weight as sums), ``cat`` (lengths may differ by
rank) and ``None`` (the ring states stay local).
"""

from __future__ import annotations

from typing import Any, Callable, Union

import numpy as np
import torch

from .metric import Metric
from .utilities.compute import _safe_divide
from .utilities.data import dim_zero_cat
from .utilities.prints import rank_zero_warn


class BaseAggregator(Metric):
    """Base for aggregators: one state ``state_name`` reduced by ``fn``."""

    is_differentiable = None
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Any,
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore", "disable")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.state_name = state_name
        if state_name is not None:
            self.add_state(state_name, default=default_value, dist_reduce_fx=fn)

    def _as_float(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _host_nan_check(self, x: Any) -> None:
        if self.nan_strategy in ("error", "warn") and bool(torch.isnan(self._as_float(x)).any()):
            if self.nan_strategy == "error":
                raise RuntimeError("Encountered `nan` values in tensor")
            rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)

    def _nan_fill(self, x: Any, fill: float) -> torch.Tensor:
        """Replace NaNs by ``fill`` (the reduction's identity, or the imputed value)."""
        x = self._as_float(x)
        if self.nan_strategy == "disable":
            return x
        if isinstance(self.nan_strategy, float):
            fill = self.nan_strategy
        return torch.where(torch.isnan(x), torch.full_like(x, fill), x)

    def _compute(self, state):
        return state[self.state_name]


class MaxMetric(BaseAggregator):
    """Running max.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.aggregation import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(3.)
    """

    full_state_update = True
    higher_is_better = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", np.float32(-np.inf), nan_strategy, state_name="max_value", **kwargs)

    def _prepare_inputs(self, value):
        self._host_nan_check(value)
        return (value,), {}

    def _batch_state(self, value):
        return {"max_value": self._nan_fill(value, -float("inf")).max()}


class MinMetric(BaseAggregator):
    """Running min.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.aggregation import MinMetric
        >>> metric = MinMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(1.)
    """

    full_state_update = True
    higher_is_better = False

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", np.float32(np.inf), nan_strategy, state_name="min_value", **kwargs)

    def _prepare_inputs(self, value):
        self._host_nan_check(value)
        return (value,), {}

    def _batch_state(self, value):
        return {"min_value": self._nan_fill(value, float("inf")).min()}


class SumMetric(BaseAggregator):
    """Running sum.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(6.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", np.zeros((), np.float32), nan_strategy, state_name="sum_value", **kwargs)

    def _prepare_inputs(self, value):
        self._host_nan_check(value)
        return (value,), {}

    def _batch_state(self, value):
        return {"sum_value": self._nan_fill(value, 0.0).sum()}


class CatMetric(BaseAggregator):
    """Concatenate all seen values.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.aggregation import CatMetric
        >>> metric = CatMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor([1., 2., 3.])
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def _prepare_inputs(self, value):
        self._host_nan_check(value)
        v = self._as_float(value)
        if self.nan_strategy in ("ignore", "warn", "error"):
            v = v.reshape(-1)
            return (v[~torch.isnan(v)],), {}  # dynamic shape: cat states are lists anyway
        if isinstance(self.nan_strategy, float):
            return (torch.where(torch.isnan(v), torch.full_like(v, self.nan_strategy), v),), {}
        return (v,), {}

    def _batch_state(self, value):
        return {"value": torch.atleast_1d(value)}

    def _compute(self, state):
        v = state["value"]
        return v if not isinstance(v, list) else dim_zero_cat(v)


class MeanMetric(BaseAggregator):
    """Weighted running mean, kept as a value sum and a weight sum.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.aggregation import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(2.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", np.zeros((), np.float32), nan_strategy, state_name="mean_value", **kwargs)
        self.add_state("weight", default=np.zeros((), np.float32), dist_reduce_fx="sum")

    def _prepare_inputs(self, value, weight=1.0):
        self._host_nan_check(value)
        return (value, weight), {}

    def _batch_state(self, value, weight=1.0):
        value = self._as_float(value)
        weight = self._as_float(weight).broadcast_to(value.shape)
        nan = torch.isnan(value)
        if isinstance(self.nan_strategy, float):
            value = torch.where(nan, torch.full_like(value, self.nan_strategy), value)
        elif self.nan_strategy != "disable":  # error/warn were handled on the host; ignore: zero weight
            weight = torch.where(nan, torch.zeros_like(weight), weight)
            value = torch.where(nan, torch.zeros_like(value), value)
        return {"mean_value": (value * weight).sum(), "weight": weight.sum()}

    def _compute(self, state):
        return _safe_divide(state["mean_value"], state["weight"])


class _RunningBase(BaseAggregator):
    """Ring buffer of the last ``window`` batch values."""

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Argument `window` should be a positive integer but got {window}")
        super().__init__("sum", None, nan_strategy, state_name=None, **kwargs)
        self.window = window
        self.add_state("ring", default=np.zeros((window,), np.float32), dist_reduce_fx=None)
        self.add_state("ring_valid", default=np.zeros((window,), np.bool_), dist_reduce_fx=None)
        self.add_state("cursor", default=np.zeros((), np.int32), dist_reduce_fx=None)

    def _prepare_inputs(self, value):
        self._host_nan_check(value)
        return (value,), {}

    def _agg(self, value: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _batch_state(self, value):
        v = self._as_float(value)
        nan = torch.isnan(v)
        if isinstance(self.nan_strategy, float):
            v = torch.where(nan, torch.full_like(v, self.nan_strategy), v)
        elif self.nan_strategy != "disable":
            v = torch.where(nan, torch.zeros_like(v), v)
        return {"_batch_agg": self._agg(v)}

    def _merge(self, a, b):  # custom: a cyclic write into the ring
        if "_batch_agg" not in b:  # two ring states (the merge_state path)
            return {**a, **b}
        cursor = a["cursor"]
        pos = torch.remainder(cursor, self.window).long()
        ring = a["ring"].index_put((pos,), b["_batch_agg"])
        valid = a["ring_valid"].index_put((pos,), torch.ones((), dtype=torch.bool, device=pos.device))
        return {"ring": ring, "ring_valid": valid, "cursor": cursor + 1}

    def _compute(self, state):
        raise NotImplementedError


class RunningMean(_RunningBase):
    """Mean over the last ``window`` batch means.

    Example:
        >>> from torchmetrics_tpu_torch.aggregation import RunningMean
        >>> metric = RunningMean(window=3, device="cpu")
        >>> for batch in [1.0, 2.0, 3.0, 4.0, 5.0]:
        ...     metric.update(batch)
        >>> metric.compute()
        tensor(4.)
    """

    def _agg(self, value):
        return value.mean()

    def _compute(self, state):
        valid = state["ring_valid"].to(torch.float32)
        return _safe_divide((state["ring"] * valid).sum(), valid.sum())


class RunningSum(_RunningBase):
    """Sum over the last ``window`` batch sums.

    Example:
        >>> from torchmetrics_tpu_torch.aggregation import RunningSum
        >>> metric = RunningSum(window=3, device="cpu")
        >>> for batch in [1.0, 2.0, 3.0, 4.0, 5.0]:
        ...     metric.update(batch)
        >>> metric.compute()
        tensor(12.)
    """

    def _agg(self, value):
        return value.sum()

    def _compute(self, state):
        valid = state["ring_valid"].to(torch.float32)
        return (state["ring"] * valid).sum()


__all__ = ["BaseAggregator", "CatMetric", "MaxMetric", "MeanMetric", "MinMetric", "RunningMean", "RunningSum", "SumMetric"]
