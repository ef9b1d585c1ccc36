"""MSE, MAE, MSLE, MAPE, SMAPE, WMAPE, log-cosh, Minkowski and Tweedie metric classes
(counterpart of ``torchmetrics_tpu/regression/mse.py``): sum-state accumulators.

Every state is float32, as in the JAX package; a batch's float sums are float64 sums
rounded once, so the card's states equal the CPU's bit for bit wherever the summed
terms do (not where a transcendental function forms them: log, pow)."""

from __future__ import annotations

from typing import Any

import torch

from ..functional.regression.log_mse import (
    _log_cosh_error_compute,
    _log_cosh_error_update,
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
)
from ..functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from ..functional.regression.mape import (
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
    _symmetric_mean_absolute_percentage_error_compute,
    _symmetric_mean_absolute_percentage_error_update,
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)
from ..functional.regression.minkowski import _minkowski_distance_compute, _minkowski_distance_update
from ..functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from ..functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from ..metric import Metric
from ..utilities.exceptions import TorchMetricsUserError


def _zeros(*shape: int) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32)


def _count(n: int, like: torch.Tensor) -> torch.Tensor:
    """A batch's count as a float32 state on the batch's device."""
    return torch.tensor(float(n), dtype=torch.float32, device=like.device)


def _check_num_outputs(num_outputs: Any) -> None:
    if not (isinstance(num_outputs, int) and num_outputs > 0):
        raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")


class MeanSquaredError(Metric):
    """MSE (or RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = MeanSquaredError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.3750)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        _check_num_outputs(num_outputs)
        self.num_outputs = num_outputs
        self.add_state("sum_squared_error", default=_zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        sse, n = _mean_squared_error_update(preds, target, self.num_outputs)
        return {"sum_squared_error": sse, "total": _count(n, sse)}

    def _compute(self, state):
        return _mean_squared_error_compute(state["sum_squared_error"], state["total"], self.squared).squeeze()


class MeanAbsoluteError(Metric):
    """Mean absolute error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanAbsoluteError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = MeanAbsoluteError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.5000)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_num_outputs(num_outputs)
        self.num_outputs = num_outputs
        self.add_state("sum_abs_error", default=_zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        sae, n = _mean_absolute_error_update(preds, target, self.num_outputs)
        return {"sum_abs_error": sae, "total": _count(n, sae)}

    def _compute(self, state):
        return _mean_absolute_error_compute(state["sum_abs_error"], state["total"]).squeeze()


class MeanSquaredLogError(Metric):
    """Mean squared log error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredLogError
        >>> preds = torch.tensor([2.5, 1.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, 1.5, 2.0, 7.0])
        >>> metric = MeanSquaredLogError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.0204)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", default=_zeros(), dist_reduce_fx="sum")
        self.add_state("total", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        s, n = _mean_squared_log_error_update(preds, target)
        return {"sum_squared_log_error": s, "total": _count(n, s)}

    def _compute(self, state):
        return _mean_squared_log_error_compute(state["sum_squared_log_error"], state["total"])


class MeanAbsolutePercentageError(Metric):
    """Mean absolute percentage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanAbsolutePercentageError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = MeanAbsolutePercentageError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.3274)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=_zeros(), dist_reduce_fx="sum")
        self.add_state("total", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        s, n = _mean_absolute_percentage_error_update(preds, target)
        return {"sum_abs_per_error": s, "total": _count(n, s)}

    def _compute(self, state):
        return _mean_absolute_percentage_error_compute(state["sum_abs_per_error"], state["total"])


class SymmetricMeanAbsolutePercentageError(Metric):
    """Symmetric mean absolute percentage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import SymmetricMeanAbsolutePercentageError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.5788)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=_zeros(), dist_reduce_fx="sum")
        self.add_state("total", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        s, n = _symmetric_mean_absolute_percentage_error_update(preds, target)
        return {"sum_abs_per_error": s, "total": _count(n, s)}

    def _compute(self, state):
        return _symmetric_mean_absolute_percentage_error_compute(state["sum_abs_per_error"], state["total"])


class WeightedMeanAbsolutePercentageError(Metric):
    """Weighted mean absolute percentage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import WeightedMeanAbsolutePercentageError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.1600)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=_zeros(), dist_reduce_fx="sum")
        self.add_state("sum_scale", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        sae, scale = _weighted_mean_absolute_percentage_error_update(preds, target)
        return {"sum_abs_error": sae, "sum_scale": scale}

    def _compute(self, state):
        return _weighted_mean_absolute_percentage_error_compute(state["sum_abs_error"], state["sum_scale"])


class LogCoshError(Metric):
    """Log-cosh error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import LogCoshError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = LogCoshError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.1685)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_num_outputs(num_outputs)
        self.num_outputs = num_outputs
        self.add_state("sum_log_cosh_error", default=_zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        s, n = _log_cosh_error_update(preds, target, self.num_outputs)
        return {"sum_log_cosh_error": s, "total": _count(n, s)}

    def _compute(self, state):
        return _log_cosh_error_compute(state["sum_log_cosh_error"], state["total"])


class MinkowskiDistance(Metric):
    """Minkowski distance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MinkowskiDistance
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = MinkowskiDistance(p=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.0772)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(p, (float, int)) and p >= 1):
            raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")
        self.p = p
        self.add_state("minkowski_dist_sum", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, targets):
        return {"minkowski_dist_sum": _minkowski_distance_update(preds, targets, self.p)}

    def _compute(self, state):
        return _minkowski_distance_compute(state["minkowski_dist_sum"], self.p)


class TweedieDevianceScore(Metric):
    """Tweedie deviance score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import TweedieDevianceScore
        >>> preds = torch.tensor([2.5, 0.5, 2.0, 8.0])
        >>> target = torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> metric = TweedieDevianceScore(power=1.5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.0262)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", default=_zeros(), dist_reduce_fx="sum")
        self.add_state("num_observations", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, targets):
        s, n = _tweedie_deviance_score_update(preds, targets, self.power)
        return {"sum_deviance_score": s, "num_observations": n}

    def _compute(self, state):
        return _tweedie_deviance_score_compute(state["sum_deviance_score"], state["num_observations"])
