"""R2, relative squared error and explained variance metric classes (counterpart of
``torchmetrics_tpu/regression/r2.py``). Float32 sum states; ``ExplainedVariance``
registers scalar defaults, as the JAX package does, and its states take the shape of the
per-output sums at the first update."""

from __future__ import annotations

from typing import Any

from ..functional.regression.explained_variance import (
    ALLOWED_MULTIOUTPUT,
    _explained_variance_compute,
    _explained_variance_update,
)
from ..functional.regression.r2 import _r2_score_compute, _r2_score_update, _relative_squared_error_compute
from ..metric import Metric
from .mse import _count, _zeros


class R2Score(Metric):
    """R2 score, with every ``multioutput`` mode and ``adjusted``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import R2Score
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = R2Score(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.9486)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_outputs: int = 1, adjusted: int = 0, multioutput: str = "uniform_average",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        if multioutput not in ALLOWED_MULTIOUTPUT:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}"
            )
        self.multioutput = multioutput
        self.add_state("sum_squared_error", default=_zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_error", default=_zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("residual", default=_zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
        return {"sum_squared_error": sum_squared_obs, "sum_error": sum_obs, "residual": rss,
                "total": _count(num_obs, rss)}

    def _compute(self, state):
        return _r2_score_compute(state["sum_squared_error"], state["sum_error"], state["residual"], state["total"],
                                 self.adjusted, self.multioutput)


class RelativeSquaredError(Metric):
    """Relative squared error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import RelativeSquaredError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = RelativeSquaredError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.0514)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_outputs: int = 1, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.squared = squared
        self.add_state("sum_squared_obs", default=_zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_obs", default=_zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_squared_error", default=_zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
        return {"sum_squared_obs": sum_squared_obs, "sum_obs": sum_obs, "sum_squared_error": rss,
                "total": _count(num_obs, rss)}

    def _compute(self, state):
        return _relative_squared_error_compute(state["sum_squared_obs"], state["sum_obs"], state["sum_squared_error"],
                                               state["total"], self.squared)


class ExplainedVariance(Metric):
    """Explained variance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import ExplainedVariance
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = ExplainedVariance(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.9572)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_upper_bound = 1.0

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if multioutput not in ALLOWED_MULTIOUTPUT:
            raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}")
        self.multioutput = multioutput
        for name in ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target", "num_obs"):
            self.add_state(name, default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        num_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
        return {"num_obs": _count(num_obs, sum_error), "sum_error": sum_error, "sum_squared_error": sum_squared_error,
                "sum_target": sum_target, "sum_squared_target": sum_squared_target}

    def _compute(self, state):
        return _explained_variance_compute(state["num_obs"], state["sum_error"], state["sum_squared_error"],
                                           state["sum_target"], state["sum_squared_target"], self.multioutput)
