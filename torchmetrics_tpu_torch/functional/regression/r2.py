"""R2 score and relative squared error (counterpart of
``torchmetrics_tpu/functional/regression/r2.py``).

The sums of the targets, of their squares and of the squared residuals are float64
sums rounded once to float32. ``adjusted`` reads the count on the host once."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum
from ...utilities.prints import rank_zero_warn


def _r2_score_update(preds: torch.Tensor, target: torch.Tensor):
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors, but received tensors with dimension "
            f"{tuple(preds.shape)}"
        )
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    sum_obs = _float32_sum(target, 0)
    sum_squared_obs = _float32_sum(target * target, 0)
    residual = target - preds
    rss = _float32_sum(residual * residual, 0)
    return sum_squared_obs, sum_obs, rss, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    num_obs,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    mean_obs = sum_obs / num_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    cond = tss != 0
    raw_scores = 1 - rss / torch.where(cond, tss, torch.ones_like(tss))
    raw_scores = torch.where(cond, raw_scores, torch.zeros_like(raw_scores))

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = raw_scores.mean()
    elif multioutput == "variance_weighted":
        r2 = (tss / tss.sum() * raw_scores).sum()
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`, `uniform_average` or `variance_weighted`. "
            f"Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0:
        n = int(num_obs.item()) if isinstance(num_obs, torch.Tensor) else int(num_obs)
        if n - adjusted - 1 <= 0:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        else:
            return 1 - (1 - r2) * (n - 1) / (n - adjusted - 1)
    return r2


def r2_score(preds, target, adjusted: int = 0, multioutput: str = "uniform_average") -> torch.Tensor:
    """R2 score (coefficient of determination).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import r2_score
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> r2_score(preds, target)
        tensor(0.9486)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
    if num_obs < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, num_obs, adjusted, multioutput)


def _relative_squared_error_compute(sum_squared_obs: torch.Tensor, sum_obs: torch.Tensor, rss: torch.Tensor, num_obs,
                                    squared: bool = True) -> torch.Tensor:
    epsilon = torch.finfo(torch.float32).eps
    tss = (sum_squared_obs - sum_obs * (sum_obs / num_obs)).sum()
    rse = rss.sum() / tss.clamp(min=epsilon)
    return rse if squared else torch.sqrt(rse)


def relative_squared_error(preds, target, squared: bool = True) -> torch.Tensor:
    """Relative squared error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import relative_squared_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> relative_squared_error(preds, target)
        tensor(0.0514)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
    return _relative_squared_error_compute(sum_squared_obs, sum_obs, rss, num_obs, squared)
