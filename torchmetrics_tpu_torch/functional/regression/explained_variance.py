"""Explained variance (counterpart of
``torchmetrics_tpu/functional/regression/explained_variance.py``).

The four sums are float64 sums rounded once to float32. The compute takes differences of
second moments, ``E[x^2] - E[x]^2``, as the JAX package does, so where the variance is
small against the mean it cancels: the value is then good to float32's epsilon times
``E[x^2] / var``, not to float32's epsilon."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum

ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _explained_variance_update(preds: torch.Tensor, target: torch.Tensor):
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    diff = target - preds
    return (preds.shape[0], _float32_sum(diff, 0), _float32_sum(diff * diff, 0), _float32_sum(target, 0),
            _float32_sum(target * target, 0))


def _explained_variance_compute(
    num_obs,
    sum_error: torch.Tensor,
    sum_squared_error: torch.Tensor,
    sum_target: torch.Tensor,
    sum_squared_target: torch.Tensor,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    diff_avg = sum_error / num_obs
    numerator = sum_squared_error / num_obs - diff_avg * diff_avg
    target_avg = sum_target / num_obs
    denominator = sum_squared_target / num_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    ratio = 1.0 - numerator / torch.where(nonzero_denominator, denominator, torch.ones_like(denominator))
    fallback = torch.where(nonzero_numerator, torch.zeros_like(ratio), torch.ones_like(ratio))
    output_scores = torch.where(valid_score, ratio, fallback)

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return output_scores.mean()
    if multioutput == "variance_weighted":
        return (denominator / denominator.sum() * output_scores).sum()
    raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, but got {multioutput}")


def explained_variance(preds, target, multioutput: str = "uniform_average") -> torch.Tensor:
    """Explained variance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import explained_variance
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> explained_variance(preds, target)
        tensor(0.9572)
    """
    if multioutput not in ALLOWED_MULTIOUTPUT:
        raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, but got {multioutput}")
    preds, target = _as_tensor(preds), _as_tensor(target)
    num_obs, sum_error, ss_error, sum_target, ss_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(num_obs, sum_error, ss_error, sum_target, ss_target, multioutput)
