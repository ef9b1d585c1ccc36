"""Normalized root mean squared error (counterpart of
``torchmetrics_tpu/functional/regression/nrmse.py``).

``normalization="std"`` is the population standard deviation, as ``jnp.std`` takes it:
``torch.std(correction=0)``, where ``torch.std``'s default would divide by ``n - 1``.
The mean and the L2 norm are float64 sums rounded once to float32."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _float32_sum
from .mse import _mean_squared_error_update
from .utils import _mean32

_ALLOWED_NORM = ("mean", "range", "std", "l2")


def _normalized_root_mean_squared_error_update(preds: torch.Tensor, target: torch.Tensor, num_outputs: int,
                                               normalization: str = "mean"):
    sum_squared_error, num_obs = _mean_squared_error_update(preds, target, num_outputs)
    target = target.to(torch.float32)
    target = target.reshape(-1) if num_outputs == 1 else target
    if normalization == "mean":
        denom = _mean32(target)
    elif normalization == "range":
        denom = target.amax(0) - target.amin(0)
    elif normalization == "std":
        denom = torch.std(target, dim=0, correction=0)
    elif normalization == "l2":
        denom = torch.sqrt(_float32_sum(target * target, 0))
    else:
        raise ValueError(f"Argument `normalization` should be either 'mean', 'range', 'std' or 'l2', but got {normalization}")
    return sum_squared_error, num_obs, denom


def _normalized_root_mean_squared_error_compute(sum_squared_error: torch.Tensor, num_obs,
                                                denom: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sum_squared_error / num_obs) / denom


def normalized_root_mean_squared_error(preds, target, normalization: str = "mean",
                                       num_outputs: int = 1) -> torch.Tensor:
    """Normalized root mean squared error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import normalized_root_mean_squared_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> normalized_root_mean_squared_error(preds, target)
        tensor(0.2130)
    """
    if normalization not in _ALLOWED_NORM:
        raise ValueError(f"Argument `normalization` should be either 'mean', 'range', 'std' or 'l2', but got {normalization}")
    preds, target = _as_tensor(preds), _as_tensor(target)
    sum_squared_error, num_obs, denom = _normalized_root_mean_squared_error_update(
        preds, target, num_outputs, normalization)
    return _normalized_root_mean_squared_error_compute(sum_squared_error, num_obs, denom)
