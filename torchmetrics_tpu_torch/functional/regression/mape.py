"""The mean absolute percentage error family (counterpart of
``torchmetrics_tpu/functional/regression/mape.py``): MAPE, SMAPE and WMAPE.

A target of 0 is clipped to ``1.17e-06`` in MAPE's denominator, as in the JAX package,
so a zero target with a nonzero forecast weighs about a million."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum

_EPS = 1.17e-06


def _mean_absolute_percentage_error_update(preds: torch.Tensor, target: torch.Tensor, epsilon: float = _EPS):
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    abs_per_error = (preds - target).abs() / target.abs().clamp(min=epsilon)
    return _float32_sum(abs_per_error), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: torch.Tensor, num_obs) -> torch.Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds, target) -> torch.Tensor:
    """Mean absolute percentage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_absolute_percentage_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> mean_absolute_percentage_error(preds, target)
        tensor(0.3274)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    s, n = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(s, n)


def _symmetric_mean_absolute_percentage_error_update(preds: torch.Tensor, target: torch.Tensor,
                                                     epsilon: float = _EPS):
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    abs_per_error = 2 * (preds - target).abs() / (target.abs() + preds.abs()).clamp(min=epsilon)
    return _float32_sum(abs_per_error), target.numel()


def _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error: torch.Tensor, num_obs) -> torch.Tensor:
    return sum_abs_per_error / num_obs


def symmetric_mean_absolute_percentage_error(preds, target) -> torch.Tensor:
    """Symmetric mean absolute percentage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import symmetric_mean_absolute_percentage_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> symmetric_mean_absolute_percentage_error(preds, target)
        tensor(0.5788)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    s, n = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return _symmetric_mean_absolute_percentage_error_compute(s, n)


def _weighted_mean_absolute_percentage_error_update(preds: torch.Tensor, target: torch.Tensor):
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32).reshape(-1)
    target = target.to(torch.float32).reshape(-1)
    return _float32_sum((preds - target).abs()), _float32_sum(target.abs())


def _weighted_mean_absolute_percentage_error_compute(sum_abs_error: torch.Tensor, sum_scale: torch.Tensor,
                                                     epsilon: float = _EPS) -> torch.Tensor:
    return sum_abs_error / sum_scale.clamp(min=epsilon)


def weighted_mean_absolute_percentage_error(preds, target) -> torch.Tensor:
    """Weighted mean absolute percentage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import weighted_mean_absolute_percentage_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> weighted_mean_absolute_percentage_error(preds, target)
        tensor(0.1600)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
