"""Mean squared log error and log-cosh error (counterpart of
``torchmetrics_tpu/functional/regression/log_mse.py``).

``log(cosh(x))`` is computed as ``x + softplus(-2x) - log(2)`` with the softplus of
``jax.nn.softplus``, which has no threshold: ``logaddexp(-2x, 0)``. ``F.softplus`` would
switch to the identity above 20."""

from __future__ import annotations

import math

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum
from .utils import _check_data_shape_to_num_outputs


def _mean_squared_log_error_update(preds: torch.Tensor, target: torch.Tensor):
    _check_same_shape(preds, target)
    d = torch.log1p(preds.to(torch.float32)) - torch.log1p(target.to(torch.float32))
    return _float32_sum(d * d), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: torch.Tensor, num_obs) -> torch.Tensor:
    return sum_squared_log_error / num_obs


def mean_squared_log_error(preds, target) -> torch.Tensor:
    """Mean squared log error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_squared_log_error
        >>> preds = torch.tensor([2.5, 1.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, 1.5, 2.0, 7.0])
        >>> mean_squared_log_error(preds, target)
        tensor(0.0204)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    s, n = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(s, n)


def _unsqueeze_tensors(preds: torch.Tensor, target: torch.Tensor):
    if preds.ndim == 2:
        return preds, target
    return preds[:, None], target[:, None]


def _log_cosh_error_update(preds: torch.Tensor, target: torch.Tensor, num_outputs: int):
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    preds, target = _unsqueeze_tensors(preds.to(torch.float32), target.to(torch.float32))
    diff = preds - target
    log_cosh = diff + torch.logaddexp(-2.0 * diff, torch.zeros_like(diff)) - math.log(2.0)
    return _float32_sum(log_cosh, 0).squeeze(), target.shape[0]


def _log_cosh_error_compute(sum_log_cosh_error: torch.Tensor, num_obs) -> torch.Tensor:
    return (sum_log_cosh_error / num_obs).squeeze()


def log_cosh_error(preds, target) -> torch.Tensor:
    """Log cosh error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import log_cosh_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> log_cosh_error(preds, target)
        tensor(0.1685)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[1]
    s, n = _log_cosh_error_update(preds, target, num_outputs)
    return _log_cosh_error_compute(s, n)
