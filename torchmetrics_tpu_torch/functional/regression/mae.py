"""Mean absolute error (counterpart of ``torchmetrics_tpu/functional/regression/mae.py``)."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum
from .utils import _check_data_shape_to_num_outputs


def _mean_absolute_error_update(preds: torch.Tensor, target: torch.Tensor, num_outputs: int = 1):
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    _check_data_shape_to_num_outputs(preds, target, num_outputs, allow_1d_reshape=True)
    return _float32_sum((preds.to(torch.float32) - target.to(torch.float32)).abs(), 0), target.shape[0]


def _mean_absolute_error_compute(sum_abs_error: torch.Tensor, num_obs) -> torch.Tensor:
    return sum_abs_error / num_obs


def mean_absolute_error(preds, target, num_outputs: int = 1) -> torch.Tensor:
    """Mean absolute error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_absolute_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> mean_absolute_error(preds, target)
        tensor(0.5000)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    sum_abs_error, num_obs = _mean_absolute_error_update(preds, target, num_outputs)
    return _mean_absolute_error_compute(sum_abs_error, num_obs)
