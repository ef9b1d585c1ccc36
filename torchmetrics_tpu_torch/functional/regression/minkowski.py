"""Minkowski distance (counterpart of ``torchmetrics_tpu/functional/regression/minkowski.py``)."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum
from ...utilities.exceptions import TorchMetricsUserError


def _minkowski_distance_update(preds: torch.Tensor, targets: torch.Tensor, p: float) -> torch.Tensor:
    _check_same_shape(preds, targets)
    if not (isinstance(p, (float, int)) and p >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")
    return _float32_sum(torch.pow((preds.to(torch.float32) - targets.to(torch.float32)).abs(), p))


def _minkowski_distance_compute(distance: torch.Tensor, p: float) -> torch.Tensor:
    return torch.pow(distance, 1.0 / p)


def minkowski_distance(preds, targets, p: float) -> torch.Tensor:
    """Minkowski distance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import minkowski_distance
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> minkowski_distance(preds, target, p=3)
        tensor(1.0772)
    """
    preds, targets = _as_tensor(preds), _as_tensor(targets)
    distance = _minkowski_distance_update(preds, targets, p)
    return _minkowski_distance_compute(distance, p)
