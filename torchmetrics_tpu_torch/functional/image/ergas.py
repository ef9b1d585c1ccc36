"""ERGAS (counterpart of ``torchmetrics_tpu/functional/image/ergas.py``): per-band
RMSE over the band means; the band sums accumulate in float64 and round once."""

from __future__ import annotations

from typing import Optional

import torch

from .utils import _check_image_pair, _mean64, _sum64, reduce


def _ergas_update(preds, target):
    return _check_image_pair(preds, target)


def _ergas_compute(preds: torch.Tensor, target: torch.Tensor, ratio: float = 4,
                   reduction: Optional[str] = "elementwise_mean") -> torch.Tensor:
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)
    diff = preds - target
    sum_squared_error = _sum64(diff * diff, 2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = _mean64(target, 2)
    ergas_score = 100 / ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds, target, ratio: float = 4, reduction: Optional[str] = "elementwise_mean"
) -> torch.Tensor:
    """ERGAS: band-wise relative RMSE aggregated over channels.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import error_relative_global_dimensionless_synthesis
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> error_relative_global_dimensionless_synthesis(preds, target)
        tensor(20.9003)
    """
    preds, target = _ergas_update(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)
