"""Concordance correlation coefficient (counterpart of
``torchmetrics_tpu/functional/regression/concordance.py``), from Pearson's moments."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor
from .pearson import _pearson_corrcoef_compute, _pearson_corrcoef_update, _zero_moments


def _concordance_corrcoef_compute(
    max_abs_dev_x: torch.Tensor,
    max_abs_dev_y: torch.Tensor,
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    num_total: torch.Tensor,
) -> torch.Tensor:
    pearson = _pearson_corrcoef_compute(max_abs_dev_x, max_abs_dev_y, var_x, var_y, corr_xy, num_total)
    var_x = var_x / (num_total - 1)
    var_y = var_y / (num_total - 1)
    return 2.0 * pearson * torch.sqrt(var_x) * torch.sqrt(var_y) / (var_x + var_y + (mean_x - mean_y) ** 2)


def concordance_corrcoef(preds, target) -> torch.Tensor:
    """One-shot concordance correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import concordance_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> concordance_corrcoef(preds, target)
        tensor(0.9777)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[-1]
    mean_x, mean_y, dev_x, dev_y, var_x, var_y, corr_xy, n = _pearson_corrcoef_update(
        preds, target, *_zero_moments(preds), num_outputs)
    return _concordance_corrcoef_compute(dev_x, dev_y, mean_x, mean_y, var_x, var_y, corr_xy, n)
