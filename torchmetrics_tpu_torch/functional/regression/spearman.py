"""Spearman rank correlation (counterpart of
``torchmetrics_tpu/functional/regression/spearman.py``).

The ranks are exact run means (``utils._rank_data``); all columns of a multi-output
input are ranked by one batched sort."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from .utils import _check_data_shape_to_num_outputs, _mean32, _rank_data


def _spearman_corrcoef_update(preds: torch.Tensor, target: torch.Tensor, num_outputs: int):
    if not (preds.is_floating_point() and target.is_floating_point()):
        raise TypeError(
            "Expected `preds` and `target` both to be floating point tensors, but got {preds.dtype} and {target.dtype}"
        )
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    return preds.to(torch.float32), target.to(torch.float32)


def _rank_columns(x: torch.Tensor) -> torch.Tensor:
    """Ranks of a vector, or of each column of a matrix."""
    return _rank_data(x) if x.ndim == 1 else _rank_data(x.T).T


def _spearman_corrcoef_compute(preds: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    preds, target = _rank_columns(preds), _rank_columns(target)
    preds_diff = preds - _mean32(preds)
    target_diff = target - _mean32(target)
    cov = _mean32(preds_diff * target_diff)
    preds_std = torch.sqrt(_mean32(preds_diff * preds_diff))
    target_std = torch.sqrt(_mean32(target_diff * target_diff))
    return (cov / (preds_std * target_std + eps)).clamp(-1.0, 1.0)


def spearman_corrcoef(preds, target) -> torch.Tensor:
    """Spearman rank correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spearman_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> spearman_corrcoef(preds, target)
        tensor(1.0000)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[-1]
    preds, target = _spearman_corrcoef_update(preds, target, num_outputs)
    return _spearman_corrcoef_compute(preds, target)
