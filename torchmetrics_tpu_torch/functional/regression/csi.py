"""Critical success index (counterpart of ``torchmetrics_tpu/functional/regression/csi.py``).

Hits, misses and false alarms are int32 counts over every axis but ``keep_sequence_dim``
(counted in int64 and narrowed, exact on the card and on the CPU)."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _safe_divide


def _critical_success_index_update(preds: torch.Tensor, target: torch.Tensor, threshold: float,
                                   keep_sequence_dim: Optional[int] = None):
    _check_same_shape(preds, target)
    if keep_sequence_dim is None:
        axis = tuple(range(preds.ndim))
    elif not 0 <= keep_sequence_dim < preds.ndim:
        raise ValueError(f"Expected keep_sequence_dim to be in range [0, {preds.ndim}) but got {keep_sequence_dim}")
    else:
        axis = tuple(i for i in range(preds.ndim) if i != keep_sequence_dim)
    preds_bin = preds >= threshold
    target_bin = target >= threshold

    def count(mask: torch.Tensor) -> torch.Tensor:
        return mask.sum(axis, dtype=torch.int64).to(torch.int32) if axis else mask.to(torch.int32)

    return count(preds_bin & target_bin), count(~preds_bin & target_bin), count(preds_bin & ~target_bin)


def _critical_success_index_compute(hits: torch.Tensor, misses: torch.Tensor, false_alarms: torch.Tensor) -> torch.Tensor:
    return _safe_divide(hits, hits + misses + false_alarms)


def critical_success_index(preds, target, threshold: float, keep_sequence_dim: Optional[int] = None) -> torch.Tensor:
    """Critical success index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import critical_success_index
        >>> preds = torch.tensor([0.2, 0.7, 0.9, 0.4])
        >>> target = torch.tensor([0.1, 0.8, 0.6, 0.7])
        >>> critical_success_index(preds, target, 0.5)
        tensor(0.6667)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    hits, misses, false_alarms = _critical_success_index_update(preds, target, threshold, keep_sequence_dim)
    return _critical_success_index_compute(hits, misses, false_alarms)
