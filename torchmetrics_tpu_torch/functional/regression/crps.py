"""Continuous ranked probability score of an ensemble forecast (counterpart of
``torchmetrics_tpu/functional/regression/crps.py``).

Per row: the mean absolute error of the members against the target, and the pairwise
spread ``sum |x_i - x_j| / (2 m^2)``, taken pairwise as the JAX package takes it. Its
``(B, m, m)`` temporary would hold 10.4 GB in float32 at a 0.25-degree global grid of
1,038,240 points and 50 members, so the rows go through in chunks whose temporary stays
under ``_CHUNK_BYTES``. The differences are taken in float64, where the difference of
two float32 values is exact, and each row's sums are float64, divided in float64 and
rounded once: the card and the CPU give the same bits. The JAX package rounds each
difference to float32 and sums in float32, so it agrees within that rounding."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor

_CHUNK_BYTES = 1 << 28  # one chunk's float64 (rows, m, m) temporary: 256 MiB


def _crps_rows(m: int) -> int:
    """Rows per chunk, so that one chunk's ``(rows, m, m)`` float64 temporary fits
    ``_CHUNK_BYTES``."""
    return max(1, _CHUNK_BYTES // (8 * m * m))


def _crps_update(preds: torch.Tensor, target: torch.Tensor, chunk_rows: Optional[int] = None):
    """(batch size, float32 per-row mean absolute error, float32 per-row spread)."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    if preds.ndim != 2:
        raise ValueError(f"Expected preds of shape (batch_size, ensemble_members), but got {tuple(preds.shape)}.")
    if tuple(target.shape) != tuple(preds.shape[:1]):
        raise ValueError(f"Expected target of shape (batch_size,), but got {tuple(target.shape)}.")
    batch_size, m = preds.shape
    if m < 2:
        raise ValueError(f"CRPS requires at least 2 ensemble members, but you provided {tuple(preds.shape)}.")
    rows = chunk_rows or _crps_rows(m)
    diff, spread = [], []
    for p, t in zip(preds.split(rows), target.split(rows)):
        p, t = p.to(torch.float64), t.to(torch.float64)
        diff.append((p - t[:, None]).abs_().sum(1) / m)
        spread.append((p[:, :, None] - p[:, None, :]).abs_().sum((1, 2)) / (2 * m * m))
    return batch_size, torch.cat(diff).to(torch.float32), torch.cat(spread).to(torch.float32)


def _crps_compute(batch_size, diff: torch.Tensor, ensemble_sum: torch.Tensor) -> torch.Tensor:
    return (diff - ensemble_sum).mean()


def continuous_ranked_probability_score(preds, target) -> torch.Tensor:
    """Continuous ranked probability score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import continuous_ranked_probability_score
        >>> preds = torch.tensor([[1.0, 2.0, 3.0], [2.0, 3.0, 4.0]])
        >>> target = torch.tensor([2.0, 3.0])
        >>> continuous_ranked_probability_score(preds, target)
        tensor(0.2222)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    batch_size, diff, ensemble_sum = _crps_update(preds, target)
    return _crps_compute(batch_size, diff, ensemble_sum)
