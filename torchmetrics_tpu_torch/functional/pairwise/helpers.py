"""Shared pairwise plumbing (counterpart of
``torchmetrics_tpu/functional/pairwise/helpers.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ...utilities.data import _jax_dtype

_CHUNK_BYTES = 1 << 28  # one row block's temporary: 256 MiB


def _check_input(x, y=None, zero_diagonal: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Validate shapes and resolve the ``zero_diagonal`` default (True iff ``y`` is
    omitted, when ``y`` is ``x``). Inputs take the dtypes the JAX package computes in:
    int64 as int32, float64 as float32."""
    x = _jax_dtype(_as_tensor(x))
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        y = _jax_dtype(_as_tensor(y))
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _zero_diagonal(distance: torch.Tensor, zero_diagonal: bool) -> torch.Tensor:
    """Zero the first ``min(N, M)`` diagonal entries, in place (the matrix is the
    caller's own fresh result)."""
    if zero_diagonal:
        distance.diagonal().zero_()
    return distance


def _reduce_distance_matrix(distmat: torch.Tensor, reduction: Optional[str] = None) -> torch.Tensor:
    """Reduce over the last axis. The sums are taken in float64 (int64 for integers) and
    rounded once, so the card and the CPU agree whatever order each adds in; a mean of
    integers is float32, as in the JAX package. The sums go one row block at a time, so
    the wide copy never holds the whole matrix."""
    if reduction is None or reduction == "none":
        return distmat
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")
    wide = torch.float64 if distmat.is_floating_point() or reduction == "mean" else torch.int64
    n, m = distmat.shape
    total = torch.cat([distmat[rows].sum(-1, dtype=wide) for rows in _row_blocks(n, 8 * m)])
    if reduction == "sum":
        return total.to(distmat.dtype)
    return (total / m).to(distmat.dtype if distmat.is_floating_point() else torch.float32)


def _row_blocks(rows: int, row_bytes: int) -> List[slice]:
    """Row slices whose temporaries of ``row_bytes`` a row stay within ``_CHUNK_BYTES``."""
    step = max(1, _CHUNK_BYTES // max(row_bytes, 1))
    return [slice(start, min(start + step, rows)) for start in range(0, max(rows, 1), step)]
