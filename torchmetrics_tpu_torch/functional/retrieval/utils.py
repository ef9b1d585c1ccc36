"""Retrieval machinery: input checks, query padding, tie-aware rank helpers (counterpart
of ``torchmetrics_tpu/functional/retrieval/utils.py``).

Queries are padded into a dense ``(Q, L)`` matrix with a validity mask, and every metric
is a row-wise masked kernel over that matrix: no loop over queries. The padding runs on
the metric's device (``torch.unique`` and a stable sort of the inverse), with one host
read to size the matrix; its layout equals the JAX package's host numpy one bit for bit.

Every sort goes through ``_numpy_order``: a stable sort on a key with one zero and one
NaN, as XLA's sort sees floats (``torch.argsort`` is not stable by default, and CUDA's
radix sort orders ``-0.0`` before ``+0.0`` and NaNs by their bits).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ..classification.precision_recall_curve import _numpy_order

NEG_INF = float("-inf")


def _is_integer(x: torch.Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def _check_binary(target: torch.Tensor) -> None:
    """One host read: raise unless every target is 0 or 1."""
    if bool(((target > 1) | (target < 0)).any()):
        raise ValueError("`target` must contain `binary` values")


def _check_retrieval_functional_inputs(
    preds, target, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate a single query's (preds, target): flat float32 preds, flat int32 target."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    target = target.to(preds.device)
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.numel() == 0:
        raise ValueError("`preds` and `target` must be non-empty")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if not (_is_integer(target) or target.dtype == torch.bool):
        raise ValueError("`target` must be a tensor of booleans or integers")
    target = target.to(torch.int32)
    if not allow_non_binary_target:
        _check_binary(target)
    return preds.reshape(-1).to(torch.float32), target.reshape(-1)


def _check_retrieval_inputs(
    indexes, preds, target, allow_non_binary_target: bool = False, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Validate (indexes, preds, target) and drop the ``ignore_index`` targets by a
    boolean mask on the device. Indexes are stored as int32, as the JAX package stores
    them."""
    preds = _as_tensor(preds)
    indexes, target = _as_tensor(indexes).to(preds.device), _as_tensor(target).to(preds.device)
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if not _is_integer(indexes):
        raise ValueError("`indexes` must be a tensor of long integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if not (_is_integer(target) or target.dtype == torch.bool):
        raise ValueError("`target` must be a tensor of booleans or integers")
    indexes = indexes.reshape(-1).to(torch.int32)
    preds = preds.reshape(-1).to(torch.float32)
    target = target.reshape(-1).to(torch.int32)
    if ignore_index is not None:
        keep = target != ignore_index
        indexes, preds, target = indexes[keep], preds[keep], target[keep]
    if preds.numel() == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty")
    if not allow_non_binary_target:
        _check_binary(target)
    return indexes, preds, target


def _pad_queries(indexes, preds, target) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group flat (indexes, preds, target) into padded ``(Q, L)`` float32 preds, targets
    (their dtype) and a bool mask: queries in ascending id order, each query's rows in
    their input order. ``L`` is the longest query (one host read)."""
    idx, p, t = indexes.reshape(-1), preds.reshape(-1), target.reshape(-1)
    uniq, inv, counts = torch.unique(idx, sorted=True, return_inverse=True, return_counts=True)
    q = uniq.numel()
    max_len = int(counts.max()) if q else 1
    order = torch.sort(inv, stable=True).indices
    inv_sorted = inv[order]
    starts = counts.cumsum(0) - counts
    pos = torch.arange(idx.numel(), device=idx.device) - starts[inv_sorted]
    preds2d = torch.zeros((q, max_len), dtype=torch.float32, device=idx.device)
    target2d = torch.zeros((q, max_len), dtype=t.dtype, device=idx.device)
    mask2d = torch.zeros((q, max_len), dtype=torch.bool, device=idx.device)
    preds2d[inv_sorted, pos] = p[order].to(torch.float32)
    target2d[inv_sorted, pos] = t[order]
    mask2d[inv_sorted, pos] = True
    return preds2d, target2d, mask2d


def _descending_order(preds: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (order, eff): the stable descending order of each row's preds, padding
    (``-inf``) last among the finite values, and the padded preds ``eff``."""
    eff = torch.where(mask, preds, NEG_INF)
    return _numpy_order(-eff, dim=-1), eff


def _ranked_by_preds(preds: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row targets/mask reordered by descending preds; padded entries sink last."""
    order, _ = _descending_order(preds, mask)
    return target.gather(-1, order), mask.gather(-1, order)


def _segment_starts(sorted_vals: torch.Tensor) -> torch.Tensor:
    """Bool: where a tie group starts in each row of row-wise sorted values (a NaN
    differs from everything, so each NaN starts a group of its own)."""
    first = torch.ones_like(sorted_vals[..., :1], dtype=torch.bool)
    return torch.cat([first, sorted_vals[..., 1:] != sorted_vals[..., :-1]], dim=-1)


def _row_segment_ids(sorted_vals: torch.Tensor) -> torch.Tensor:
    """Tie-group ids per row for row-wise sorted values (0-based, ascending), int32."""
    return (_segment_starts(sorted_vals).to(torch.int32).cumsum(-1, dtype=torch.int32) - 1)


def _segment_bounds(sorted_vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each position's tie group in row-wise sorted values: the group's first and last
    column (int64), by a running max of the starts and a reversed running min of the
    ends. Row-wise, with no atomics: the same on the card and the CPU."""
    n = sorted_vals.shape[-1]
    starts = _segment_starts(sorted_vals)
    column = torch.arange(n, device=sorted_vals.device).expand(sorted_vals.shape)
    first = torch.where(starts, column, 0).cummax(-1).values
    ends = torch.cat([starts[..., 1:], torch.ones_like(starts[..., :1])], dim=-1)
    last = torch.where(ends, column, n).flip(-1).cummin(-1).values.flip(-1)
    return first, last


def _tie_average_ranks(preds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Average ranks (1-based, ascending preds) with ties averaged, per row, float32.

    Padded entries get rank 0 and must be excluded by the caller via ``mask``. A group's
    mean ordinal is ``(first + last) / 2 + 1``, exact, as the JAX package's float32
    segment sums are exact at these lengths (below 2**24)."""
    eff = torch.where(mask, preds, NEG_INF)  # padded sort first (ascending)
    order = _numpy_order(eff, dim=-1)
    first, last = _segment_bounds(eff.gather(-1, order))
    avg_sorted = ((first + last + 2).to(torch.float64) / 2).to(torch.float32)
    ranks = torch.zeros_like(avg_sorted).scatter_(-1, order, avg_sorted)
    # shift so ranks count only real entries (padded occupy the lowest ordinals)
    n_pad = (~mask).sum(-1, keepdim=True).to(torch.float32)
    return torch.where(mask, ranks - n_pad, 0.0)
