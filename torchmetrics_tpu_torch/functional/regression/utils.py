"""Shared regression helpers (counterpart of
``torchmetrics_tpu/functional/regression/utils.py``).

``_rank_data`` gives each tie run its exact mean rank, ``(first + last) / 2`` from the
run's integer bounds (``_tie_runs``), which is scipy's ``rankdata``. The JAX package
averages a run by a float32 ``segment_sum`` of its positions, so its ranks equal these
only while every run's position sum stays below 2**24: on a long run of equal values
(the zeros of intermittent demand) its mean rank rounds off scipy's.

Means and float sums here are accumulated in float64 and rounded once to float32, so the
card and the CPU give the same bits whatever order each adds in.
"""

from __future__ import annotations

import torch


def _check_data_shape_to_num_outputs(preds: torch.Tensor, target: torch.Tensor, num_outputs: int,
                                     allow_1d_reshape: bool = False) -> None:
    """Check predictions/target shape against declared ``num_outputs``."""
    if preds.ndim > 2:
        raise ValueError(
            f"Expected both predictions and target to be either 1- or 2-dimensional tensors, but got {target.ndim} "
            f"and {preds.ndim}."
        )
    cond1 = False
    if not allow_1d_reshape:
        cond1 = num_outputs == 1 and preds.ndim != 1
    cond2 = num_outputs > 1 and (preds.ndim < 2 or preds.shape[1] != num_outputs)
    if cond1 or cond2:
        raise ValueError(
            f"Expected argument `num_outputs` to match the second dimension of input, but got {num_outputs} and "
            f"{tuple(preds.shape)}"
        )


def _mean32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The float32 mean along ``dim``: the float64 sum over the count, rounded once.

    Over a single value the mean is that value, ``-0.0`` included, as ``jnp.mean`` gives
    it; torch's sum starts from ``+0.0`` and would lose the sign. (Over two or more values
    ``jnp.mean`` starts from ``+0.0`` too, so all ``-0.0`` give ``+0.0`` in both.)"""
    if x.shape[dim] == 1:
        return x.select(dim, 0).to(torch.float32)
    return (x.sum(dim, dtype=torch.float64) / x.shape[dim]).to(torch.float32)


def _tie_runs(xs: torch.Tensor):
    """Each position's tie run in ``xs``, sorted along its last axis: the run's first and
    last index within its row (int64). A NaN differs from everything, so each NaN is a
    run of its own.

    The runs are numbered over all rows by a cumulative sum of their starts, and their
    bounds come from one ``nonzero`` of the starts (a host read): no segment reduction,
    no scan with indices."""
    n = xs.shape[-1]
    starts = torch.ones(xs.shape, dtype=torch.bool, device=xs.device)
    starts[..., 1:] = xs[..., 1:] != xs[..., :-1]
    flat = starts.reshape(-1)
    run = flat.cumsum(0) - 1
    bounds = flat.nonzero().squeeze(1)
    ends = torch.cat([bounds[1:], bounds.new_full((1,), flat.numel())])
    row_offset = torch.arange(flat.numel(), device=xs.device).div_(n, rounding_mode="floor").mul_(n)
    first = (bounds[run] - row_offset).reshape(xs.shape)
    last = (ends[run] - 1 - row_offset).reshape(xs.shape)
    return first, last


def _rank_data(x: torch.Tensor) -> torch.Tensor:
    """1-based float32 ranks along the last axis, ties averaged (scipy ``rankdata``).

    One stable sort, then each run's mean position ``(first + last) / 2`` from its integer
    bounds. NaN sorts last and each NaN is a run of its own, in input order, as in the
    JAX package.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.regression.utils import _rank_data
        >>> _rank_data(torch.tensor([3.0, 1.0, 3.0, 2.0, 3.0]))
        tensor([4., 1., 4., 2., 4.])
    """
    xs, order = torch.sort(x, dim=-1, stable=True)
    first, last = _tie_runs(xs)
    ranks_sorted = ((first + last + 2).to(torch.float64) / 2).to(torch.float32)
    return torch.empty_like(ranks_sorted).scatter_(-1, order, ranks_sorted)
