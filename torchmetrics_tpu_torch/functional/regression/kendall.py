"""Kendall rank correlation, variants a, b and c, with the optional t-test (counterpart of
``torchmetrics_tpu/functional/regression/kendall.py``).

Pair counts. The JAX package compares the pairs in row blocks of ``_block_rows(n)``
rows against all ``n`` columns, counts each block exactly and adds the block counts
into a float32 total, block by block. Past 2**24 pairs that total rounds, so its value
depends on the block order. Here each block's counts are exact too (sums of the signs
``sign(dx) * sign(dy)`` over the upper triangle, integers that float32 holds exactly
below 2**24 per row), many blocks go through each launch (``_GROUP_ELEMS`` comparisons),
and the per-block counts come back to the host once and are added in float32 in the
JAX package's block order. So ``con`` and ``dis`` equal the JAX package's bit for bit,
on the card and on the CPU.

Tie statistics come from one sort per column, with each run's length found at every
position from its bounds (``utils._tie_runs``): no segment reduction. They are exact in float64 and rounded once; the JAX
package forms and sums them in float32, so they agree within its rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from .utils import _tie_runs

_ALLOWED_VARIANTS = ("a", "b", "c")
_ALLOWED_ALTERNATIVES = ("two-sided", "less", "greater")

# the JAX package's pair block: about 4M comparisons per block of rows
_PAIR_BLOCK_ELEMS = 1 << 22
# comparisons per launch: a group of whole blocks, two float32 temporaries of this size
_GROUP_ELEMS = 1 << 26


def _block_rows(n: int) -> int:
    """Rows per block, as the JAX package cuts the ``(n, n)`` comparison."""
    return int(min(n, max(64, _PAIR_BLOCK_ELEMS // max(n, 1))))


def _block_pair_counts(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact concordant and discordant pair counts of each row block, int64 on the
    metric's device.

    A pair (i, j) with j > i is concordant when ``sign(x_i - x_j) * sign(y_i - y_j)``
    is 1 and discordant when it is -1; NaN and ties give 0. Per row, the sum of the
    products is ``con - dis`` and the sum of their magnitudes ``con + dis``."""
    n = x.shape[0]
    chunk = _block_rows(n)
    group_rows = chunk * max(1, _GROUP_ELEMS // (chunk * n))
    diffs, sizes = [], []
    for lo in range(0, n, group_rows):
        hi = min(n, lo + group_rows)
        prod = torch.sub(x[lo:hi, None], x[None, :]).sign_()
        prod.mul_(torch.sub(y[lo:hi, None], y[None, :]).sign_())
        prod.triu_(diagonal=lo + 1)  # column > row: each unordered pair once
        diffs.append(prod.sum(1))
        sizes.append(prod.abs_().sum(1))
    pad = (-n) % chunk
    diff, size = [torch.nn.functional.pad(torch.cat(v).to(torch.int64), (0, pad)).view(-1, chunk).sum(1)
                  for v in (diffs, sizes)]
    return (size + diff) // 2, (size - diff) // 2


def _pair_counts(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concordant and discordant pair counts: exact block counts added in float32, in
    block order. Under ``torch.export`` the fold is a loop on the device whose length,
    the number of blocks, follows from ``n``; eagerly the same float32 sums run on the
    host after one read, since the device loop costs a launch a block (256 at 32,768
    pairs)."""
    blocks = torch.stack(_block_pair_counts(x, y), dim=1).to(torch.float32)  # (blocks, 2)
    if torch.compiler.is_exporting():
        total = torch.zeros((2,), dtype=torch.float32, device=x.device)
        for i in range(blocks.shape[0]):
            total = total + blocks[i]
        return total[0], total[1]
    con, dis = np.float32(0), np.float32(0)
    for c, d in blocks.cpu().numpy():
        con, dis = np.float32(con + c), np.float32(dis + d)
    return (torch.tensor(con, dtype=torch.float32, device=x.device),
            torch.tensor(dis, dtype=torch.float32, device=x.device))


def _tie_stats(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(sum t(t-1)/2, sum t(t-1)(t-2), sum t(t-1)(2t+5), number of distinct values) over
    the tie runs of ``x``, each run of length ``t`` taken once."""
    first, last = _tie_runs(torch.sort(x).values)
    t = (last - first + 1).to(torch.float64)
    # each run's term spread over its t positions: t(t-1)/2 / t = (t-1)/2, and so on;
    # exact in float64, rounded once
    per_position = torch.stack([(t - 1) / 2, (t - 1) * (t - 2), (t - 1) * (2 * t + 5)])
    ties, ties_p1, ties_p2 = per_position.sum(1).to(torch.float32)
    return ties, ties_p1, ties_p2, (first == torch.arange(x.shape[0], device=x.device)).sum().to(torch.float32)


def _kendall_tau_1d(preds: torch.Tensor, target: torch.Tensor, variant: str, t_test: bool,
                    alternative: Optional[str]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    n = torch.tensor(float(preds.shape[0]), dtype=torch.float32, device=preds.device)
    con, dis = _pair_counts(preds, target)
    con_min_dis = con - dis
    x_ties, x_p1, x_p2, x_uniq = _tie_stats(preds)
    y_ties, y_p1, y_p2, y_uniq = _tie_stats(target)

    if variant == "a":
        tau = con_min_dis / (con + dis)
    elif variant == "b":
        total = n * (n - 1) / 2
        tau = con_min_dis / torch.sqrt((total - x_ties) * (total - y_ties))
    else:
        min_classes = torch.minimum(x_uniq, y_uniq)
        tau = 2 * con_min_dis / ((min_classes - 1) / min_classes * n * n)

    p_value = None
    if t_test:
        base = n * (n - 1) * (2 * n + 5)
        if variant == "a":
            t_value = 3 * con_min_dis / torch.sqrt(base / 2)
        else:
            m = n * (n - 1)
            denom = (base - x_p2 - y_p2) / 18
            denom = denom + (2 * x_ties * y_ties) / m
            denom = denom + (x_p1 * y_p1) / (9 * m * (n - 2))
            t_value = con_min_dis / torch.sqrt(denom)
        if alternative == "two-sided":
            p_value = 2 * (1 - torch.special.ndtr(t_value.abs()))
        elif alternative == "greater":
            p_value = 1 - torch.special.ndtr(t_value)
        else:
            p_value = torch.special.ndtr(t_value)
    return tau.clamp(-1.0, 1.0), p_value


def _kendall_corrcoef_compute(preds: torch.Tensor, target: torch.Tensor, variant: str = "b", t_test: bool = False,
                              alternative: Optional[str] = "two-sided"):
    if preds.ndim == 1:
        return _kendall_tau_1d(preds, target, variant, t_test, alternative)
    taus, ps = [], []
    for i in range(preds.shape[-1]):
        tau, p = _kendall_tau_1d(preds[:, i].contiguous(), target[:, i].contiguous(), variant, t_test, alternative)
        taus.append(tau)
        ps.append(p)
    return torch.stack(taus), torch.stack(ps) if t_test else None


def kendall_rank_corrcoef(
    preds,
    target,
    variant: str = "b",
    t_test: bool = False,
    alternative: Optional[str] = "two-sided",
):
    """Kendall's tau; ``(tau, p_value)`` when ``t_test``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import kendall_rank_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> kendall_rank_corrcoef(preds, target)
        tensor(1.)
    """
    if variant not in _ALLOWED_VARIANTS:
        raise ValueError(f"Argument `variant` is expected to be one of {_ALLOWED_VARIANTS}, but got {variant!r}")
    if not isinstance(t_test, bool):
        raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {t_test}.")
    if t_test and alternative not in _ALLOWED_ALTERNATIVES:
        raise ValueError(f"Argument `alternative` is expected to be one of {_ALLOWED_ALTERNATIVES}, but got {alternative!r}")
    preds, target = _as_tensor(preds).to(torch.float32), _as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)
    tau, p_value = _kendall_corrcoef_compute(preds, target, variant, t_test, alternative)
    if p_value is not None:
        return tau, p_value
    return tau
