"""Row-wise masked retrieval kernels over padded ``(Q, L)`` query matrices (counterpart
of ``torchmetrics_tpu/functional/retrieval/_kernels.py``).

Each kernel returns a ``(Q,)`` float32 vector of per-query scores and serves both the
functional API (one query = one row) and the stateful classes (the whole corpus in one
call), with no loop over queries. The semantics are the JAX package's, including its
``preds > 0`` relevance filter where it applies it (AP, RR, precision, recall).

Counts are exact in any order. The float sums (AP's precision sum, DCG's gains and
discounts) are taken in float64 and rounded once, so the card and the CPU agree whatever
order each adds in; the JAX package adds them in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from .utils import _descending_order, _ranked_by_preds, _segment_bounds, _tie_average_ranks


def _positions_within_k(mask_ranked: torch.Tensor, top_k: int) -> torch.Tensor:
    """Bool (Q, L): ranked position is a real (non-pad) entry within the top-k."""
    n = mask_ranked.shape[-1]
    return mask_ranked & (torch.arange(n, device=mask_ranked.device) < top_k)


def _relevant_within_k(preds, target, mask, k: int) -> torch.Tensor:
    """Bool (Q, L) in rank order: a positive target within the top-k."""
    ranked, rmask = _ranked_by_preds(preds, target, mask)
    return (ranked > 0) & _positions_within_k(rmask, k)


def _filtered(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The JAX package's (and the reference's) filter: a target counts only where its
    pred is positive."""
    return torch.where(preds > 0, target, 0)


def _ap_kernel(preds, target, mask, top_k: Optional[int] = None) -> torch.Tensor:
    """Average precision."""
    n = preds.shape[-1]
    rel = _relevant_within_k(preds, _filtered(preds, target), mask, top_k or n)
    relf = rel.to(torch.float32)
    prec_at = relf.cumsum(-1) / torch.arange(1, n + 1, dtype=torch.float32, device=preds.device)
    n_rel = relf.sum(-1)
    total = (prec_at.to(torch.float64) * rel).sum(-1).to(torch.float32)
    return torch.where(n_rel > 0, total / n_rel.clamp(min=1.0), 0.0)


def _rr_kernel(preds, target, mask, top_k: Optional[int] = None) -> torch.Tensor:
    """Reciprocal rank."""
    rel = _relevant_within_k(preds, _filtered(preds, target), mask, top_k or preds.shape[-1])
    first = rel.to(torch.uint8).argmax(-1)  # the first maximum
    return torch.where(rel.any(-1), 1.0 / (first + 1.0), 0.0).to(torch.float32)


def _hits(preds, target, mask, k: int) -> torch.Tensor:
    return _relevant_within_k(preds, target, mask, k).sum(-1).to(torch.float32)


def _positives(target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(Q,) int64: each row's positive targets."""
    return (torch.where(mask, target, 0) > 0).sum(-1)


def _precision_kernel(preds, target, mask, top_k: Optional[int] = None, adaptive_k: bool = False) -> torch.Tensor:
    """Precision@k. Without ``top_k`` the denominator is each row's count of real
    entries (the reference sets ``top_k`` to the query's length), not the padded width."""
    n_valid = mask.sum(-1).to(torch.float32)
    k = preds.shape[-1] if top_k is None else top_k
    rel = _hits(preds, _filtered(preds, target), mask, k)
    if top_k is None:
        denom = n_valid
    elif adaptive_k:
        denom = n_valid.clamp(max=float(k))
    else:
        denom = torch.full_like(n_valid, float(k))
    return torch.where(_positives(target, mask) > 0, rel / denom, 0.0)


def _recall_kernel(preds, target, mask, top_k: Optional[int] = None) -> torch.Tensor:
    """Recall@k."""
    k = preds.shape[-1] if top_k is None else top_k
    rel = _hits(preds, _filtered(preds, target), mask, k)
    total = _positives(target, mask).to(torch.float32)
    return torch.where(total > 0, rel / total.clamp(min=1.0), 0.0)


def _hit_rate_kernel(preds, target, mask, top_k: Optional[int] = None) -> torch.Tensor:
    """HitRate@k (no ``preds > 0`` filter)."""
    k = preds.shape[-1] if top_k is None else top_k
    return (_hits(preds, target, mask, k) > 0).to(torch.float32)


def _fall_out_kernel(preds, target, mask, top_k: Optional[int] = None) -> torch.Tensor:
    """FallOut@k over the negative targets."""
    k = preds.shape[-1] if top_k is None else top_k
    neg = torch.where(mask, 1 - target, 0)
    rel = _hits(preds, neg, mask, k)
    total = (neg > 0).sum(-1).to(torch.float32)
    return torch.where(total > 0, rel / total.clamp(min=1.0), 0.0)


def _r_precision_kernel(preds, target, mask) -> torch.Tensor:
    """R-Precision: precision at each row's count of positives."""
    ranked, rmask = _ranked_by_preds(preds, target, mask)
    n_rel = _positives(target, mask)
    within = rmask & (torch.arange(preds.shape[-1], device=preds.device) < n_rel[:, None])
    rel = ((ranked > 0) & within).sum(-1).to(torch.float32)
    return torch.where(n_rel > 0, rel / n_rel.to(torch.float32).clamp(min=1.0), 0.0)


def _discount(n: int, top_k: int, device) -> torch.Tensor:
    """float32 ``1 / log2(rank + 1)`` for ranks 1..n, 0 beyond ``top_k``."""
    rank = torch.arange(n, device=device)
    discount = 1.0 / torch.log2(rank.to(torch.float32) + 2.0)
    return torch.where(rank < top_k, discount, 0.0)


def _dcg_tie_averaged(preds, gains, mask, top_k: int) -> torch.Tensor:
    """Tie-averaged DCG per row (sklearn's ``_tie_averaged_dcg``): within a tie group
    the gain is the group's mean, weighted by the group's share of the discounts. Each
    group's sums come from float64 running sums between its bounds."""
    n = preds.shape[-1]
    order, eff = _descending_order(preds, mask)
    sorted_preds = eff.gather(-1, order)
    sorted_gains = torch.where(mask, gains, 0.0).gather(-1, order).to(torch.float64)
    first, last = _segment_bounds(sorted_preds)

    def group_sum(values: torch.Tensor) -> torch.Tensor:
        running = torch.nn.functional.pad(values.cumsum(-1), (1, 0))
        return running.gather(-1, last + 1) - running.gather(-1, first)

    discount = _discount(n, top_k, preds.device).to(torch.float64).expand(sorted_gains.shape)
    count = (last - first + 1).to(torch.float64)
    column = torch.arange(n, device=preds.device)
    per_group = group_sum(sorted_gains) / count * group_sum(discount)
    return torch.where(column == first, per_group, 0.0).sum(-1).to(torch.float32)


def _dcg_ideal(gains, mask, top_k: int) -> torch.Tensor:
    """Ideal (sorted-by-gain) DCG per row, ties irrelevant."""
    n = gains.shape[-1]
    sorted_gains = torch.where(mask, gains, 0.0).sort(-1, descending=True).values
    return (sorted_gains.to(torch.float64) * _discount(n, top_k, gains.device)).sum(-1).to(torch.float32)


def _ndcg_kernel(preds, target, mask, top_k: Optional[int] = None) -> torch.Tensor:
    """NDCG: tie-averaged DCG over the ideal DCG."""
    k = preds.shape[-1] if top_k is None else top_k
    gains = torch.where(mask, target, 0).to(torch.float32)
    dcg = _dcg_tie_averaged(preds, gains, mask, k)
    ideal = _dcg_ideal(gains, mask, k)
    return torch.where(ideal > 0, dcg / ideal.clamp(min=1e-38), 0.0)


def _auroc_kernel(preds, target, mask, top_k: Optional[int] = None) -> torch.Tensor:
    """Per-query binary AUROC over the top-k documents by tie-averaged rank statistics
    (Mann-Whitney U): ``(R_pos - n_pos(n_pos+1)/2) / (n_pos * n_neg)``, ``R_pos`` the
    sum of the positives' ascending ranks (half-integers: exact in any order)."""
    n = preds.shape[-1]
    k = n if top_k is None else top_k
    order, eff = _descending_order(preds, mask)
    ranked_t, rmask = target.gather(-1, order), mask.gather(-1, order)
    within = _positions_within_k(rmask, k)
    ranks = _tie_average_ranks(eff.gather(-1, order), within)
    pos = (ranked_t > 0) & within
    neg = (ranked_t == 0) & within
    n_pos = pos.sum(-1).to(torch.float32)
    n_neg = neg.sum(-1).to(torch.float32)
    r_pos = torch.where(pos, ranks, 0.0).sum(-1)
    auc = (r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg).clamp(min=1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, 0.0)
