"""Numerics helpers (counterpart of ``torchmetrics_tpu/utilities/compute.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def _safe_divide(num: torch.Tensor, denom: torch.Tensor, zero_division: float = 0.0) -> torch.Tensor:
    """``num / denom`` with 0-denominator positions replaced by ``zero_division``.

    Both operands are promoted to at least float32.
    """
    num = torch.as_tensor(num)
    denom = torch.as_tensor(denom, device=num.device)
    dtype = torch.promote_types(torch.promote_types(num.dtype, denom.dtype), torch.float32)
    num = num.to(dtype)
    denom = denom.to(dtype)
    zero = denom == 0
    quotient = num / torch.where(zero, torch.ones_like(denom), denom)
    return torch.where(zero, torch.full_like(quotient, zero_division), quotient)


def _adjust_weights_safe_divide(
    score: torch.Tensor,
    average: Optional[str],
    multilabel: bool,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    top_k: int = 1,
) -> torch.Tensor:
    """Weighted/macro reduction of per-class scores, ignoring absent classes."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(torch.float32)
    else:
        weights = torch.ones_like(score, dtype=torch.float32)
        if not multilabel:
            # drop classes that never appear (neither predicted nor present); with
            # top_k > 1 only true absence (no support) drops a class
            absent = (tp + fp + fn) == 0 if top_k == 1 else (tp + fn) == 0
            weights = weights * (~absent)
    norm = weights.sum(-1, keepdim=True)
    return (_safe_divide(weights, norm) * score).sum(-1)


def normalize_logits_if_needed(preds: torch.Tensor, normalization: str = "sigmoid") -> torch.Tensor:
    """Apply sigmoid (or softmax over dim 1) to the whole batch when any value lies
    outside [0, 1]; otherwise return the batch as it is.

    The test is one 0-d condition over the batch, applied by ``torch.where``, so CUDA
    never waits for the host. Integer input is taken as float32 first.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
        >>> normalize_logits_if_needed(torch.tensor([0.25, 0.75]))
        tensor([0.2500, 0.7500])
        >>> normalize_logits_if_needed(torch.tensor([0.25, 1.5]))  # one value outside: all of it
        tensor([0.5622, 0.8176])
    """
    if not preds.is_floating_point():
        preds = preds.to(torch.float32)
    outside = (preds.min() < 0) | (preds.max() > 1)
    if normalization == "sigmoid":
        return torch.where(outside, preds.sigmoid(), preds)
    if normalization == "softmax":
        return torch.where(outside, preds.softmax(dim=1), preds)
    return preds
