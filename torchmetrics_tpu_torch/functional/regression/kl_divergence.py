"""KL divergence and Jensen-Shannon divergence (counterpart of
``torchmetrics_tpu/functional/regression/kl_divergence.py``).

Rows are normalised, ``q`` (or the mixture ``m``) is clipped at 1e-24 and ``x log(x/y)``
is ``_safe_xlogy``, as in the JAX package. Each row's sums (the normalisers too) are
float64 sums rounded once."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum, _safe_xlogy


def _kld_check(p: torch.Tensor, q: torch.Tensor, log_prob: bool) -> None:
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")


def _kld_update(p: torch.Tensor, q: torch.Tensor, log_prob: bool):
    _kld_check(p, q, log_prob)
    p, q = p.to(torch.float32), q.to(torch.float32)
    total = p.shape[0]
    if log_prob:
        measures = _float32_sum(torch.exp(p) * (p - q), -1)
    else:
        p = p / _float32_sum(p, -1)[:, None]
        q = (q / _float32_sum(q, -1)[:, None]).clamp(min=1e-24)
        measures = _float32_sum(_safe_xlogy(p, p / q), -1)
    return measures, total


def _kld_compute(measures: torch.Tensor, total, reduction: Optional[str] = "mean") -> torch.Tensor:
    if reduction == "sum":
        return measures.sum()
    if reduction == "mean":
        return measures.sum() / total
    if reduction in (None, "none"):
        return measures
    return measures / total


def kl_divergence(p, q, log_prob: bool = False, reduction: Optional[str] = "mean") -> torch.Tensor:
    """KL divergence.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import kl_divergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> kl_divergence(p, q)
        tensor(0.0853)
    """
    p, q = _as_tensor(p), _as_tensor(q)
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)


def _jsd_update(p: torch.Tensor, q: torch.Tensor, log_prob: bool):
    _kld_check(p, q, log_prob)
    p, q = p.to(torch.float32), q.to(torch.float32)
    total = p.shape[0]
    if log_prob:
        p, q = torch.exp(p), torch.exp(q)
    else:
        p = p / _float32_sum(p, -1)[:, None]
        q = q / _float32_sum(q, -1)[:, None]
    m = (0.5 * (p + q)).clamp(min=1e-24)
    measures = 0.5 * _float32_sum(_safe_xlogy(p, p / m), -1) + 0.5 * _float32_sum(_safe_xlogy(q, q / m), -1)
    return measures, total


def _jsd_compute(measures: torch.Tensor, total, reduction: Optional[str] = "mean") -> torch.Tensor:
    return _kld_compute(measures, total, reduction)


def jensen_shannon_divergence(p, q, log_prob: bool = False, reduction: Optional[str] = "mean") -> torch.Tensor:
    """Jensen-Shannon divergence.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import jensen_shannon_divergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> jensen_shannon_divergence(p, q)
        tensor(0.0225)
    """
    p, q = _as_tensor(p), _as_tensor(q)
    measures, total = _jsd_update(p, q, log_prob)
    return _jsd_compute(measures, total, reduction)
