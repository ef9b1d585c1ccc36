"""Functional retrieval metrics (counterpart of ``torchmetrics_tpu/functional/retrieval``).

Every public function scores ONE query (1-D preds/target) on the device of the tensors
it is given; each is a thin wrapper over the row-wise padded kernels of ``_kernels.py``
(one row = one query).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..classification.precision_recall_curve import _numpy_order
from ._kernels import (
    _ap_kernel,
    _auroc_kernel,
    _fall_out_kernel,
    _hit_rate_kernel,
    _ndcg_kernel,
    _precision_kernel,
    _r_precision_kernel,
    _recall_kernel,
    _rr_kernel,
)
from .utils import _check_retrieval_functional_inputs, _ranked_by_preds


def _validate_top_k(top_k: Optional[int]) -> None:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


def _as_row(preds, target, allow_non_binary_target=False):
    p, t = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target)
    return p[None, :], t[None, :], torch.ones((1, p.shape[0]), dtype=torch.bool, device=p.device)


def retrieval_average_precision(preds, target, top_k: Optional[int] = None) -> torch.Tensor:
    """AP of one query.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> retrieval_average_precision(preds, target)
        tensor(1.)
    """
    _validate_top_k(top_k)
    p, t, m = _as_row(preds, target)
    return _ap_kernel(p, t, m, top_k)[0]


def retrieval_reciprocal_rank(preds, target, top_k: Optional[int] = None) -> torch.Tensor:
    """RR of one query.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> retrieval_reciprocal_rank(preds, target)
        tensor(1.)
    """
    _validate_top_k(top_k)
    p, t, m = _as_row(preds, target)
    return _rr_kernel(p, t, m, top_k)[0]


def retrieval_precision(preds, target, top_k: Optional[int] = None, adaptive_k: bool = False) -> torch.Tensor:
    """Precision@k of one query.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> retrieval_precision(preds, target, top_k=2)
        tensor(1.)
    """
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    _validate_top_k(top_k)
    p, t, m = _as_row(preds, target)
    return _precision_kernel(p, t, m, top_k, adaptive_k)[0]


def retrieval_recall(preds, target, top_k: Optional[int] = None) -> torch.Tensor:
    """Recall@k of one query.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> retrieval_recall(preds, target, top_k=2)
        tensor(1.)
    """
    _validate_top_k(top_k)
    p, t, m = _as_row(preds, target)
    return _recall_kernel(p, t, m, top_k)[0]


def retrieval_hit_rate(preds, target, top_k: Optional[int] = None) -> torch.Tensor:
    """HitRate@k of one query.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_hit_rate
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> retrieval_hit_rate(preds, target, top_k=2)
        tensor(1.)
    """
    _validate_top_k(top_k)
    p, t, m = _as_row(preds, target)
    return _hit_rate_kernel(p, t, m, top_k)[0]


def retrieval_fall_out(preds, target, top_k: Optional[int] = None) -> torch.Tensor:
    """FallOut@k of one query.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_fall_out
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> retrieval_fall_out(preds, target, top_k=2)
        tensor(0.)
    """
    _validate_top_k(top_k)
    p, t, m = _as_row(preds, target)
    return _fall_out_kernel(p, t, m, top_k)[0]


def retrieval_r_precision(preds, target) -> torch.Tensor:
    """R-Precision of one query.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_r_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> retrieval_r_precision(preds, target)
        tensor(1.)
    """
    p, t, m = _as_row(preds, target)
    return _r_precision_kernel(p, t, m)[0]


def retrieval_normalized_dcg(preds, target, top_k: Optional[int] = None) -> torch.Tensor:
    """NDCG of one query; graded (non-binary) gains allowed.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_normalized_dcg
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> retrieval_normalized_dcg(preds, target)
        tensor(1.)
    """
    _validate_top_k(top_k)
    p, t, m = _as_row(preds, target, allow_non_binary_target=True)
    return _ndcg_kernel(p, t, m, top_k)[0]


def retrieval_auroc(preds, target, top_k: Optional[int] = None, max_fpr: Optional[float] = None) -> torch.Tensor:
    """AUROC of one query over its top-k documents; with ``max_fpr`` the standardised
    partial area, through the classification ``binary_auroc``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_auroc
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> retrieval_auroc(preds, target)
        tensor(1.)
    """
    _validate_top_k(top_k)
    if max_fpr is not None:
        from ..classification.auroc import binary_auroc

        p, t = _check_retrieval_functional_inputs(preds, target)
        k = min(top_k or p.shape[-1], p.shape[-1])
        order = _numpy_order(-p)[:k]
        tk = t[order]
        if not bool((tk.max() == 1) & (tk.min() == 0)):  # one host read
            return torch.zeros((), device=p.device)
        return binary_auroc(p[order], tk, max_fpr=max_fpr)
    p, t, m = _as_row(preds, target)
    return _auroc_kernel(p, t, m, top_k)[0]


def retrieval_precision_recall_curve(
    preds, target, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Precision@k and recall@k of one query for k = 1..max_k, and the ks (int32).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_precision_recall_curve
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([False, True, True, False])
        >>> precision, recall, ks = retrieval_precision_recall_curve(preds, target, max_k=3)
        >>> precision, recall, ks
        (tensor([1.0000, 1.0000, 0.6667]), tensor([0.5000, 1.0000, 1.0000]), tensor([1, 2, 3], dtype=torch.int32))
    """
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    p, t, m = _as_row(preds, target)
    n = p.shape[-1]
    if max_k is None:
        max_k = n
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")
    if adaptive_k and max_k > n:
        max_k = n
    ks = torch.arange(1, max_k + 1, dtype=torch.int32, device=p.device)
    ranked, rmask = _ranked_by_preds(p, torch.where(p > 0, t, 0), m)
    cum = ((ranked > 0) & rmask).to(torch.float32)[0].cumsum(0)
    cum_k = cum[(ks - 1).clamp(max=n - 1).long()]
    precision = cum_k / ks.to(torch.float32)
    total = (torch.where(m, t, 0) > 0).sum().to(torch.float32)
    recall = torch.where(total > 0, cum_k / total.clamp(min=1.0), 0.0)
    return precision, recall, ks


__all__ = [
    "retrieval_average_precision",
    "retrieval_auroc",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
