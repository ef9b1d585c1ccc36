"""Retrieval metric classes (counterpart of ``torchmetrics_tpu/retrieval/metrics.py``),
all over the padded-kernel base; ``top_k`` and ``adaptive_k`` as in the JAX package."""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from ..functional.retrieval._kernels import (
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
from ..functional.retrieval.utils import _ranked_by_preds
from .base import RetrievalMetric, _mean


def _validate_top_k(top_k: Optional[int]) -> None:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


class _TopKRetrievalMetric(RetrievalMetric):
    """Shared ``top_k`` plumbing."""

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Union[str, Callable] = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _validate_top_k(top_k)
        self.top_k = top_k


class RetrievalMAP(_TopKRetrievalMetric):
    """Mean average precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalMAP(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.7917)
    """

    def _metric_padded(self, preds, target, mask):
        return _ap_kernel(preds, target, mask, self.top_k)


class RetrievalMRR(_TopKRetrievalMetric):
    """Mean reciprocal rank.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalMRR(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.7500)
    """

    def _metric_padded(self, preds, target, mask):
        return _rr_kernel(preds, target, mask, self.top_k)


class RetrievalPrecision(_TopKRetrievalMetric):
    """Precision@k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalPrecision(top_k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.5000)
    """

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, adaptive_k: bool = False,
                 aggregation: Union[str, Callable] = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, top_k, aggregation, **kwargs)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _metric_padded(self, preds, target, mask):
        return _precision_kernel(preds, target, mask, self.top_k, self.adaptive_k)


class RetrievalRecall(_TopKRetrievalMetric):
    """Recall@k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRecall
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRecall(top_k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.7500)
    """

    def _metric_padded(self, preds, target, mask):
        return _recall_kernel(preds, target, mask, self.top_k)


class RetrievalHitRate(_TopKRetrievalMetric):
    """HitRate@k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalHitRate
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalHitRate(top_k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(1.)
    """

    def _metric_padded(self, preds, target, mask):
        return _hit_rate_kernel(preds, target, mask, self.top_k)


class RetrievalFallOut(_TopKRetrievalMetric):
    """FallOut@k. Lower is better; the empty-query policy keys on the queries without a
    NEGATIVE target, and defaults to ``"pos"``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalFallOut
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalFallOut(top_k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.5000)
    """

    higher_is_better = False

    def __init__(self, empty_target_action: str = "pos", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Union[str, Callable] = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, top_k, aggregation, **kwargs)

    def _empty_query_mask(self, target2d, mask):
        return (torch.where(mask, 1 - target2d, 0) > 0).sum(-1) == 0

    def _metric_padded(self, preds, target, mask):
        return _fall_out_kernel(preds, target, mask, self.top_k)


class RetrievalRPrecision(RetrievalMetric):
    """R-Precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRPrecision(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.7500)
    """

    def _metric_padded(self, preds, target, mask):
        return _r_precision_kernel(preds, target, mask)


class RetrievalNormalizedDCG(_TopKRetrievalMetric):
    """NDCG@k; graded (non-binary) gains allowed.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalNormalizedDCG
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalNormalizedDCG(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.8467)
    """

    allow_non_binary_target = True

    def _metric_padded(self, preds, target, mask):
        return _ndcg_kernel(preds, target, mask, self.top_k)


class RetrievalAUROC(_TopKRetrievalMetric):
    """Per-query AUROC over the top-k documents. With ``max_fpr`` each query goes through
    ``retrieval_auroc`` in turn (a host loop, as in the JAX package).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalAUROC
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalAUROC(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        tensor(0.7500)
    """

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, max_fpr: Optional[float] = None,
                 aggregation: Union[str, Callable] = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, top_k, aggregation, **kwargs)
        if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
            raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
        self.max_fpr = max_fpr

    def _metric_padded(self, preds, target, mask):
        if self.max_fpr is not None:
            from ..functional.retrieval import retrieval_auroc

            lengths = mask.sum(-1).tolist()  # queries are packed to the front of their rows
            return torch.stack([retrieval_auroc(preds[q, :n], target[q, :n], self.top_k, self.max_fpr)
                                for q, n in enumerate(lengths)])
        return _auroc_kernel(preds, target, mask, self.top_k)


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Precision@k and recall@k for k = 1..max_k, averaged over the queries, and the ks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecisionRecallCurve
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalPrecisionRecallCurve(max_k=4, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> precisions, recalls, top_k = metric.compute()
        >>> precisions
        tensor([0.5000, 0.5000, 0.5000, 0.3750])
        >>> recalls
        tensor([0.5000, 0.7500, 1.0000, 1.0000])
    """

    higher_is_better = None

    def __init__(self, max_k: Optional[int] = None, adaptive_k: bool = False,
                 empty_target_action: str = "neg", ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, "mean", **kwargs)
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.max_k = max_k
        self.adaptive_k = adaptive_k

    def _compute(self, state):
        preds2d, target2d, mask = self._padded(state)
        n = preds2d.shape[1]
        max_k = self.max_k or n
        if self.adaptive_k and max_k > n:
            max_k = n
        device = preds2d.device
        ks = torch.arange(1, max_k + 1, dtype=torch.int32, device=device)
        ranked, rmask = _ranked_by_preds(preds2d, torch.where(preds2d > 0, target2d, 0), mask)
        cum = ((ranked > 0) & rmask).to(torch.float32).cumsum(-1)
        cum_k = cum[:, (ks - 1).clamp(max=n - 1).long()]  # (Q, K)
        if self.adaptive_k:
            denom = torch.minimum(ks.to(torch.float32), mask.sum(-1, keepdim=True).to(torch.float32))
        else:
            denom = ks.to(torch.float32)[None, :]
        precision_q = cum_k / denom
        total = (torch.where(mask, target2d, 0) > 0).sum(-1, keepdim=True).to(torch.float32)
        recall_q = torch.where(total > 0, cum_k / total.clamp(min=1.0), 0.0)
        empty = self._empty_query_mask(target2d, mask)
        precision_q = self._apply_empty_action(precision_q, empty)
        recall_q = self._apply_empty_action(recall_q, empty)
        if self.empty_target_action == "skip" and precision_q.shape[0] == 0:
            zeros = torch.zeros(max_k, device=device)
            return zeros, zeros, ks
        return _mean(precision_q, 0), _mean(recall_q, 0), ks


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The largest averaged recall@k whose averaged precision@k reaches
    ``min_precision``, and its k (among tied recalls the largest k).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRecallAtFixedPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRecallAtFixedPrecision(min_precision=0.5, max_k=4, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> metric.compute()
        (tensor(1.), tensor(3, dtype=torch.int32))
    """

    higher_is_better = True

    def __init__(self, min_precision: float = 0.0, max_k: Optional[int] = None, adaptive_k: bool = False,
                 empty_target_action: str = "neg", ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(max_k, adaptive_k, empty_target_action, ignore_index, **kwargs)
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a positive float between 0 and 1")
        self.min_precision = min_precision

    def _compute(self, state):
        precision, recall, ks = super()._compute(state)
        device = precision.device
        fallback_k = torch.tensor(self.max_k or int(ks[-1]), dtype=torch.int32, device=device)
        feasible = precision >= self.min_precision
        masked = torch.where(feasible, recall, float("-inf"))
        best_r = masked.max()
        if not bool(feasible.any()):
            return torch.zeros((), device=device), fallback_k
        # the reference's max over (r, k) tuples: among max-recall ties the LARGEST k
        # (recall does not fall with k, so ties at the max are the norm)
        ties = masked == best_r
        column = torch.arange(ks.shape[0], device=device)
        best_k = ks[int(torch.where(ties, column, -1).max())]
        if float(best_r) == 0.0:
            best_k = fallback_k  # the reference clamps best_k to max_k when no recall is achievable
        return best_r, best_k
