"""``RetrievalMetric`` base (counterpart of ``torchmetrics_tpu/retrieval/base.py``).

States: cat lists of flat (indexes int32, preds float32, target int32). Compute: pad the
queries into a dense ``(Q, L)`` matrix on the metric's device and run one row-wise
masked kernel for all queries. The empty-target policy and the aggregation apply to the
resulting ``(Q,)`` score vector.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from ..functional.retrieval.utils import _check_retrieval_inputs, _pad_queries
from ..metric import Metric


def _mean(values: torch.Tensor, dim=None) -> torch.Tensor:
    """The float32 mean as a float64 sum over the count, rounded once: the card and the
    CPU agree whatever order each adds in."""
    total = values.sum(dtype=torch.float64) if dim is None else values.sum(dim, dtype=torch.float64)
    count = values.numel() if dim is None else values.shape[dim]
    return (total / count).to(torch.float32)


def _median(values: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even count (the midpoint
    quantile), NaN if any value is NaN. ``torch.median`` would return the lower one."""
    flat = values.reshape(-1)
    n = flat.numel()
    ordered = flat.sort().values
    mid = (ordered[(n - 1) // 2] + ordered[n // 2]) * 0.5
    return torch.where(flat.isnan().any(), float("nan"), mid)


def _retrieval_aggregate(values: torch.Tensor, aggregation: Union[str, Callable]) -> torch.Tensor:
    """Reduce the per-query scores."""
    if callable(aggregation):
        return aggregation(values)
    if aggregation == "mean":
        return _mean(values)
    if aggregation == "median":
        return _median(values)
    if aggregation == "min":
        return values.min()
    if aggregation == "max":
        return values.max()
    raise ValueError(f"Unknown aggregation {aggregation}")


class RetrievalMetric(Metric):
    """Base class: group-by-query scoring with an empty-target policy.

    Subclasses implement ``_metric_padded(preds, target, mask) -> (Q,)``. ``update``
    takes ``(preds, target, indexes)``; the query of each row is its index.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    allow_non_binary_target = False
    _jittable_compute = False

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        aggregation: Union[str, Callable] = "mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        if not (aggregation in ("mean", "median", "min", "max") or callable(aggregation)):
            raise ValueError(
                "Argument `aggregation` must be one of `mean`, `median`, `min`, `max` or a custom callable function"
                f"which takes tensor of values, but got {aggregation}."
            )
        self.aggregation = aggregation
        self.add_state("indexes", default=[], dist_reduce_fx="cat")
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _prepare_inputs(self, preds, target, indexes=None):
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target,
            ignore_index=self.ignore_index,
        )
        return (preds, target, indexes), {}

    def _batch_state(self, preds, target, indexes):
        return {"indexes": indexes, "preds": preds, "target": target}

    def _empty_query_mask(self, target2d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(Q,) bool: the queries without a positive target (subclasses may invert)."""
        return (torch.where(mask, target2d, 0) > 0).sum(-1) == 0

    def _metric_padded(self, preds: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _metric(self, preds, target) -> torch.Tensor:
        """Single-query score (parity hook; the padded kernel is the fast path)."""
        p = torch.as_tensor(preds, device=self.device)[None, :]
        t = torch.as_tensor(target, device=self.device)[None, :]
        return self._metric_padded(p, t, torch.ones(p.shape, dtype=torch.bool, device=p.device))[0]

    def _padded(self, state):
        return _pad_queries(state["indexes"], state["preds"], state["target"])

    def _apply_empty_action(self, scores: torch.Tensor, empty: torch.Tensor) -> torch.Tensor:
        """Scores of the empty queries under ``empty_target_action``: set to 1 or 0, or
        left out (``skip``); ``error`` raises (one host read). ``scores`` may carry
        trailing axes (one row of a curve a query)."""
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError("`compute` method was provided with a query with no positive target.")
        rows = empty.reshape(-1, *([1] * (scores.ndim - 1)))
        if self.empty_target_action == "pos":
            return torch.where(rows, 1.0, scores)
        if self.empty_target_action == "neg":
            return torch.where(rows, 0.0, scores)
        if self.empty_target_action == "skip":
            return scores[~empty]
        return scores

    def _compute(self, state):
        preds2d, target2d, mask = self._padded(state)
        scores = self._metric_padded(preds2d, target2d, mask)
        scores = self._apply_empty_action(scores, self._empty_query_mask(target2d, mask))
        if self.empty_target_action == "skip" and scores.shape[0] == 0:
            return torch.zeros((), device=scores.device)
        return _retrieval_aggregate(scores, self.aggregation)
