"""Multilabel ranking metric classes (counterpart of
``torchmetrics_tpu/classification/ranking.py``): each keeps a float32 sum of its
per-sample scores and the sample count, sum-reduced."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.classification.ranking import (
    _multilabel_coverage_error_update,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_format,
    _multilabel_ranking_loss_update,
    _multilabel_ranking_tensor_validation,
    _ranking_reduce,
)
from ..metric import Metric


class _RankingBase(Metric):
    is_differentiable = False
    full_state_update = False

    _update_fn = None  # (preds, target) -> (measure, total)

    def __init__(
        self, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multilabel_ranking_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t = _multilabel_ranking_format(preds, target, self.num_labels, self.ignore_index)
        measure, total = type(self)._update_fn(p, t)
        return {"measure": measure, "total": total}

    def _compute(self, state):
        return _ranking_reduce(state["measure"], state["total"])


class MultilabelCoverageError(_RankingBase):
    """Multilabel coverage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelCoverageError
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelCoverageError(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.3333)
    """

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_RankingBase):
    """Multilabel label ranking average precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelRankingAveragePrecision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelRankingAveragePrecision(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_RankingBase):
    """Multilabel ranking loss.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelRankingLoss
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelRankingLoss(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.)
    """

    higher_is_better = False
    plot_lower_bound = 0.0
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
