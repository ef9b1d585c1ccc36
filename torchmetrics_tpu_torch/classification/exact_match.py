"""Exact match metric classes (counterpart of
``torchmetrics_tpu/classification/exact_match.py``): int32 ``correct`` and ``total``
states, summed (global) or concatenated per sample (samplewise)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_update,
)
from ..functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_tensor_validation,
)
from ..metric import Metric
from ..utilities.enums import ClassificationTaskNoBinary
from .base import _ClassificationTaskWrapper


class _ExactMatchBase(Metric):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _create_state(self, multidim_average: str) -> None:
        if multidim_average == "samplewise":
            self.add_state("correct", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("correct", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _compute(self, state):
        return _exact_match_reduce(state["correct"], state["total"])


class MulticlassExactMatch(_ExactMatchBase):
    """Multiclass exact match.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassExactMatch
        >>> metric = MulticlassExactMatch(num_classes=3, multidim_average="samplewise", device="cpu")
        >>> metric.update(torch.tensor([[0, 1, 2], [1, 1, 2]]), torch.tensor([[0, 1, 2], [2, 1, 2]]))
        >>> metric.compute()
        tensor([1., 0.])
    """

    def __init__(
        self,
        num_classes: int,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, self.multidim_average,
                                                      self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        correct, total = _multiclass_exact_match_update(preds, target, self.multidim_average, self.ignore_index)
        return {"correct": correct, "total": total}


class MultilabelExactMatch(_ExactMatchBase):
    """Multilabel exact match.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelExactMatch
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelExactMatch(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.3333)
    """

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(preds, target, self.num_labels, self.multidim_average,
                                                      self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        correct, total = _multilabel_exact_match_update(
            preds, target, self.num_labels, self.threshold, self.multidim_average, self.ignore_index
        )
        return {"correct": correct, "total": total}


class ExactMatch(_ClassificationTaskWrapper):
    """Task facade (multiclass or multilabel).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import ExactMatch
        >>> metric = ExactMatch(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0, 1, 2], [1, 1, 2]]), torch.tensor([[0, 1, 2], [2, 1, 2]]))
        >>> metric.compute()
        tensor(0.5000)
    """

    def __new__(
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoBinary.from_str(task)
        kwargs.update(multidim_average=multidim_average, ignore_index=ignore_index, validate_args=validate_args)
        if task == ClassificationTaskNoBinary.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassExactMatch(num_classes, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return MultilabelExactMatch(num_labels, threshold, **kwargs)
