"""StatScores metric classes (counterpart of
``torchmetrics_tpu/classification/stat_scores.py``).

``multidim_average="global"`` keeps sum-reduced int32 tp/fp/tn/fn states;
``"samplewise"`` keeps concat list states. Accuracy, precision, recall, F-beta,
specificity, NPV and hamming subclass these and override only ``_compute``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from ..metric import Metric
from .base import _ClassificationTaskWrapper, _task_facade_new


class _AbstractStatScores(Metric):
    """Creates the tp/fp/tn/fn states."""

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        for name in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(name, default=[], dist_reduce_fx="cat")
            else:
                shape = () if size == 1 else (size,)
                self.add_state(name, default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    @staticmethod
    def _stats(tp, fp, tn, fn) -> dict:
        return {"tp": tp, "fp": fp, "tn": tn, "fn": fn}


class BinaryStatScores(_AbstractStatScores):
    """tp/fp/tn/fn/support for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryStatScores
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryStatScores(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([3, 0, 3, 0, 3], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index, zero_division)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.zero_division = zero_division
        self._create_state(size=1, multidim_average=multidim_average)

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, self.multidim_average, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        return self._stats(*_binary_stat_scores_update(p, t, w, self.multidim_average))

    def _compute(self, state):
        return _binary_stat_scores_compute(state["tp"], state["fp"], state["tn"], state["fn"], self.multidim_average)


class MulticlassStatScores(_AbstractStatScores):
    """tp/fp/tn/fn/support for multiclass tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassStatScores
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassStatScores(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([1.3333, 0.0000, 2.6667, 0.0000, 1.3333])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index, zero_division)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.zero_division = zero_division
        self._create_state(size=num_classes, multidim_average=multidim_average)

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, self.multidim_average, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p_oh, t, w = _multiclass_stat_scores_format(preds, target, self.num_classes, self.top_k, self.ignore_index)
        return self._stats(*_multiclass_stat_scores_update(p_oh, t, w, self.num_classes, self.multidim_average))

    def _compute(self, state):
        return _multiclass_stat_scores_compute(
            state["tp"], state["fp"], state["tn"], state["fn"], self.average, self.multidim_average
        )


class MultilabelStatScores(_AbstractStatScores):
    """tp/fp/tn/fn/support for multilabel tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelStatScores
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelStatScores(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([1.0000, 0.3333, 1.3333, 0.3333, 1.3333])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index, zero_division)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.zero_division = zero_division
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(preds, target, self.num_labels, self.multidim_average, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _multilabel_stat_scores_format(preds, target, self.num_labels, self.threshold, self.ignore_index)
        return self._stats(*_multilabel_stat_scores_update(p, t, w, self.multidim_average))

    def _compute(self, state):
        return _multilabel_stat_scores_compute(
            state["tp"], state["fp"], state["tn"], state["fn"], self.average, self.multidim_average
        )


class StatScores(_ClassificationTaskWrapper):
    """Task facade over the three stat-scores classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import StatScores
        >>> metric = StatScores(task="binary", device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 0]))
        tensor([1, 1, 1, 0, 1], dtype=torch.int32)
    """

    __new__ = _task_facade_new(BinaryStatScores, MulticlassStatScores, MultilabelStatScores)
