"""Negative predictive value metric classes (counterpart of
``torchmetrics_tpu/classification/negative_predictive_value.py``)."""

from __future__ import annotations

from ..functional.classification.negative_predictive_value import _negative_predictive_value_reduce
from .base import _ClassificationTaskWrapper, _task_facade_new
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores


class BinaryNegativePredictiveValue(BinaryStatScores):
    """Binary negative predictive value.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryNegativePredictiveValue
        >>> metric = BinaryNegativePredictiveValue(device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 0, 1]))
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return _negative_predictive_value_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average="binary", multidim_average=self.multidim_average, zero_division=self.zero_division,
        )


class MulticlassNegativePredictiveValue(MulticlassStatScores):
    """Multiclass negative predictive value.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassNegativePredictiveValue
        >>> metric = MulticlassNegativePredictiveValue(num_classes=3, device="cpu")
        >>> metric(torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.3, 0.6]]), torch.tensor([0, 1]))
        tensor(0.8333)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def _compute(self, state):
        return _negative_predictive_value_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, top_k=self.top_k,
            zero_division=self.zero_division,
        )


class MultilabelNegativePredictiveValue(MultilabelStatScores):
    """Multilabel negative predictive value.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelNegativePredictiveValue
        >>> metric = MultilabelNegativePredictiveValue(num_labels=2, device="cpu")
        >>> metric(torch.tensor([[0.9, 0.2], [0.3, 0.7]]), torch.tensor([[1, 0], [1, 0]]))
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def _compute(self, state):
        return _negative_predictive_value_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, multilabel=True,
            zero_division=self.zero_division,
        )


class NegativePredictiveValue(_ClassificationTaskWrapper):
    """Task facade over the three negative-predictive-value classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import NegativePredictiveValue
        >>> metric = NegativePredictiveValue(task="binary", device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 0, 1]))
        tensor(0.5000)
    """

    __new__ = _task_facade_new(BinaryNegativePredictiveValue, MulticlassNegativePredictiveValue,
                               MultilabelNegativePredictiveValue)
