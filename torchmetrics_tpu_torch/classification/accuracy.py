"""Accuracy metric classes (counterpart of ``torchmetrics_tpu/classification/accuracy.py``)."""

from __future__ import annotations

from ..functional.classification.accuracy import _accuracy_reduce
from .base import _ClassificationTaskWrapper, _task_facade_new
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores


class BinaryAccuracy(BinaryStatScores):
    """Binary accuracy.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryAccuracy(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return _accuracy_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"], average="binary", multidim_average=self.multidim_average
        )


class MulticlassAccuracy(MulticlassStatScores):
    """Multiclass accuracy.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassAccuracy(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def _compute(self, state):
        return _accuracy_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, top_k=self.top_k,
        )


class MultilabelAccuracy(MultilabelStatScores):
    """Multilabel accuracy.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelAccuracy
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelAccuracy(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.7778)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def _compute(self, state):
        return _accuracy_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, multilabel=True,
        )


class Accuracy(_ClassificationTaskWrapper):
    """Task facade: ``average`` defaults to ``"micro"`` here, to ``"macro"`` in the
    multiclass and multilabel classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import Accuracy
        >>> metric = Accuracy(task="multiclass", num_classes=3, device="cpu")
        >>> metric(torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.3, 0.6]]), torch.tensor([0, 1]))
        tensor(0.5000)
    """

    __new__ = _task_facade_new(BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy)
