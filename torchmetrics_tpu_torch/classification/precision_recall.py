"""Precision and recall metric classes (counterpart of
``torchmetrics_tpu/classification/precision_recall.py``)."""

from __future__ import annotations

from ..functional.classification.precision_recall import _precision_recall_reduce
from .base import _ClassificationTaskWrapper, _task_facade_new
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores


class _PrecisionRecallMixin:
    _stat: str  # "precision" or "recall"
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0


class BinaryPrecision(_PrecisionRecallMixin, BinaryStatScores):
    """Binary precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecision
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryPrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    _stat = "precision"

    def _compute(self, state):
        return _precision_recall_reduce(
            self._stat, state["tp"], state["fp"], state["tn"], state["fn"],
            average="binary", multidim_average=self.multidim_average, zero_division=self.zero_division,
        )


class BinaryRecall(BinaryPrecision):
    """Binary recall.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryRecall
        >>> metric = BinaryRecall(device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 1]))
        tensor(0.6667)
    """

    _stat = "recall"


class MulticlassPrecision(_PrecisionRecallMixin, MulticlassStatScores):
    """Multiclass precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassPrecision
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassPrecision(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    _stat = "precision"
    plot_legend_name = "Class"

    def _compute(self, state):
        return _precision_recall_reduce(
            self._stat, state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, top_k=self.top_k,
            zero_division=self.zero_division,
        )


class MulticlassRecall(MulticlassPrecision):
    """Multiclass recall.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassRecall
        >>> metric = MulticlassRecall(num_classes=3, device="cpu")
        >>> metric(torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.3, 0.6]]), torch.tensor([0, 1]))
        tensor(0.3333)
    """

    _stat = "recall"


class MultilabelPrecision(_PrecisionRecallMixin, MultilabelStatScores):
    """Multilabel precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelPrecision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelPrecision(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.8333)
    """

    _stat = "precision"
    plot_legend_name = "Label"

    def _compute(self, state):
        return _precision_recall_reduce(
            self._stat, state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, multilabel=True,
            zero_division=self.zero_division,
        )


class MultilabelRecall(MultilabelPrecision):
    """Multilabel recall.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelRecall
        >>> metric = MultilabelRecall(num_labels=2, device="cpu")
        >>> metric(torch.tensor([[0.9, 0.2], [0.6, 0.7]]), torch.tensor([[1, 1], [1, 1]]))
        tensor(0.7500)
    """

    _stat = "recall"


class Precision(_ClassificationTaskWrapper):
    """Task facade over the three precision classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import Precision
        >>> metric = Precision(task="binary", device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 0]))
        tensor(0.5000)
    """

    __new__ = _task_facade_new(BinaryPrecision, MulticlassPrecision, MultilabelPrecision)


class Recall(_ClassificationTaskWrapper):
    """Task facade over the three recall classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import Recall
        >>> metric = Recall(task="multilabel", num_labels=2, device="cpu")
        >>> metric(torch.tensor([[0.9, 0.2], [0.6, 0.7]]), torch.tensor([[1, 1], [1, 1]]))
        tensor(0.7500)
    """

    __new__ = _task_facade_new(BinaryRecall, MulticlassRecall, MultilabelRecall)
