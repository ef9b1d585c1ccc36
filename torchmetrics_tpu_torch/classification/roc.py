"""ROC metric classes (counterpart of ``torchmetrics_tpu/classification/roc.py``): the
precision-recall curve classes' states with the ROC as their compute."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.roc import _binary_roc_compute, _multiclass_roc_compute, _multilabel_roc_compute
from ..metric import Metric
from .base import _ClassificationTaskWrapper
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    Thresholds,
    _new_curve_metric,
)


class BinaryROC(BinaryPrecisionRecallCurve):
    """Binary ROC curve: (fpr, tpr, thresholds), thresholds descending.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryROC
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryROC(thresholds=5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        (tensor([0.0000, 0.0000, 0.0000, 0.3333, 1.0000]), tensor([0.0000, 0.6667, 1.0000, 1.0000, 1.0000]), tensor([1.0000, 0.7500, 0.5000, 0.2500, 0.0000]))
    """

    _plot_axes = ("FPR", "TPR")

    def _compute(self, state):
        return _binary_roc_compute(*self._curve_state(state))


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """Multiclass ROC curves, one-vs-rest (``average="micro"``/``"macro"``: one curve).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassROC
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassROC(num_classes=3, thresholds=5, average="macro", device="cpu")
        >>> metric.update(preds, target)
        >>> fpr, tpr, thresholds = metric.compute()
        >>> fpr.shape, float(tpr[-1])
        (torch.Size([15]), 1.0)
    """

    _plot_axes = ("FPR", "TPR")

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multiclass_roc_compute(curve_state, self.num_classes, thresholds, self.average)


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """Multilabel ROC curves, one per label.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelROC
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelROC(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> fpr, tpr, thresholds = metric.compute()
        >>> fpr[0], tpr[0], thresholds[0]
        (tensor([0.0000, 0.0000, 0.5000, 1.0000]), tensor([0., 1., 1., 1.]), tensor([1.0000, 0.7500, 0.4500, 0.0500]))
    """

    _plot_axes = ("FPR", "TPR")

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multilabel_roc_compute(curve_state, self.num_labels, thresholds, self.ignore_index)


class ROC(_ClassificationTaskWrapper):
    """Task facade over the three ROC curves.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import ROC
        >>> metric = ROC(task="binary", device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1]))
        >>> metric.compute()
        (tensor([0., 0., 0., 1.]), tensor([0.0000, 0.5000, 1.0000, 1.0000]), tensor([1.0000, 0.8000, 0.6000, 0.2000]))
    """

    def __new__(
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _new_curve_metric((BinaryROC, MulticlassROC, MultilabelROC), task, num_classes, num_labels,
                                 thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args,
                                 **kwargs)
