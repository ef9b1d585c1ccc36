"""AUROC metric classes (counterpart of ``torchmetrics_tpu/classification/auroc.py``):
the precision-recall curve classes' states with the ROC area as their compute. The
multiclass curve state is never micro-flattened; ``average`` is the areas' reduction."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.auroc import (
    _binary_auroc_arg_validation,
    _binary_auroc_compute,
    _multiclass_auroc_arg_validation,
    _multiclass_auroc_compute,
    _multilabel_auroc_arg_validation,
    _multilabel_auroc_compute,
)
from ..metric import Metric
from .base import _ClassificationTaskWrapper, _plot_value
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    Thresholds,
    _new_curve_metric,
)


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Binary AUROC (``max_fpr``: the standardised partial area up to that rate).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAUROC
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryAUROC(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    plot = _plot_value
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        self.validate_args = validate_args
        self.max_fpr = max_fpr
        self._jittable_compute = max_fpr is None and thresholds is not None

    def _compute(self, state):
        return _binary_auroc_compute(*self._curve_state(state), self.max_fpr)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """Multiclass AUROC, one-vs-rest.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAUROC
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassAUROC(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    plot = _plot_value
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, average=None, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multiclass_auroc_compute(curve_state, self.num_classes, self.average, thresholds)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """Multilabel AUROC.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelAUROC
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelAUROC(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.8333)
    """

    plot = _plot_value
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    higher_is_better = True

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multilabel_auroc_compute(curve_state, self.num_labels, self.average, thresholds, self.ignore_index)


class AUROC(_ClassificationTaskWrapper):
    """Task facade over the three AUROCs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import AUROC
        >>> metric = AUROC(task="binary", device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1]))
        >>> metric.compute()
        tensor(1.)
    """

    def __new__(
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _new_curve_metric((BinaryAUROC, MulticlassAUROC, MultilabelAUROC), task, num_classes, num_labels,
                                 binary_args=(max_fpr,), class_args=(average,), thresholds=thresholds,
                                 ignore_index=ignore_index, validate_args=validate_args, **kwargs)
