"""Precision at fixed recall metric classes (counterpart of
``torchmetrics_tpu/classification/precision_fixed_recall.py``): the precision-recall
curve classes' states, reduced to each curve's operating point."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.precision_fixed_recall import (
    _binary_precision_at_fixed_recall_arg_validation,
    _binary_precision_at_fixed_recall_compute,
    _multiclass_precision_at_fixed_recall_arg_validation,
    _multiclass_precision_at_fixed_recall_compute,
    _multilabel_precision_at_fixed_recall_arg_validation,
    _multilabel_precision_at_fixed_recall_compute,
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


class BinaryPrecisionAtFixedRecall(BinaryPrecisionRecallCurve):
    """Binary precision at fixed recall: (precision, threshold).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecisionAtFixedRecall
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryPrecisionAtFixedRecall(min_recall=0.5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        (tensor(1.), tensor(0.7300))
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self, min_recall: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
        validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_precision_at_fixed_recall_arg_validation(min_recall, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_recall = min_recall

    def _compute(self, state):
        return _binary_precision_at_fixed_recall_compute(*self._curve_state(state), self.min_recall)


class MulticlassPrecisionAtFixedRecall(MulticlassPrecisionRecallCurve):
    """Multiclass precision at fixed recall, one-vs-rest: (precisions, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassPrecisionAtFixedRecall
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassPrecisionAtFixedRecall(num_classes=3, min_recall=0.5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        (tensor([1., 1., 1.]), tensor([0.7500, 0.4000, 0.5000]))
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def __init__(
        self, num_classes: int, min_recall: float, thresholds: Thresholds = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multiclass_precision_at_fixed_recall_arg_validation(num_classes, min_recall, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_recall = min_recall

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multiclass_precision_at_fixed_recall_compute(curve_state, self.num_classes, thresholds,
                                                             self.min_recall)


class MultilabelPrecisionAtFixedRecall(MultilabelPrecisionRecallCurve):
    """Multilabel precision at fixed recall: (precisions, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelPrecisionAtFixedRecall
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelPrecisionAtFixedRecall(num_labels=3, min_recall=0.5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        (tensor([1.0000, 0.5000, 1.0000]), tensor([0.7500, 0.6500, 0.3500]))
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def __init__(
        self, num_labels: int, min_recall: float, thresholds: Thresholds = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multilabel_precision_at_fixed_recall_arg_validation(num_labels, min_recall, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_recall = min_recall

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multilabel_precision_at_fixed_recall_compute(curve_state, self.num_labels, thresholds,
                                                             self.ignore_index, self.min_recall)


class PrecisionAtFixedRecall(_ClassificationTaskWrapper):
    """Task facade over the three precisions at fixed recall.

    Example:
        >>> from torchmetrics_tpu_torch.classification import PrecisionAtFixedRecall
        >>> type(PrecisionAtFixedRecall(task="binary", min_recall=0.5, device="cpu")).__name__
        'BinaryPrecisionAtFixedRecall'
    """

    def __new__(
        cls,
        task: str,
        min_recall: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        classes = (BinaryPrecisionAtFixedRecall, MulticlassPrecisionAtFixedRecall, MultilabelPrecisionAtFixedRecall)
        return _new_curve_metric(classes, task, num_classes, num_labels, binary_args=(min_recall,),
                                 class_args=(min_recall,), thresholds=thresholds, ignore_index=ignore_index,
                                 validate_args=validate_args, **kwargs)
