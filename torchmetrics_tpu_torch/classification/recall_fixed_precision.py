"""Recall at fixed precision metric classes (counterpart of
``torchmetrics_tpu/classification/recall_fixed_precision.py``): the precision-recall
curve classes' states, reduced to each curve's operating point."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.recall_fixed_precision import (
    _binary_recall_at_fixed_precision_arg_validation,
    _binary_recall_at_fixed_precision_compute,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multiclass_recall_at_fixed_precision_compute,
    _multilabel_recall_at_fixed_precision_arg_validation,
    _multilabel_recall_at_fixed_precision_compute,
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


class BinaryRecallAtFixedPrecision(BinaryPrecisionRecallCurve):
    """Binary recall at fixed precision: (recall, threshold).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryRecallAtFixedPrecision
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryRecallAtFixedPrecision(min_precision=0.5, device="cpu")
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
        self, min_precision: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
        validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_precision = min_precision

    def _compute(self, state):
        return _binary_recall_at_fixed_precision_compute(*self._curve_state(state), self.min_precision)


class MulticlassRecallAtFixedPrecision(MulticlassPrecisionRecallCurve):
    """Multiclass recall at fixed precision, one-vs-rest: (recalls, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassRecallAtFixedPrecision
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassRecallAtFixedPrecision(num_classes=3, min_precision=0.5, device="cpu")
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
        self, num_classes: int, min_precision: float, thresholds: Thresholds = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_precision = min_precision

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multiclass_recall_at_fixed_precision_compute(curve_state, self.num_classes, thresholds,
                                                             self.min_precision)


class MultilabelRecallAtFixedPrecision(MultilabelPrecisionRecallCurve):
    """Multilabel recall at fixed precision: (recalls, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelRecallAtFixedPrecision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelRecallAtFixedPrecision(num_labels=3, min_precision=0.5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        (tensor([1., 1., 1.]), tensor([0.7500, 0.6500, 0.3500]))
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def __init__(
        self, num_labels: int, min_precision: float, thresholds: Thresholds = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_precision = min_precision

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multilabel_recall_at_fixed_precision_compute(curve_state, self.num_labels, thresholds,
                                                             self.ignore_index, self.min_precision)


class RecallAtFixedPrecision(_ClassificationTaskWrapper):
    """Task facade over the three recalls at fixed precision.

    Example:
        >>> from torchmetrics_tpu_torch.classification import RecallAtFixedPrecision
        >>> type(RecallAtFixedPrecision(task="binary", min_precision=0.5, device="cpu")).__name__
        'BinaryRecallAtFixedPrecision'
    """

    def __new__(
        cls,
        task: str,
        min_precision: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        classes = (BinaryRecallAtFixedPrecision, MulticlassRecallAtFixedPrecision, MultilabelRecallAtFixedPrecision)
        return _new_curve_metric(classes, task, num_classes, num_labels, binary_args=(min_precision,),
                                 class_args=(min_precision,), thresholds=thresholds, ignore_index=ignore_index,
                                 validate_args=validate_args, **kwargs)
