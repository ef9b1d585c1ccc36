"""Specificity at sensitivity metric classes (counterpart of
``torchmetrics_tpu/classification/specificity_sensitivity.py``): the precision-recall
curve classes' states (their ROC curves), reduced to each curve's operating point."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.recall_fixed_precision import _validate_min
from ..functional.classification.specificity_sensitivity import (
    _binary_specificity_at_sensitivity_compute,
    _multiclass_specificity_at_sensitivity_compute,
    _multilabel_specificity_at_sensitivity_compute,
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


class BinarySpecificityAtSensitivity(BinaryPrecisionRecallCurve):
    """Binary specificity at sensitivity: (specificity, threshold).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinarySpecificityAtSensitivity
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinarySpecificityAtSensitivity(min_sensitivity=0.5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        (tensor(1.), tensor(0.8400))
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self, min_sensitivity: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
        validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _validate_min("min_sensitivity", min_sensitivity)
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def _compute(self, state):
        return _binary_specificity_at_sensitivity_compute(*self._curve_state(state), self.min_sensitivity)


class MulticlassSpecificityAtSensitivity(MulticlassPrecisionRecallCurve):
    """Multiclass specificity at sensitivity, one-vs-rest: (specificities, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassSpecificityAtSensitivity
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassSpecificityAtSensitivity(num_classes=3, min_sensitivity=0.5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        (tensor([1., 1., 1.]), tensor([0.7500, 0.8000, 0.5000]))
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def __init__(
        self, num_classes: int, min_sensitivity: float, thresholds: Thresholds = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _validate_min("min_sensitivity", min_sensitivity)
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multiclass_specificity_at_sensitivity_compute(curve_state, self.num_classes, thresholds,
                                                             self.min_sensitivity)


class MultilabelSpecificityAtSensitivity(MultilabelPrecisionRecallCurve):
    """Multilabel specificity at sensitivity: (specificities, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelSpecificityAtSensitivity
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelSpecificityAtSensitivity(num_labels=3, min_sensitivity=0.5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        (tensor([1.0000, 0.5000, 1.0000]), tensor([0.7500, 0.6500, 0.7500]))
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def __init__(
        self, num_labels: int, min_sensitivity: float, thresholds: Thresholds = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _validate_min("min_sensitivity", min_sensitivity)
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multilabel_specificity_at_sensitivity_compute(curve_state, self.num_labels, thresholds,
                                                             self.ignore_index, self.min_sensitivity)


class SpecificityAtSensitivity(_ClassificationTaskWrapper):
    """Task facade over the three specificities at sensitivity.

    Example:
        >>> from torchmetrics_tpu_torch.classification import SpecificityAtSensitivity
        >>> type(SpecificityAtSensitivity(task="binary", min_sensitivity=0.5, device="cpu")).__name__
        'BinarySpecificityAtSensitivity'
    """

    def __new__(
        cls,
        task: str,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        classes = (BinarySpecificityAtSensitivity, MulticlassSpecificityAtSensitivity, MultilabelSpecificityAtSensitivity)
        return _new_curve_metric(classes, task, num_classes, num_labels, binary_args=(min_sensitivity,),
                                 class_args=(min_sensitivity,), thresholds=thresholds, ignore_index=ignore_index,
                                 validate_args=validate_args, **kwargs)
