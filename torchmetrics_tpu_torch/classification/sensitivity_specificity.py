"""Sensitivity at specificity metric classes (counterpart of
``torchmetrics_tpu/classification/sensitivity_specificity.py``): the precision-recall
curve classes' states (their ROC curves), reduced to each curve's operating point."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.recall_fixed_precision import _validate_min
from ..functional.classification.sensitivity_specificity import (
    _binary_sensitivity_at_specificity_compute,
    _multiclass_sensitivity_at_specificity_compute,
    _multilabel_sensitivity_at_specificity_compute,
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


class BinarySensitivityAtSpecificity(BinaryPrecisionRecallCurve):
    """Binary sensitivity at specificity: (sensitivity, threshold).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinarySensitivityAtSpecificity
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinarySensitivityAtSpecificity(min_specificity=0.5, device="cpu")
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
        self, min_specificity: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
        validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _validate_min("min_specificity", min_specificity)
        self.validate_args = validate_args
        self.min_specificity = min_specificity

    def _compute(self, state):
        return _binary_sensitivity_at_specificity_compute(*self._curve_state(state), self.min_specificity)


class MulticlassSensitivityAtSpecificity(MulticlassPrecisionRecallCurve):
    """Multiclass sensitivity at specificity, one-vs-rest: (sensitivities, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassSensitivityAtSpecificity
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassSensitivityAtSpecificity(num_classes=3, min_specificity=0.5, device="cpu")
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
        self, num_classes: int, min_specificity: float, thresholds: Thresholds = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _validate_min("min_specificity", min_specificity)
        self.validate_args = validate_args
        self.min_specificity = min_specificity

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multiclass_sensitivity_at_specificity_compute(curve_state, self.num_classes, thresholds,
                                                             self.min_specificity)


class MultilabelSensitivityAtSpecificity(MultilabelPrecisionRecallCurve):
    """Multilabel sensitivity at specificity: (sensitivities, thresholds).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelSensitivityAtSpecificity
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelSensitivityAtSpecificity(num_labels=3, min_specificity=0.5, device="cpu")
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
        self, num_labels: int, min_specificity: float, thresholds: Thresholds = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _validate_min("min_specificity", min_specificity)
        self.validate_args = validate_args
        self.min_specificity = min_specificity

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multilabel_sensitivity_at_specificity_compute(curve_state, self.num_labels, thresholds,
                                                             self.ignore_index, self.min_specificity)


class SensitivityAtSpecificity(_ClassificationTaskWrapper):
    """Task facade over the three sensitivities at specificity.

    Example:
        >>> from torchmetrics_tpu_torch.classification import SensitivityAtSpecificity
        >>> type(SensitivityAtSpecificity(task="binary", min_specificity=0.5, device="cpu")).__name__
        'BinarySensitivityAtSpecificity'
    """

    def __new__(
        cls,
        task: str,
        min_specificity: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        classes = (BinarySensitivityAtSpecificity, MulticlassSensitivityAtSpecificity, MultilabelSensitivityAtSpecificity)
        return _new_curve_metric(classes, task, num_classes, num_labels, binary_args=(min_specificity,),
                                 class_args=(min_specificity,), thresholds=thresholds, ignore_index=ignore_index,
                                 validate_args=validate_args, **kwargs)
