"""Equal error rate metric classes (counterpart of ``torchmetrics_tpu/classification/eer.py``):
the precision-recall curve classes' states, reduced to the EER of each curve."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.eer import _binary_eer_compute, _multiclass_eer_compute, _multilabel_eer_compute
from ..functional.classification.stat_scores import _check_task_args
from ..metric import Metric
from ..utilities.enums import ClassificationTask
from .base import _ClassificationTaskWrapper, _plot_value
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    Thresholds,
)


class BinaryEER(BinaryPrecisionRecallCurve):
    """Binary equal error rate.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryEER
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryEER(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.)
    """

    plot = _plot_value

    higher_is_better = False
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return _binary_eer_compute(*self._curve_state(state))


class MulticlassEER(MulticlassPrecisionRecallCurve):
    """Multiclass equal error rate, one-vs-rest per class (``average`` "micro" or
    "macro": of one curve; "micro" keeps the flattened problem's state).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassEER
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassEER(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([0., 0., 0.])
    """

    plot = _plot_value

    higher_is_better = False
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def __init__(
        self, num_classes: int, average: Optional[str] = None, thresholds: Thresholds = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        if average not in (None, "none", "micro", "macro"):
            raise ValueError(f"Expected argument `average` to be one of None, 'micro' or 'macro', but got {average}")
        super().__init__(num_classes=num_classes, thresholds=thresholds, average=average if average == "micro" else None,
                         ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.average = average

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multiclass_eer_compute(curve_state, self.num_classes, thresholds, self.average)


class MultilabelEER(MultilabelPrecisionRecallCurve):
    """Multilabel equal error rate, per label.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelEER
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelEER(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([0.0000, 0.7500, 0.0000])
    """

    plot = _plot_value

    higher_is_better = False
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multilabel_eer_compute(curve_state, self.num_labels, thresholds, self.ignore_index)


class EER(_ClassificationTaskWrapper):
    """Task facade over the three equal error rates.

    Example:
        >>> from torchmetrics_tpu_torch.classification import EER
        >>> type(EER(task="multiclass", num_classes=3, average="macro", device="cpu")).__name__
        'MulticlassEER'
    """

    def __new__(
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        _check_task_args(task, num_classes, num_labels)
        kwargs.update(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args)
        if task == ClassificationTask.BINARY:
            return BinaryEER(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassEER(num_classes, average=average, **kwargs)
        return MultilabelEER(num_labels, **kwargs)
