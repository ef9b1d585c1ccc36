"""LogAUC metric classes (counterpart of ``torchmetrics_tpu/classification/logauc.py``): the
precision-recall curve classes' states, reduced to the LogAUC of each ROC curve."""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..functional.classification.logauc import (
    _binary_logauc_compute,
    _multiclass_logauc_compute,
    _multilabel_logauc_compute,
    _validate_fpr_range,
)
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

FprRange = Tuple[float, float]


class BinaryLogAUC(BinaryPrecisionRecallCurve):
    """Binary LogAUC: the ROC curve's area over a log-scaled false positive range.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryLogAUC
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryLogAUC(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self, fpr_range: FprRange = (0.001, 0.1), thresholds: Thresholds = None, ignore_index: Optional[int] = None,
        validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_fpr_range(fpr_range)
        self.fpr_range = fpr_range

    def _compute(self, state):
        return _binary_logauc_compute(*self._curve_state(state), self.fpr_range)


class MulticlassLogAUC(MulticlassPrecisionRecallCurve):
    """Multiclass LogAUC, one-vs-rest per class, then ``average`` ("macro" or None).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassLogAUC
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassLogAUC(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def __init__(
        self, num_classes: int, fpr_range: FprRange = (0.001, 0.1), average: Optional[str] = "macro",
        thresholds: Thresholds = None, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, average=None, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_fpr_range(fpr_range)
        self.fpr_range = fpr_range
        self.average = average

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multiclass_logauc_compute(curve_state, self.num_classes, thresholds, self.fpr_range, self.average)


class MultilabelLogAUC(MultilabelPrecisionRecallCurve):
    """Multilabel LogAUC, per label, then ``average`` ("macro" or None).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelLogAUC
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelLogAUC(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6667)
    """

    plot = _plot_value

    higher_is_better = True
    _jittable_compute = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def __init__(
        self, num_labels: int, fpr_range: FprRange = (0.001, 0.1), average: Optional[str] = "macro",
        thresholds: Thresholds = None, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_fpr_range(fpr_range)
        self.fpr_range = fpr_range
        self.average = average

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multilabel_logauc_compute(curve_state, self.num_labels, thresholds, self.fpr_range, self.average,
                                          self.ignore_index)


class LogAUC(_ClassificationTaskWrapper):
    """Task facade over the three LogAUCs.

    Example:
        >>> from torchmetrics_tpu_torch.classification import LogAUC
        >>> type(LogAUC(task="multilabel", num_labels=3, device="cpu")).__name__
        'MultilabelLogAUC'
    """

    def __new__(
        cls,
        task: str,
        thresholds: Thresholds = None,
        fpr_range: FprRange = (0.001, 0.1),
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        _check_task_args(task, num_classes, num_labels)
        kwargs.update(thresholds=thresholds, fpr_range=fpr_range, ignore_index=ignore_index,
                      validate_args=validate_args)
        if task == ClassificationTask.BINARY:
            return BinaryLogAUC(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassLogAUC(num_classes, average=average, **kwargs)
        return MultilabelLogAUC(num_labels, average=average, **kwargs)
