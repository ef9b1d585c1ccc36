"""Matthews correlation coefficient metric classes (counterpart of
``torchmetrics_tpu/classification/matthews_corrcoef.py``): the confusion-matrix classes
with the MCC reduction (float64 on the metric's device) as their compute."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce
from ..functional.classification.stat_scores import _check_task_args
from ..metric import Metric
from ..utilities.enums import ClassificationTask
from .base import _ClassificationTaskWrapper, _plot_value
from .confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix, MultilabelConfusionMatrix


class _MCCCompute:
    is_differentiable = False
    higher_is_better = True
    _jittable_compute = False  # as in the JAX package, whose edge cases run on the host
    plot = _plot_value

    def _compute(self, state):
        return _matthews_corrcoef_reduce(state["confmat"])


class BinaryMatthewsCorrCoef(_MCCCompute, BinaryConfusionMatrix):
    """Binary MCC.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryMatthewsCorrCoef
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryMatthewsCorrCoef(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(
        self, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)


class MulticlassMatthewsCorrCoef(_MCCCompute, MulticlassConfusionMatrix):
    """Multiclass MCC.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassMatthewsCorrCoef
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassMatthewsCorrCoef(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(
        self, num_classes: int, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)


class MultilabelMatthewsCorrCoef(_MCCCompute, MultilabelConfusionMatrix):
    """Multilabel MCC.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelMatthewsCorrCoef
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelMatthewsCorrCoef(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.5500)
    """

    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)


class MatthewsCorrCoef(_ClassificationTaskWrapper):
    """Task facade over the three MCCs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MatthewsCorrCoef
        >>> metric = MatthewsCorrCoef(task="binary", device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.1]), torch.tensor([0, 1, 1, 1]))
        >>> metric.compute()
        tensor(0.5774)
    """

    def __new__(
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        _check_task_args(task, num_classes, num_labels)
        kwargs.update(ignore_index=ignore_index, validate_args=validate_args)
        if task == ClassificationTask.BINARY:
            return BinaryMatthewsCorrCoef(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassMatthewsCorrCoef(num_classes, **kwargs)
        return MultilabelMatthewsCorrCoef(num_labels, threshold, **kwargs)
