"""Jaccard index metric classes (counterpart of
``torchmetrics_tpu/classification/jaccard.py``): the confusion-matrix classes with the
Jaccard reduction as their compute."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.jaccard import _jaccard_index_reduce
from ..functional.classification.stat_scores import _check_task_args
from ..metric import Metric
from ..utilities.enums import ClassificationTask
from .base import _ClassificationTaskWrapper, _plot_value
from .confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix, MultilabelConfusionMatrix

_AVERAGES = ("micro", "macro", "weighted", "none", None)


def _check_average(average: Optional[str]) -> None:
    if average not in _AVERAGES:
        raise ValueError(f"Expected argument `average` to be one of {_AVERAGES} but got {average}")


class BinaryJaccardIndex(BinaryConfusionMatrix):
    """Binary Jaccard index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryJaccardIndex
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryJaccardIndex(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    plot = _plot_value
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        self.zero_division = zero_division

    def _compute(self, state):
        return _jaccard_index_reduce(state["confmat"], average="binary", zero_division=self.zero_division)


class MulticlassJaccardIndex(MulticlassConfusionMatrix):
    """Multiclass Jaccard index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassJaccardIndex
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassJaccardIndex(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    plot = _plot_value
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        if validate_args:
            _check_average(average)
        self.average = average
        self.zero_division = zero_division

    def _compute(self, state):
        return _jaccard_index_reduce(state["confmat"], self.average, self.ignore_index, self.zero_division)


class MultilabelJaccardIndex(MultilabelConfusionMatrix):
    """Multilabel Jaccard index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelJaccardIndex
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelJaccardIndex(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6667)
    """

    plot = _plot_value
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        if validate_args:
            _check_average(average)
        self.average = average
        self.zero_division = zero_division

    def _compute(self, state):
        return _jaccard_index_reduce(state["confmat"], self.average, zero_division=self.zero_division)


class JaccardIndex(_ClassificationTaskWrapper):
    """Task facade over the three Jaccard indices.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import JaccardIndex
        >>> metric = JaccardIndex(task="binary", device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1]))
        >>> metric.compute()
        tensor(1.)
    """

    def __new__(
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        _check_task_args(task, num_classes, num_labels)
        kwargs.update(ignore_index=ignore_index, validate_args=validate_args, zero_division=zero_division)
        if task == ClassificationTask.BINARY:
            return BinaryJaccardIndex(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassJaccardIndex(num_classes, average, **kwargs)
        return MultilabelJaccardIndex(num_labels, threshold, average, **kwargs)
