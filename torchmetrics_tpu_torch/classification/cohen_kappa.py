"""Cohen's kappa metric classes (counterpart of
``torchmetrics_tpu/classification/cohen_kappa.py``): the binary and multiclass
confusion-matrix classes with the kappa reduction as their compute."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.cohen_kappa import (
    _binary_cohen_kappa_arg_validation,
    _cohen_kappa_reduce,
    _multiclass_cohen_kappa_arg_validation,
)
from ..metric import Metric
from ..utilities.enums import ClassificationTaskNoMultilabel
from .base import _ClassificationTaskWrapper, _plot_value
from .confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix


class BinaryCohenKappa(BinaryConfusionMatrix):
    """Binary Cohen's kappa.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryCohenKappa
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryCohenKappa(device="cpu")
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
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=False, **kwargs)
        if validate_args:
            _binary_cohen_kappa_arg_validation(threshold, ignore_index, weights)
        self.weights = weights
        self.validate_args = validate_args

    def _compute(self, state):
        return _cohen_kappa_reduce(state["confmat"], self.weights)


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    """Multiclass Cohen's kappa.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassCohenKappa
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassCohenKappa(num_classes=3, weights="quadratic", device="cpu")
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
        num_classes: int,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=False, **kwargs)
        if validate_args:
            _multiclass_cohen_kappa_arg_validation(num_classes, ignore_index, weights)
        self.weights = weights
        self.validate_args = validate_args

    def _compute(self, state):
        return _cohen_kappa_reduce(state["confmat"], self.weights)


class CohenKappa(_ClassificationTaskWrapper):
    """Task facade (binary or multiclass).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import CohenKappa
        >>> metric = CohenKappa(task="binary", device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.1]), torch.tensor([0, 1, 1, 1]))
        >>> metric.compute()
        tensor(0.5000)
    """

    def __new__(
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        weights: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update(weights=weights, ignore_index=ignore_index, validate_args=validate_args)
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCohenKappa(threshold, **kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return MulticlassCohenKappa(num_classes, **kwargs)
