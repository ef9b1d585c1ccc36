"""Confusion matrix metric classes (counterpart of
``torchmetrics_tpu/classification/confusion_matrix.py``).

Each class keeps an int32 ``confmat`` state. The binary and multiclass batch counts are
float32 (weighted bincounts): the stateful API casts them back to the int32 state, while
the pure path folds them into it and so holds float32, as in the JAX package. The
multilabel batch counts are int32, so its state stays int32 on both paths.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _confusion_matrix_reduce,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from ..functional.classification.stat_scores import _check_task_args
from ..metric import Metric
from ..utilities.enums import ClassificationTask
from .base import _ClassificationTaskWrapper


class _ConfusionMatrix(Metric):
    """The int32 ``confmat`` state and its normalised compute."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, shape: tuple, ignore_index: Optional[int], normalize: Optional[str], validate_args: bool,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    def _compute(self, state):
        return _confusion_matrix_reduce(state["confmat"], self.normalize)

    def plot(self, val: Any = None, ax: Any = None, add_text: bool = True, labels: Any = None, cmap: Any = None):
        """A heatmap of the matrix (``val``, or ``compute()``). Needs matplotlib."""
        from ..utilities.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels, cmap=cmap)


class BinaryConfusionMatrix(_ConfusionMatrix):
    """Binary confusion matrix (int32 ``(2, 2)`` state, rows = target).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryConfusionMatrix
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryConfusionMatrix(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([[3, 0],
                [0, 3]], dtype=torch.int32)
    """

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        if validate_args:
            _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        super().__init__((2, 2), ignore_index, normalize, validate_args, **kwargs)
        self.threshold = threshold

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _binary_confusion_matrix_format(preds, target, self.threshold, self.ignore_index)
        return {"confmat": _binary_confusion_matrix_update(p, t, w)}


class MulticlassConfusionMatrix(_ConfusionMatrix):
    """Multiclass confusion matrix (int32 ``(C, C)`` state, rows = target).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([[1, 0, 0],
                [0, 2, 0],
                [0, 0, 1]], dtype=torch.int32)
    """

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        if validate_args:
            _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        super().__init__((num_classes, num_classes), ignore_index, normalize, validate_args, **kwargs)
        self.num_classes = num_classes

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _multiclass_confusion_matrix_format(preds, target, self.ignore_index)
        return {"confmat": _multiclass_confusion_matrix_update(p, t, w, self.num_classes)}


class MultilabelConfusionMatrix(_ConfusionMatrix):
    """Multilabel confusion matrix (int32 ``(C, 2, 2)`` state, ``[[tn, fp], [fn, tp]]``
    per label).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelConfusionMatrix
        >>> metric = MultilabelConfusionMatrix(num_labels=2, device="cpu")
        >>> metric.update(torch.tensor([[0.9, 0.2], [0.3, 0.7]]), torch.tensor([[1, 0], [1, 0]]))
        >>> metric.compute()
        tensor([[[0, 0],
                 [1, 1]],
        <BLANKLINE>
                [[1, 1],
                 [0, 0]]], dtype=torch.int32)
    """

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        super().__init__((num_labels, 2, 2), ignore_index, normalize, validate_args, **kwargs)
        self.num_labels = num_labels
        self.threshold = threshold

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multilabel_confusion_matrix_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _multilabel_confusion_matrix_format(preds, target, self.num_labels, self.threshold, self.ignore_index)
        return {"confmat": _multilabel_confusion_matrix_update(p, t, w, self.num_labels)}


class ConfusionMatrix(_ClassificationTaskWrapper):
    """Task facade over the three confusion-matrix classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import ConfusionMatrix
        >>> metric = ConfusionMatrix(task="binary", device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 0]))
        >>> metric.compute()
        tensor([[1, 1],
                [0, 1]], dtype=torch.int32)
    """

    def __new__(
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        _check_task_args(task, num_classes, num_labels)
        kwargs.update(normalize=normalize, ignore_index=ignore_index, validate_args=validate_args)
        if task == ClassificationTask.BINARY:
            return BinaryConfusionMatrix(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassConfusionMatrix(num_classes, **kwargs)
        return MultilabelConfusionMatrix(num_labels, threshold, **kwargs)
