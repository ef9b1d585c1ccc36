"""Precision-recall curve metric classes, the state holders of the curve family
(counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``).

``thresholds=None`` keeps ``cat`` lists of the raw scores and targets (the exact curve,
sorted at compute); with ``thresholds`` the state is one sum-reduced int32 confusion
tensor, ``(T, 2, 2)`` or ``(T, C, 2, 2)``, updated without a per-threshold mask. The
thresholds are float32, held as numpy and on the metric's device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch

from ..functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _filter_ignored,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from ..functional.classification.stat_scores import _check_task_args
from ..metric import Metric
from ..utilities.enums import ClassificationTask
from .base import _ClassificationTaskWrapper

Thresholds = Optional[Union[int, List[float], torch.Tensor]]


class _CurveStates(Metric):
    """The two state families. A binned metric's thresholds are held twice: as float32
    numpy in ``thresholds`` (the JAX package's type, which the AOT key fingerprints by
    content) and on the states' device in ``_thresholds_dev``, which the programs read,
    so an update reads nothing back."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def _create_state(self, thresholds: Thresholds, shape: tuple) -> None:
        """``shape``: the binned state's shape after its thresholds axis."""
        host = _adjust_threshold_arg(thresholds, torch.device("cpu"))
        self.thresholds = None if host is None else host.numpy()
        self._thresholds_dev = None if host is None else host.to(self.device)
        if self.thresholds is None:
            self._jittable_compute = False
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("confmat", default=torch.zeros((len(self.thresholds), *shape), dtype=torch.int32),
                           dist_reduce_fx="sum")

    def to(self, device):
        super().to(device)
        if self._thresholds_dev is not None:
            self._thresholds_dev = self._thresholds_dev.to(self.device)
        return self

    _plot_axes = ("Recall", "Precision")

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None):
        """The curve (``curve``, or ``compute()``), titled with ``score`` when given.
        Needs matplotlib."""
        from ..utilities.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=self._plot_axes, name=type(self).__name__)

    def _curve_state(self, state):
        """-> (curve state, thresholds): the (preds, target) pair of the exact path, or
        the binned confusion with the thresholds moved to its device."""
        if self.thresholds is None:
            return (state["preds"], state["target"]), None
        return state["confmat"], self._thresholds_dev.to(state["confmat"].device)


class BinaryPrecisionRecallCurve(_CurveStates):
    """Binary precision-recall curve.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecisionRecallCurve
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryPrecisionRecallCurve(thresholds=5, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        (tensor([0.5000, 0.7500, 1.0000, 1.0000,    nan, 1.0000]), tensor([1.0000, 1.0000, 1.0000, 0.6667, 0.0000, 0.0000]), tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000]))
    """

    def __init__(
        self, thresholds: Thresholds = None, ignore_index: Optional[int] = None, validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(thresholds, (2, 2))

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        if self.thresholds is None and self.ignore_index is not None:
            preds, target = _filter_ignored(preds.reshape(-1), target.reshape(-1), target.reshape(-1) != self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        binned = self.thresholds is not None
        p, t, thresholds, w = _binary_precision_recall_curve_format(
            preds, target, self._thresholds_dev, self.ignore_index if binned else None
        )
        if not binned:
            return {"preds": p, "target": t}
        return {"confmat": _binary_precision_recall_curve_update(p, t, thresholds, w)}

    def _compute(self, state):
        return _binary_precision_recall_curve_compute(*self._curve_state(state))


class MulticlassPrecisionRecallCurve(_CurveStates):
    """Multiclass precision-recall curves, one-vs-rest.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassPrecisionRecallCurve
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassPrecisionRecallCurve(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> precision, recall, thresholds = metric.compute()
        >>> precision[2], recall[2], thresholds[2]
        (tensor([0.2500, 0.3333, 0.5000, 1.0000, 1.0000]), tensor([1., 1., 1., 1., 0.]), tensor([0.1000, 0.2000, 0.3500, 0.5000]))
    """

    plot_legend_name = "Class"

    def __init__(
        self,
        num_classes: int,
        thresholds: Thresholds = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(thresholds, (2, 2) if average == "micro" else (num_classes, 2, 2))

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, thresholds, w = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self._thresholds_dev, self.ignore_index, self.average
        )
        if thresholds is None:
            if self.ignore_index is not None:
                p, t = _filter_ignored(p, t, w)
            return {"preds": p, "target": t}
        return {"confmat": _multiclass_precision_recall_curve_update(p, t, self.num_classes, thresholds, w,
                                                                     self.average)}

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multiclass_precision_recall_curve_compute(curve_state, self.num_classes, thresholds, self.average)


class MultilabelPrecisionRecallCurve(_CurveStates):
    """Multilabel precision-recall curves, one per label.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelPrecisionRecallCurve
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelPrecisionRecallCurve(num_labels=3, thresholds=5, device="cpu")
        >>> metric.update(preds, target)
        >>> precision, recall, thresholds = metric.compute()
        >>> recall
        tensor([[1.0000, 1.0000, 1.0000, 1.0000, 0.0000, 0.0000],
                [1.0000, 1.0000, 1.0000, 0.0000, 0.0000, 0.0000],
                [1.0000, 1.0000, 0.5000, 0.5000, 0.0000, 0.0000]])
    """

    plot_legend_name = "Label"

    def __init__(
        self,
        num_labels: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(thresholds, (num_labels, 2, 2))

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, thresholds, w = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, self._thresholds_dev, self.ignore_index
        )
        if thresholds is None:
            return {"preds": p, "target": t}
        return {"confmat": _multilabel_precision_recall_curve_update(p, t, self.num_labels, thresholds, w)}

    def _compute(self, state):
        curve_state, thresholds = self._curve_state(state)
        return _multilabel_precision_recall_curve_compute(curve_state, self.num_labels, thresholds, self.ignore_index)


def _new_curve_metric(classes: tuple, task: str, num_classes: Optional[int], num_labels: Optional[int],
                      binary_args: tuple = (), class_args: tuple = (), **kwargs: Any) -> Metric:
    """The metric of ``classes = (binary, multiclass, multilabel)`` that ``task`` names;
    ``binary_args`` and ``class_args`` lead the task's own arguments (``max_fpr``, or
    ``average`` after the class count)."""
    binary, multiclass, multilabel = classes
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary(*binary_args, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        return multiclass(num_classes, *class_args, **kwargs)
    return multilabel(num_labels, *class_args, **kwargs)


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task facade over the three precision-recall curves.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import PrecisionRecallCurve
        >>> metric = PrecisionRecallCurve(task="binary", device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1]))
        >>> metric.compute()
        (tensor([0.6667, 1.0000, 1.0000, 1.0000]), tensor([1.0000, 1.0000, 0.5000, 0.0000]), tensor([0.2000, 0.6000, 0.8000]))
    """

    def __new__(
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        classes = (BinaryPrecisionRecallCurve, MulticlassPrecisionRecallCurve, MultilabelPrecisionRecallCurve)
        return _new_curve_metric(classes, task, num_classes, num_labels, thresholds=thresholds,
                                 ignore_index=ignore_index, validate_args=validate_args, **kwargs)
