"""Task facades (counterpart of ``torchmetrics_tpu/classification/base.py``): classes
whose ``__new__`` returns the binary, multiclass or multilabel metric that ``task``
names, e.g. ``Accuracy(task="multiclass", num_classes=5)`` a ``MulticlassAccuracy``."""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..functional.classification.stat_scores import _check_task_args
from ..metric import Metric
from ..utilities.enums import ClassificationTask


def _plot_value(self: Metric, val: Any = None, ax: Any = None):
    """``Metric.plot`` for a score metric built on a curve's or a confusion matrix's
    states, whose own ``plot`` would draw the curve or the matrix."""
    return Metric.plot(self, *([val] if val is not None else []), ax=ax)


class _ClassificationTaskWrapper:
    """Base of the task facades; a facade itself is never instantiated."""

    def __new__(cls: type, *args: Any, **kwargs: Any) -> Metric:
        raise NotImplementedError(f"`{cls.__name__}` is a factory class; it cannot be instantiated directly.")


def _new_task_metric(
    classes: tuple,
    task: str,
    threshold: float,
    num_classes: Optional[int],
    num_labels: Optional[int],
    average: Optional[str],
    top_k: Optional[int],
    *leading: Any,
    **kwargs: Any,
) -> Metric:
    """The metric of ``classes = (binary, multiclass, multilabel)`` that ``task`` names,
    built with ``leading`` arguments (F-beta's ``beta``) before the task's own."""
    binary, multiclass, multilabel = classes
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels, top_k)
    if task == ClassificationTask.BINARY:
        return binary(*leading, threshold, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        return multiclass(*leading, num_classes, top_k, average, **kwargs)
    return multilabel(*leading, num_labels, threshold, average, **kwargs)


def _task_facade_new(binary: type, multiclass: type, multilabel: type) -> Callable:
    """``__new__`` of a facade over three stat-scores classes."""

    def __new__(
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update(multidim_average=multidim_average, ignore_index=ignore_index, validate_args=validate_args)
        return _new_task_metric((binary, multiclass, multilabel), task, threshold, num_classes, num_labels, average,
                                top_k, **kwargs)

    return __new__
