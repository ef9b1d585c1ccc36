"""Factories for the stat-scores family's functional entry points (counterpart of
``torchmetrics_tpu/functional/classification/_family.py``).

One factory per task builds the ``binary_*``/``multiclass_*``/``multilabel_*`` function
of a metric from its reduce callback, with the JAX package's signatures and argument
order; ``make_task_dispatch`` builds the task-dispatch function over the three.
"""

from __future__ import annotations

from typing import Callable, Optional

from ...utilities.checks import _as_tensor
from ...utilities.enums import ClassificationTask
from .stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _check_task_args,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)

# reduce signature: (tp, fp, tn, fn, average, multidim_average, multilabel, top_k, zero_division) -> Tensor


def _named(fn: Callable, name: str) -> Callable:
    fn.__name__ = name
    fn.__qualname__ = name
    return fn


def make_binary(reduce: Callable, name: str, support_zero_division: bool = True) -> Callable:
    def fn(
        preds,
        target,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
    ):
        preds, target = _as_tensor(preds), _as_tensor(target)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index, zero_division)
            _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
        preds, target, w = _binary_stat_scores_format(preds, target, threshold, ignore_index)
        tp, fp, tn, fn_ = _binary_stat_scores_update(preds, target, w, multidim_average)
        return reduce(tp, fp, tn, fn_, "binary", multidim_average, False, 1, zero_division)

    return _named(fn, name)


def make_multiclass(reduce: Callable, name: str, default_average: str = "macro") -> Callable:
    def fn(
        preds,
        target,
        num_classes: int,
        average: Optional[str] = default_average,
        top_k: int = 1,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
    ):
        preds, target = _as_tensor(preds), _as_tensor(target)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index, zero_division)
            _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
        preds_oh, target, w = _multiclass_stat_scores_format(preds, target, num_classes, top_k, ignore_index)
        tp, fp, tn, fn_ = _multiclass_stat_scores_update(preds_oh, target, w, num_classes, multidim_average)
        return reduce(tp, fp, tn, fn_, average, multidim_average, False, top_k, zero_division)

    return _named(fn, name)


def make_multilabel(reduce: Callable, name: str, default_average: str = "macro") -> Callable:
    def fn(
        preds,
        target,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = default_average,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
    ):
        preds, target = _as_tensor(preds), _as_tensor(target)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index, zero_division)
            _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
        preds, target, w = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
        tp, fp, tn, fn_ = _multilabel_stat_scores_update(preds, target, w, multidim_average)
        return reduce(tp, fp, tn, fn_, average, multidim_average, True, 1, zero_division)

    return _named(fn, name)


def make_task_dispatch(binary_fn: Callable, multiclass_fn: Callable, multilabel_fn: Callable, name: str) -> Callable:
    def fn(
        preds,
        target,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: Optional[str] = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
    ):
        task = ClassificationTask.from_str(task)
        _check_task_args(task, num_classes, num_labels, top_k)
        if task == ClassificationTask.BINARY:
            return binary_fn(preds, target, threshold, multidim_average, ignore_index, validate_args, zero_division)
        if task == ClassificationTask.MULTICLASS:
            return multiclass_fn(
                preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, zero_division
            )
        return multilabel_fn(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, zero_division
        )

    return _named(fn, name)
