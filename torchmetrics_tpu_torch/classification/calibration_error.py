"""Calibration error metric classes (counterpart of
``torchmetrics_tpu/classification/calibration_error.py``): the states are the three
``(n_bins + 1,)`` float32 bin sums, sum-reduced."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.classification.calibration_error import (
    _binary_calibration_error_arg_validation,
    _binary_calibration_error_format,
    _binary_calibration_error_tensor_validation,
    _binned_stats_update,
    _ce_compute_from_bins,
    _multiclass_calibration_error_arg_validation,
    _multiclass_calibration_error_format,
    _multiclass_calibration_error_update,
)
from ..functional.classification.stat_scores import _multiclass_stat_scores_tensor_validation
from ..metric import Metric
from ..utilities.enums import ClassificationTaskNoMultilabel
from .base import _ClassificationTaskWrapper


class _CalibrationBase(Metric):
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _create_state(self, n_bins: int) -> None:
        for name in ("conf_bin", "acc_bin", "count_bin"):
            self.add_state(name, default=torch.zeros(n_bins + 1, dtype=torch.float32), dist_reduce_fx="sum")

    def _compute(self, state):
        return _ce_compute_from_bins(state["conf_bin"], state["acc_bin"], state["count_bin"], self.norm)


class BinaryCalibrationError(_CalibrationBase):
    """Binary calibration error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryCalibrationError
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryCalibrationError(n_bins=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.1950)
    """

    def __init__(
        self, n_bins: int = 15, norm: str = "l1", ignore_index: Optional[int] = None, validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(n_bins)

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _binary_calibration_error_tensor_validation(preds, target, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _binary_calibration_error_format(preds, target, self.ignore_index)
        conf, acc, count = _binned_stats_update(p, t, self.n_bins, w)
        return {"conf_bin": conf, "acc_bin": acc, "count_bin": count}


class MulticlassCalibrationError(_CalibrationBase):
    """Multiclass calibration error of the top-label confidence.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassCalibrationError
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassCalibrationError(num_classes=3, n_bins=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.3875)
    """

    def __init__(
        self, num_classes: int, n_bins: int = 15, norm: str = "l1", ignore_index: Optional[int] = None,
        validate_args: bool = True, **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        self.num_classes = num_classes
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(n_bins)

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, "global", self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _multiclass_calibration_error_format(preds, target, self.num_classes, self.ignore_index)
        confidences, accuracies = _multiclass_calibration_error_update(p, t)
        conf, acc, count = _binned_stats_update(confidences, accuracies, self.n_bins, w)
        return {"conf_bin": conf, "acc_bin": acc, "count_bin": count}


class CalibrationError(_ClassificationTaskWrapper):
    """Task facade over the binary and multiclass calibration errors.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import CalibrationError
        >>> metric = CalibrationError(task="binary", n_bins=3, device="cpu")
        >>> type(metric).__name__
        'BinaryCalibrationError'
    """

    def __new__(
        cls,
        task: str,
        n_bins: int = 15,
        norm: str = "l1",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCalibrationError(**kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return MulticlassCalibrationError(num_classes, **kwargs)
