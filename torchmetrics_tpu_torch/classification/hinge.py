"""Hinge loss metric classes (counterpart of ``torchmetrics_tpu/classification/hinge.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.classification.hinge import (
    _binary_hinge_loss_arg_validation,
    _binary_hinge_loss_format,
    _binary_hinge_loss_tensor_validation,
    _binary_hinge_loss_update,
    _hinge_loss_compute,
    _multiclass_hinge_loss_arg_validation,
    _multiclass_hinge_loss_format,
    _multiclass_hinge_loss_update,
)
from ..functional.classification.stat_scores import _multiclass_stat_scores_tensor_validation
from ..metric import Metric
from ..utilities.enums import ClassificationTaskNoMultilabel
from .base import _ClassificationTaskWrapper


class BinaryHingeLoss(Metric):
    """Binary hinge loss.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryHingeLoss
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryHingeLoss(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6950)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self, squared: bool = False, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_hinge_loss_arg_validation(squared, ignore_index)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measures", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _binary_hinge_loss_tensor_validation(preds, target, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _binary_hinge_loss_format(preds, target, self.ignore_index)
        measures, total = _binary_hinge_loss_update(p, t, self.squared, w)
        return {"measures": measures, "total": total}

    def _compute(self, state):
        return _hinge_loss_compute(state["measures"], state["total"])


class MulticlassHingeLoss(Metric):
    """Multiclass hinge loss (``one-vs-all``: one value per class).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassHingeLoss
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassHingeLoss(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6250)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        num_classes: int,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        shape = () if multiclass_mode == "crammer-singer" else (num_classes,)
        self.add_state("measures", default=torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, "global", self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _multiclass_hinge_loss_format(preds, target, self.num_classes, self.ignore_index)
        measures, total = _multiclass_hinge_loss_update(p, t, self.squared, self.multiclass_mode, w)
        return {"measures": measures, "total": total}

    def _compute(self, state):
        return _hinge_loss_compute(state["measures"], state["total"])


class HingeLoss(_ClassificationTaskWrapper):
    """Task facade over the binary and multiclass hinge losses.

    Example:
        >>> from torchmetrics_tpu_torch.classification import HingeLoss
        >>> type(HingeLoss(task="multiclass", num_classes=3, device="cpu")).__name__
        'MulticlassHingeLoss'
    """

    def __new__(
        cls,
        task: str,
        num_classes: Optional[int] = None,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryHingeLoss(squared, **kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return MulticlassHingeLoss(num_classes, squared, multiclass_mode, **kwargs)
