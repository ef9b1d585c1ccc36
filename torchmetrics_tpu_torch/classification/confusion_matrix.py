"""Confusion matrix metric class, multiclass (counterpart of
``torchmetrics_tpu/classification/confusion_matrix.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.classification.confusion_matrix import (
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_compute,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
)
from ..metric import Metric


class MulticlassConfusionMatrix(Metric):
    """Multiclass confusion matrix (int32 ``(C, C)`` state, rows = target). The pure
    path folds float32 batch counts into it, so there the state becomes float32, as in
    the JAX package.

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

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def _prepare_inputs(self, preds, target):
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        return (preds, target), {}

    def _batch_state(self, preds, target):
        p, t, w = _multiclass_confusion_matrix_format(preds, target, self.ignore_index)
        return {"confmat": _multiclass_confusion_matrix_update(p, t, w, self.num_classes)}

    def _compute(self, state):
        return _multiclass_confusion_matrix_compute(state["confmat"], self.normalize)
