"""``MeanIoU`` (counterpart of ``torchmetrics_tpu/segmentation/mean_iou.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.segmentation.mean_iou import (
    _mean_iou_compute,
    _mean_iou_update,
    _mean_iou_validate_args,
)
from ..metric import Metric
from ..utilities.compute import _float32_sum
from ..utilities.exceptions import TorchMetricsUserError


class MeanIoU(Metric):
    """Float32 sum states: the IoU of each (sample, class) present in it, summed, and
    the count of those pairs (per class with ``per_class``, else one of each). Without
    ``num_classes`` the first ``update`` infers it from the class axis and adds the
    states then.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.segmentation import MeanIoU
        >>> preds = torch.tensor([[[0, 1, 1, 0], [1, 1, 0, 0], [2, 2, 1, 0], [2, 0, 0, 0]]])
        >>> target = torch.tensor([[[0, 1, 1, 0], [1, 0, 0, 0], [2, 2, 0, 0], [2, 2, 0, 0]]])
        >>> metric = MeanIoU(num_classes=3, input_format='index', device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6833)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: Optional[int] = None,
        include_background: bool = True,
        per_class: bool = False,
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _mean_iou_validate_args(num_classes, include_background, per_class, input_format)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.input_format = input_format
        self._is_initialized = False
        if num_classes is not None:
            self._init_states(num_classes)

    def _init_states(self, num_classes: int) -> None:
        num_out = num_classes - 1 if not self.include_background else num_classes
        size = num_out if self.per_class else 1
        self.add_state("score", default=torch.zeros(size), dist_reduce_fx="sum")
        self.add_state("num_batches", default=torch.zeros(size), dist_reduce_fx="sum")
        self._is_initialized = True

    def _prepare_inputs(self, preds, target):
        if not self._is_initialized:
            if self.input_format == "one-hot":
                self.num_classes = preds.shape[1]
            elif self.input_format == "mixed":
                if preds.ndim == target.ndim + 1:
                    self.num_classes = preds.shape[1]
                elif preds.ndim + 1 == target.ndim:
                    self.num_classes = target.shape[1]
                else:
                    raise ValueError(
                        "Predictions and targets are expected to have the same shape, "
                        f"got {preds.shape} and {target.shape}."
                    )
            else:
                raise ValueError("Argument `num_classes` must be provided when `input_format` is 'index'.")
            if self.num_classes == 0:
                raise ValueError(f"Expected argument `num_classes` to be a positive integer, but got {self.num_classes}.")
            self._init_states(self.num_classes)
        return (preds, target), {}

    def update_state(self, state, *args, **kwargs):
        if not self._is_initialized:
            raise TorchMetricsUserError(
                "MeanIoU cannot run as a pure update with inferred `num_classes`; pass `num_classes` "
                "at construction (or run one stateful `update` first)."
            )
        return super().update_state(state, *args, **kwargs)

    def _batch_state(self, preds, target):
        intersection, union = _mean_iou_update(
            preds, target, self.num_classes, self.include_background, self.input_format
        )
        score = _mean_iou_compute(intersection, union, zero_division=0.0)
        valid = (union > 0).to(torch.float32)
        if self.per_class:
            return {"score": _float32_sum(score * valid, 0), "num_batches": valid.sum(0)}
        return {"score": _float32_sum(score * valid)[None], "num_batches": valid.sum()[None]}

    def _compute(self, state):
        out = state["score"] / state["num_batches"]
        return torch.nan_to_num(out, nan=-1.0) if self.per_class else out.nanmean()
