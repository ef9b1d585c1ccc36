"""``GeneralizedDiceScore`` (counterpart of
``torchmetrics_tpu/segmentation/generalized_dice.py``)."""

from __future__ import annotations

from typing import Any

import torch

from ..functional.segmentation.generalized_dice import (
    _generalized_dice_compute,
    _generalized_dice_update,
    _generalized_dice_validate_args,
)
from ..metric import Metric
from ..utilities.compute import _float32_sum


class GeneralizedDiceScore(Metric):
    """Float32 sum states: the per-sample scores' sum (``(C,)`` with ``per_class``, else
    ``(1,)``) and the sample count.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.segmentation import GeneralizedDiceScore
        >>> preds = torch.tensor([[[0, 1, 1, 0], [1, 1, 0, 0], [2, 2, 1, 0], [2, 0, 0, 0]]])
        >>> target = torch.tensor([[[0, 1, 1, 0], [1, 0, 0, 0], [2, 2, 0, 0], [2, 2, 0, 0]]])
        >>> metric = GeneralizedDiceScore(num_classes=3, input_format='index', device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([0.7906])
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        per_class: bool = False,
        weight_type: str = "square",
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _generalized_dice_validate_args(num_classes, include_background, per_class, weight_type, input_format)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.weight_type = weight_type
        self.input_format = input_format
        num_out = num_classes - 1 if not include_background else num_classes
        self.add_state("score", default=torch.zeros(num_out if per_class else 1), dist_reduce_fx="sum")
        self.add_state("samples", default=torch.zeros(1), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        numerator, denominator = _generalized_dice_update(
            preds, target, self.num_classes, self.include_background, self.weight_type, self.input_format
        )
        score = _float32_sum(_generalized_dice_compute(numerator, denominator, self.per_class), 0)
        n = numerator.shape[0]
        return {"score": score.reshape(self._defaults["score"].shape),
                "samples": torch.full((1,), float(n), device=score.device)}

    def _compute(self, state):
        return state["score"] / state["samples"]
