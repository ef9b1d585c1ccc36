"""``DiceScore`` (counterpart of ``torchmetrics_tpu/segmentation/dice.py``)."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.segmentation.dice import (
    _dice_score_compute,
    _dice_score_update,
    _dice_score_validate_args,
    _nanmean,
)
from ..metric import Metric


class DiceScore(Metric):
    """Dice score over per-sample statistics: cat states of ``(N, C)`` float32 rows
    (samplewise aggregation needs the rows), and the NaN-skipping mean over them.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.segmentation import DiceScore
        >>> preds = torch.tensor([[[0, 1, 1, 0], [1, 1, 0, 0], [2, 2, 1, 0], [2, 0, 0, 0]]])
        >>> target = torch.tensor([[[0, 1, 1, 0], [1, 0, 0, 0], [2, 2, 0, 0], [2, 2, 0, 0]]])
        >>> metric = DiceScore(num_classes=3, input_format='index', device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.8102)
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
        average: Optional[str] = "macro",
        aggregation_level: Optional[str] = "samplewise",
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _dice_score_validate_args(num_classes, include_background, average, input_format, aggregation_level)
        self.num_classes = num_classes
        self.include_background = include_background
        self.average = average
        self.aggregation_level = aggregation_level
        self.input_format = input_format
        self.add_state("numerator", default=[], dist_reduce_fx="cat")
        self.add_state("denominator", default=[], dist_reduce_fx="cat")
        self.add_state("support", default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        numerator, denominator, support = _dice_score_update(
            preds, target, self.num_classes, self.include_background, self.input_format
        )
        return {"numerator": numerator, "denominator": denominator, "support": support}

    def _compute(self, state):
        return _nanmean(
            _dice_score_compute(
                state["numerator"],
                state["denominator"],
                self.average,
                self.aggregation_level,
                support=state["support"] if self.average == "weighted" else None,
            ),
            0,
        )
