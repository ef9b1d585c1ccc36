"""``HausdorffDistance`` (counterpart of
``torchmetrics_tpu/segmentation/hausdorff_distance.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch

from ..functional.segmentation.hausdorff_distance import (
    _hausdorff_distance_validate_args,
    hausdorff_distance,
)
from ..metric import Metric
from ..utilities.compute import _float32_sum


class HausdorffDistance(Metric):
    """Mean Hausdorff distance over the (sample, class) pairs: float32 scalar sum and
    count states.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.segmentation import HausdorffDistance
        >>> preds = torch.tensor([[[0, 1, 1, 0], [1, 1, 0, 0], [2, 2, 1, 0], [2, 0, 0, 0]]])
        >>> target = torch.tensor([[[0, 1, 1, 0], [1, 0, 0, 0], [2, 2, 0, 0], [2, 2, 0, 0]]])
        >>> metric = HausdorffDistance(num_classes=3, input_format='index', device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.5000)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        num_classes: int,
        include_background: bool = False,
        distance_metric: str = "euclidean",
        spacing: Optional[Union[Sequence[float], Any]] = None,
        directed: bool = False,
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _hausdorff_distance_validate_args(
            num_classes, include_background, distance_metric, spacing, directed, input_format
        )
        self.num_classes = num_classes
        self.include_background = include_background
        self.distance_metric = distance_metric
        self.spacing = spacing
        self.directed = directed
        self.input_format = input_format
        self.add_state("score", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        score = hausdorff_distance(
            preds,
            target,
            self.num_classes,
            include_background=self.include_background,
            distance_metric=self.distance_metric,
            spacing=self.spacing,
            directed=self.directed,
            input_format=self.input_format,
        )
        return {"score": _float32_sum(score), "total": torch.full((), float(score.numel()), device=score.device)}

    def _compute(self, state):
        return state["score"] / state["total"]
