"""DeepImageStructureAndTextureSimilarity metric class (counterpart of
``torchmetrics_tpu/image/dists.py``)."""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..functional.image.dists import DISTSNetwork
from ..metric import Metric


class DeepImageStructureAndTextureSimilarity(Metric):
    """Running-mean DISTS: two float32 sum states. ``weights_path`` points at a
    converted weight pickle (the JAX package's format); ``pretrained=False`` runs the
    machinery on seeded random parameters. The network lives on the metric's device."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        reduction: str = "mean",
        weights_path: Optional[str] = None,
        pretrained: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        # only sum states are kept, so per-image 'none' output cannot be honored here
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Argument `reduction` must be one of ('mean', 'sum'), got {reduction}")
        self.reduction = reduction
        self.net = DISTSNetwork(pretrained=pretrained, weights_path=weights_path).to(self.device)
        self.add_state("sum_scores", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        scores = self.net(preds, target)
        return {"sum_scores": scores.sum(), "total": torch.full((), float(scores.shape[0]), device=scores.device)}

    def _compute(self, state):
        if self.reduction == "mean":
            return state["sum_scores"] / state["total"]
        return state["sum_scores"]

    def to(self, device: Union[str, torch.device]) -> "DeepImageStructureAndTextureSimilarity":
        super().to(device)
        self.net.to(self.device)
        return self
