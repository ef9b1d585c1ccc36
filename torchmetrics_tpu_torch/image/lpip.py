"""LearnedPerceptualImagePatchSimilarity metric class (counterpart of
``torchmetrics_tpu/image/lpip.py``)."""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..functional.image.lpips import LPIPSNetwork
from ..metric import Metric


class LearnedPerceptualImagePatchSimilarity(Metric):
    """Running-mean LPIPS: two float32 sum states, ``sum_scores`` and ``total``.
    ``weights_path`` points at a converted weight pickle (the JAX package's format);
    ``pretrained=False`` runs the machinery on seeded random parameters. The network
    lives on the metric's device, and a gradient flows to the inputs."""

    # extractor attribute FeatureShare dedupes (the JAX package declares the same name)
    feature_network: str = "net"

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        weights_path: Optional[str] = None,
        pretrained: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction} but got {reduction}")
        self.reduction = reduction
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.normalize = normalize
        self.net = LPIPSNetwork(net_type, pretrained=pretrained, weights_path=weights_path).to(self.device)
        self.add_state("sum_scores", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _batch_state(self, img1, img2):
        loss = self.net(img1, img2, normalize=self.normalize)
        return {"sum_scores": loss.sum(), "total": torch.full((), float(loss.shape[0]), device=loss.device)}

    def _compute(self, state):
        if self.reduction == "mean":
            return state["sum_scores"] / state["total"]
        return state["sum_scores"]

    def to(self, device: Union[str, torch.device]) -> "LearnedPerceptualImagePatchSimilarity":
        super().to(device)
        if isinstance(self.net, torch.nn.Module):
            self.net.to(self.device)
        return self
