"""PerceptualPathLength metric class (counterpart of
``torchmetrics_tpu/image/perceptual_path_length.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..functional.image.perceptual_path_length import (
    _perceptual_path_length_validate_arguments,
    _quantile_filtered_stats,
    perceptual_path_length,
)
from ..metric import HostMetric


class PerceptualPathLength(HostMetric):
    """Generator-probing metric: ``update(generator)`` runs the whole PPL probe on the
    metric's device and appends its distances to the cat state ``distances``;
    ``compute`` applies the quantile filter."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = True

    def __init__(
        self,
        num_samples: int = 10_000,
        conditional: bool = False,
        batch_size: int = 128,
        interpolation_method: str = "lerp",
        epsilon: float = 1e-4,
        resize: Optional[int] = 64,
        lower_discard: Optional[float] = 0.01,
        upper_discard: Optional[float] = 0.99,
        sim_net: Union[Callable, str] = "vgg",
        sim_net_weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _perceptual_path_length_validate_arguments(
            num_samples, conditional, batch_size, interpolation_method, epsilon, resize, lower_discard, upper_discard
        )
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.resize = resize
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        self.sim_net = sim_net
        self.sim_net_weights_path = sim_net_weights_path
        self.add_state("distances", default=[], dist_reduce_fx="cat")

    def _host_batch_state(self, generator):
        _, _, dist = perceptual_path_length(
            generator,
            num_samples=self.num_samples,
            conditional=self.conditional,
            batch_size=self.batch_size,
            interpolation_method=self.interpolation_method,
            epsilon=self.epsilon,
            resize=self.resize,
            lower_discard=None,
            upper_discard=None,
            sim_net=self.sim_net,
            sim_net_weights_path=self.sim_net_weights_path,
            device=self.device,
        )
        return {"distances": dist}

    def _compute(self, state) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dist = state["distances"].to(self.device)
        mean, std = _quantile_filtered_stats(dist, self.lower_discard, self.upper_discard)
        return mean, std, dist

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, id(self)))
