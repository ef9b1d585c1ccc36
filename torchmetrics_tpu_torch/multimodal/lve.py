"""LipVertexError metric class (counterpart of ``torchmetrics_tpu/multimodal/lve.py``)."""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..functional.multimodal.lve import lip_vertex_error
from ..metric import Metric


class LipVertexError(Metric):
    """Running mean of LVE over update calls: a float32 ``sum_lve`` and an int32
    ``total``, as in the JAX package.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.multimodal import LipVertexError
        >>> vertices_pred = (torch.arange(90, dtype=torch.float32).reshape(5, 6, 3) * 37 % 19) / 19
        >>> vertices_gt = (torch.arange(90, dtype=torch.float32).reshape(5, 6, 3) * 31 % 17) / 17
        >>> metric = LipVertexError(mouth_map=[1, 2, 3], device="cpu")
        >>> metric.update(vertices_pred, vertices_gt)
        >>> metric.compute()
        tensor(0.9050)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, mouth_map: Sequence[int], validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(mouth_map, (list, tuple)) or len(mouth_map) == 0:
            raise ValueError(f"Expected argument `mouth_map` to be a non-empty list but got {mouth_map}")
        self.mouth_map = list(mouth_map)
        self.validate_args = validate_args
        self.add_state("sum_lve", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _batch_state(self, vertices_pred, vertices_gt):
        value = lip_vertex_error(vertices_pred, vertices_gt, self.mouth_map, self.validate_args)
        return {"sum_lve": value.to(torch.float32), "total": torch.ones((), dtype=torch.int32, device=value.device)}

    def _compute(self, state):
        return state["sum_lve"] / state["total"]
