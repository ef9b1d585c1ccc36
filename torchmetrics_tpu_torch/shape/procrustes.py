"""ProcrustesDisparity metric class (counterpart of ``torchmetrics_tpu/shape/procrustes.py``).

Two sum states as in the JAX package: ``disparity`` float32 and ``total`` int32. A batch's
disparities are summed in float64 and rounded once; an update of 2-D or 3-D clouds reads
nothing from the host (wider ones do, in ``torch.linalg.svd``).
"""

from __future__ import annotations

from typing import Any

import torch

from ..functional.shape.procrustes import _procrustes
from ..metric import Metric


class ProcrustesDisparity(Metric):
    """Running sum/mean of per-sample Procrustes disparity (two sum states).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.shape import ProcrustesDisparity
        >>> point_set1 = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]])
        >>> point_set2 = torch.tensor([[[0.0, 0.0], [2.0, 0.0], [2.0, 2.0], [0.0, 2.0]]])
        >>> metric = ProcrustesDisparity(device="cpu")
        >>> metric.update(point_set1, point_set2)
        >>> metric.compute()
        tensor(2.4652e-32)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: str = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Argument `reduction` must be one of ['mean', 'sum'], got {reduction}")
        self.reduction = reduction
        self.add_state("disparity", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _batch_state(self, point_cloud1, point_cloud2):
        disparity = _procrustes(point_cloud1, point_cloud2)[0]
        total = torch.full((), disparity.numel(), dtype=torch.int32, device=disparity.device)
        return {"disparity": disparity.sum().to(torch.float32), "total": total}

    def _compute(self, state):
        if self.reduction == "mean":
            return state["disparity"] / state["total"]
        return state["disparity"]
