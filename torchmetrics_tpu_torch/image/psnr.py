"""PeakSignalNoiseRatio metric class (counterpart of ``torchmetrics_tpu/image/psnr.py``).

States as in the JAX package: a float32 squared-error sum and an int32 count, or, with
``dim`` set, cat states of the per-update errors and counts."""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any, Optional, Tuple, Union

import torch

from ..functional.image.psnr import _psnr_compute, _psnr_update
from ..functional.image.utils import _jax_tensor
from ..metric import Metric
from ..utilities.prints import rank_zero_warn


class PeakSignalNoiseRatio(Metric):
    """PSNR over the accumulated squared error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatio
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> metric = PeakSignalNoiseRatio(data_range=3.0, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(2.5527)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        data_range: Union[float, Tuple[float, float]],
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        if dim is None:
            self.add_state("sum_squared_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")
        self.clamp_range: Optional[Tuple[float, float]] = None
        if isinstance(data_range, tuple):
            self.data_range_val = float(data_range[1] - data_range[0])
            self.clamp_range = (float(data_range[0]), float(data_range[1]))
        else:
            self.data_range_val = float(data_range)
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def _batch_state(self, preds, target):
        preds, target = _jax_tensor(preds), _jax_tensor(target)
        if self.clamp_range is not None:
            preds = torch.clamp(preds, *self.clamp_range)
            target = torch.clamp(target, *self.clamp_range)
        sum_squared_error, num_obs = _psnr_update(preds, target, dim=self.dim)
        return {"sum_squared_error": sum_squared_error, "total": num_obs}

    def _compute(self, state):
        return _psnr_compute(
            state["sum_squared_error"],
            state["total"],
            torch.tensor(self.data_range_val, dtype=torch.float32),
            base=self.base,
            reduction=self.reduction,
        )


class _CompatPeakSignalNoiseRatio(PeakSignalNoiseRatio):
    """The top-level ``torchmetrics_tpu_torch.PeakSignalNoiseRatio``: ``data_range``
    defaults to 3.0, unlike the strict ``image`` export."""

    def __init__(
        self,
        data_range: Union[float, Tuple[float, float]] = 3.0,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(data_range, base, reduction, dim, **kwargs)
