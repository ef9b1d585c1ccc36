"""PeakSignalNoiseRatioWithBlockedEffect metric class (counterpart of
``torchmetrics_tpu/image/psnrb.py``).

Three sum states, as in the JAX package: the squared error, the block effect ``bef``
and an int32 count. ``bef`` is summed over the updates and the compute adds that sum,
not a mean of it, to the mean squared error."""

from __future__ import annotations

from typing import Any, Tuple, Union

import torch

from ..functional.image.psnrb import _psnrb_compute, _psnrb_update
from ..functional.image.utils import _jax_tensor
from ..metric import Metric


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNR-B over three scalar sum states (squared error, block effect, count).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatioWithBlockedEffect
        >>> preds = (torch.arange(256, dtype=torch.float32).reshape(1, 1, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(256, dtype=torch.float32).reshape(1, 1, 16, 16) * 31 % 89) / 89
        >>> metric = PeakSignalNoiseRatioWithBlockedEffect(data_range=1.0, block_size=8, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(7.6286)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        data_range: Union[float, Tuple[float, float]],
        block_size: int = 8,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("bef", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.clamp_range = None
        if isinstance(data_range, tuple):
            self.data_range_val = float(data_range[1] - data_range[0])
            self.clamp_range = (float(data_range[0]), float(data_range[1]))
        else:
            self.data_range_val = float(data_range)

    def _batch_state(self, preds, target):
        preds, target = _jax_tensor(preds), _jax_tensor(target)
        if self.clamp_range is not None:
            preds = torch.clamp(preds, *self.clamp_range)
            target = torch.clamp(target, *self.clamp_range)
        sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=self.block_size)
        return {"sum_squared_error": sum_squared_error, "bef": bef, "total": num_obs}

    def _compute(self, state):
        return _psnrb_compute(state["sum_squared_error"], state["bef"], state["total"],
                              torch.tensor(self.data_range_val, dtype=torch.float32))
