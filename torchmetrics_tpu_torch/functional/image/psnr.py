"""Peak signal-to-noise ratio (counterpart of ``torchmetrics_tpu/functional/image/psnr.py``).

The squared errors are summed in float64 and rounded once to float32; counts are int32,
as in the JAX package, made on the inputs' device (no host read, no host copy)."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from ...utilities.prints import rank_zero_warn
from .utils import _jax_tensor, _sum64, reduce


def _psnr_compute(
    sum_squared_error: torch.Tensor,
    num_obs: torch.Tensor,
    data_range: torch.Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    psnr_vals = psnr_base_e * (10 / torch.log(torch.tensor(base, dtype=torch.float32)))
    return reduce(psnr_vals, reduction)


def _psnr_update(preds: torch.Tensor, target: torch.Tensor, dim: Optional[Union[int, Tuple[int, ...]]] = None):
    if not preds.is_floating_point():
        preds = preds.to(torch.float32)
    if not target.is_floating_point():
        target = target.to(torch.float32)
    diff = preds - target
    if dim is None:
        return _sum64(diff * diff), torch.full((), target.numel(), dtype=torch.int32, device=target.device)
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:  # jnp.sum over no axis reduces nothing (torch's sum over () would reduce all)
        return diff * diff, torch.full((), target.numel(), dtype=torch.int32, device=target.device)
    sum_squared_error = _sum64(diff * diff, tuple(dim_list))
    n = math.prod(target.shape[d] for d in dim_list)
    return sum_squared_error, torch.full(sum_squared_error.shape, n, dtype=torch.int32, device=target.device)


def _clamp_pair(preds: torch.Tensor, target: torch.Tensor, data_range):
    """Clamp to a tuple ``data_range``; the range's width as a float32 scalar."""
    if isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        return preds, target, torch.tensor(data_range[1] - data_range[0], dtype=torch.float32)
    return preds, target, torch.tensor(float(data_range), dtype=torch.float32)


def peak_signal_noise_ratio(
    preds,
    target,
    data_range: Union[float, Tuple[float, float]],
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> torch.Tensor:
    """PSNR; ``data_range`` as a tuple clamps the inputs to that interval.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import peak_signal_noise_ratio
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> peak_signal_noise_ratio(preds, target, data_range=3.0)
        tensor(2.5527)
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    preds, target, data_range_val = _clamp_pair(_jax_tensor(preds), _jax_tensor(target), data_range)
    sum_squared_error, num_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, num_obs, data_range_val, base=base, reduction=reduction)


def _compat_peak_signal_noise_ratio(
    preds,
    target,
    data_range: Union[float, Tuple[float, float]] = 3.0,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> torch.Tensor:
    """The top-level ``functional.peak_signal_noise_ratio``: ``data_range`` defaults to
    3.0, unlike the strict ``functional.image`` export.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import peak_signal_noise_ratio
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> peak_signal_noise_ratio(preds, target)
        tensor(2.5527)
    """
    return peak_signal_noise_ratio(preds, target, data_range, base, reduction, dim)
