"""PSNR with blocked effect (counterpart of ``torchmetrics_tpu/functional/image/psnrb.py``).

The block-boundary columns and rows are masks built on the device from the shape (the
JAX package's ``np.arange``/``np.setdiff1d`` index sets); the squared differences are
summed in float64 and rounded once."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .psnr import _clamp_pair
from .utils import _jax_tensor, _sum64


def _boundary_split(diff_sq: torch.Tensor, axis: int, block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 sums of the squared differences on and off the block boundaries of ``axis``."""
    n = diff_sq.shape[axis]
    on = (torch.arange(n, device=diff_sq.device) % block_size) == block_size - 1
    shape = [1] * diff_sq.ndim
    shape[axis] = n
    on = on.reshape(shape)
    zero = torch.zeros((), dtype=diff_sq.dtype, device=diff_sq.device)
    return (torch.where(on, diff_sq, zero).sum(dtype=torch.float64),
            torch.where(on, zero, diff_sq).sum(dtype=torch.float64))


def _compute_bef(x: torch.Tensor, block_size: int = 8) -> torch.Tensor:
    """Block-boundary effect factor of a grayscale batch."""
    _, channels, height, width = x.shape
    if channels > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {channels} channels.")
    h_b, h_bc = _boundary_split((x[..., :, :-1] - x[..., :, 1:]) ** 2, 3, block_size)
    v_b, v_bc = _boundary_split((x[..., :-1, :] - x[..., 1:, :]) ** 2, 2, block_size)
    d_b = (h_b + v_b).to(x.dtype)
    d_bc = (h_bc + v_bc).to(x.dtype)

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = math.log2(block_size) / math.log2(min(height, width))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), torch.zeros((), dtype=d_b.dtype, device=d_b.device))


def _psnrb_compute(sum_squared_error, bef, num_obs, data_range) -> torch.Tensor:
    sum_squared_error = sum_squared_error / num_obs + bef
    return 10 * torch.log10(data_range**2 / sum_squared_error)


def _psnrb_update(preds: torch.Tensor, target: torch.Tensor, block_size: int = 8):
    sum_squared_error = _sum64((preds - target) ** 2)
    num_obs = torch.full((), target.numel(), dtype=torch.int32, device=target.device)
    bef = _compute_bef(preds, block_size=block_size)
    return sum_squared_error, bef, num_obs


def peak_signal_noise_ratio_with_blocked_effect(preds, target, data_range, block_size: int = 8) -> torch.Tensor:
    """PSNR-B: PSNR penalised by the block-boundary effect factor (grayscale only).
    ``data_range`` as a tuple clamps the inputs to that interval.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import peak_signal_noise_ratio_with_blocked_effect
        >>> preds = (torch.arange(256, dtype=torch.float32).reshape(1, 1, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(256, dtype=torch.float32).reshape(1, 1, 16, 16) * 31 % 89) / 89
        >>> peak_signal_noise_ratio_with_blocked_effect(preds, target, data_range=1.0)
        tensor(7.6286)
    """
    preds, target, data_range_val = _clamp_pair(_jax_tensor(preds), _jax_tensor(target), data_range)
    sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=block_size)
    return _psnrb_compute(sum_squared_error, bef, num_obs, data_range_val)
