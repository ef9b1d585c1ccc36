"""Relative Average Spectral Error (counterpart of ``torchmetrics_tpu/functional/image/rase.py``).

The local target means divide by ``window_size ** 2`` a second time after the uniform
filter, as the JAX package does."""

from __future__ import annotations

from typing import Tuple

import torch

from .rmse_sw import _rmse_sw_compute, _rmse_sw_update
from .utils import _jax_tensor, _mean64, uniform_filter


def _rase_update(
    preds, target, window_size: int, rmse_map: torch.Tensor, target_sum: torch.Tensor, total_images: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images
    )
    target_sum = target_sum + torch.sum(uniform_filter(target, window_size) / (window_size**2), dim=0)
    return rmse_map, target_sum, total_images


def _rase_compute(rmse_map: torch.Tensor, target_sum: torch.Tensor, total_images: torch.Tensor,
                  window_size: int) -> torch.Tensor:
    _, rmse_map = _rmse_sw_compute(rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images)
    target_mean = target_sum / total_images
    target_mean = target_mean.mean(0)  # mean over image channels
    rase_map = 100 / target_mean * torch.sqrt(torch.mean(rmse_map**2, dim=0))
    crop_slide = round(window_size / 2)
    return _mean64(rase_map[crop_slide:-crop_slide, crop_slide:-crop_slide])


def _rase_over(preds: torch.Tensor, target: torch.Tensor, window_size: int) -> torch.Tensor:
    """RASE of a whole set of images, from zero states."""
    img_shape = target.shape[1:]
    rmse_map = torch.zeros(img_shape, dtype=target.dtype, device=target.device)
    target_sum = torch.zeros(img_shape, dtype=target.dtype, device=target.device)
    total_images = torch.zeros((), dtype=torch.float32, device=target.device)
    rmse_map, target_sum, total_images = _rase_update(preds, target, window_size, rmse_map, target_sum, total_images)
    return _rase_compute(rmse_map, target_sum, total_images, window_size)


def relative_average_spectral_error(preds, target, window_size: int = 8) -> torch.Tensor:
    """RASE: percentage RMSE relative to the local target mean.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import relative_average_spectral_error
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> relative_average_spectral_error(preds, target)
        tensor(5315.8857)
    """
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    return _rase_over(_jax_tensor(preds), _jax_tensor(target), window_size)
