"""Sliding-window RMSE (counterpart of ``torchmetrics_tpu/functional/image/rmse_sw.py``).

The crop is ``round(window_size / 2)``, Python's round (half to even), as in the JAX
package."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .utils import _check_image_pair, _mean64, uniform_filter


def _rmse_sw_update(
    preds,
    target,
    window_size: int,
    rmse_val_sum: Optional[torch.Tensor],
    rmse_map: Optional[torch.Tensor],
    total_images: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    preds, target = _check_image_pair(preds, target)
    if round(window_size / 2) >= target.shape[2] or round(window_size / 2) >= target.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than"
            f" {min(target.shape[2], target.shape[3])} but got {round(window_size / 2)}."
        )
    batch = torch.full((), float(target.shape[0]), dtype=torch.float32, device=target.device)
    total_images = total_images + target.shape[0] if total_images is not None else batch
    error = (target - preds) ** 2
    error = uniform_filter(error, window_size)
    _rmse_map = torch.sqrt(error)
    crop_slide = round(window_size / 2)
    rmse_val = _mean64(_rmse_map[:, :, crop_slide:-crop_slide, crop_slide:-crop_slide].sum(0))
    rmse_val_sum = rmse_val_sum + rmse_val if rmse_val_sum is not None else rmse_val
    rmse_map = rmse_map + _rmse_map.sum(0) if rmse_map is not None else _rmse_map.sum(0)
    return rmse_val_sum, rmse_map, total_images


def _rmse_sw_compute(rmse_val_sum: Optional[torch.Tensor], rmse_map: torch.Tensor, total_images: torch.Tensor):
    rmse = rmse_val_sum / total_images if rmse_val_sum is not None else None
    return rmse, rmse_map / total_images


def root_mean_squared_error_using_sliding_window(
    preds, target, window_size: int = 8, return_rmse_map: bool = False
):
    """RMSE over a uniform sliding window (optionally with the error map).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import root_mean_squared_error_using_sliding_window
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> root_mean_squared_error_using_sliding_window(preds, target)
        tensor(0.4099)
    """
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    rmse_val_sum, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=None, total_images=None
    )
    rmse, rmse_map = _rmse_sw_compute(rmse_val_sum, rmse_map, total_images)
    if return_rmse_map:
        return rmse, rmse_map
    return rmse
