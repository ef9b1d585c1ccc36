"""Universal Image Quality Index (counterpart of ``torchmetrics_tpu/functional/image/uqi.py``).

The five local moments are one grouped convolution over the stacked
``(5 B, C, H, W)`` batch. The JAX package pads H by the width's half-kernel and W by the
height's (``reflect_pad_2d(preds, pad_w, pad_h)``) and crops by the kernel's own
halves; the port keeps that, so an anisotropic kernel gives JAX's map shape."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .utils import _check_image_pair, _gaussian_kernel_2d, conv2d, reduce, reflect_pad_2d


def _uqi_update(preds, target):
    return _check_image_pair(preds, target)


def _uqi_map(preds: torch.Tensor, target: torch.Tensor, kernel_size: Sequence[int] = (11, 11),
             sigma: Sequence[float] = (1.5, 1.5)) -> torch.Tensor:
    """The cropped per-pixel UQI map."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    channel = preds.shape[1]
    dtype = preds.dtype
    kernel = _gaussian_kernel_2d(channel, kernel_size, sigma, dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds = reflect_pad_2d(preds, pad_w, pad_h)  # the JAX package's order, kept
    target = reflect_pad_2d(target, pad_w, pad_h)

    batch = preds.shape[0]
    input_list = torch.cat([preds, target, preds * preds, target * target, preds * target])
    mu_pred, mu_target, pred_sq, target_sq, pred_target = conv2d(input_list, kernel, groups=channel).split(batch)
    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = torch.clamp(pred_sq - mu_pred_sq, min=0.0)
    sigma_target_sq = torch.clamp(target_sq - mu_target_sq, min=0.0)
    sigma_pred_target = pred_target - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    eps = torch.finfo(sigma_pred_sq.dtype).eps
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower + eps)
    return uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w]


def _uqi_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    return reduce(_uqi_map(preds, target, kernel_size, sigma), reduction)


def universal_image_quality_index(
    preds,
    target,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Universal Image Quality Index — SSIM without the stability constants.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import universal_image_quality_index
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> universal_image_quality_index(preds, target)
        tensor(0.0586)
    """
    preds, target = _uqi_update(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction)
