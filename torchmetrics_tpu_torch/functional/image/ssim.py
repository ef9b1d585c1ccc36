"""SSIM and multi-scale SSIM (counterpart of ``torchmetrics_tpu/functional/image/ssim.py``).

One grouped convolution over the stacked ``(5 B, C, ...)`` moment batch gives the five
local moments, in 2-D (NCHW) and 3-D (NCDHW), with the window applied directly as the
JAX package does (11 x 11 taps, 11^3 in 3-D). ``data_range=None`` takes the range from
the inputs on their device, with no host read; a per-image mean accumulates in float64
and rounds once."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from .utils import (
    _jax_tensor,
    _gaussian_kernel_2d,
    _gaussian_kernel_3d,
    _mean64,
    avg_pool2d,
    avg_pool3d,
    conv2d,
    conv3d,
    reduce,
    reflect_pad_2d,
    reflect_pad_3d,
)


def _ssim_check_inputs(preds, target):
    preds, target = _jax_tensor(preds), _jax_tensor(target)
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    if tuple(preds.shape) != tuple(target.shape):
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    if preds.ndim not in (4, 5):
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape."
            f" Got preds: {preds.shape} and target: {target.shape}."
        )
    return preds, target


def _ssim_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    is_3d = preds.ndim == 5
    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]
    if len(kernel_size) != preds.ndim - 2 or len(kernel_size) not in (2, 3):
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less that target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if len(sigma) != preds.ndim - 2:
        raise ValueError(
            f"`sigma` has dimension {len(sigma)}, but expected to be two less that target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    channel = preds.shape[1]
    dtype = preds.dtype
    gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]

    # kernel_size[i] / sigma[i] act on spatial axis i: (H, W) for NCHW inputs,
    # (D, H, W) for NCDHW; pads, kernel dims and crops all share this mapping
    eff_kernel = gauss_kernel_size if gaussian_kernel else kernel_size
    pads = [(k - 1) // 2 for k in eff_kernel]
    if is_3d:
        preds = reflect_pad_3d(preds, *pads)
        target = reflect_pad_3d(target, *pads)
        make_kernel, conv = _gaussian_kernel_3d, conv3d
    else:
        preds = reflect_pad_2d(preds, *pads)
        target = reflect_pad_2d(target, *pads)
        make_kernel, conv = _gaussian_kernel_2d, conv2d
    if gaussian_kernel:
        kernel = make_kernel(channel, gauss_kernel_size, sigma, dtype, preds.device)
    else:
        kernel = torch.ones((channel, 1, *kernel_size), dtype=dtype, device=preds.device) / float(math.prod(kernel_size))

    batch = preds.shape[0]
    input_list = torch.cat([preds, target, preds * preds, target * target, preds * target])
    mu_pred, mu_target, pred_sq, target_sq, pred_target = conv(input_list, kernel, groups=channel).split(batch)
    del input_list

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = torch.clamp(pred_sq - mu_pred_sq, min=0.0)
    sigma_target_sq = torch.clamp(target_sq - mu_target_sq, min=0.0)
    sigma_pred_target = pred_target - mu_pred_target

    upper = 2 * sigma_pred_target.to(dtype) + c2
    lower = (sigma_pred_sq + sigma_target_sq).to(dtype) + c2
    ssim_full = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)
    sim = _mean64(ssim_full.reshape(batch, -1), -1)

    if return_contrast_sensitivity:
        # the contrast term is cropped back to the unpadded region, axis by axis in the
        # order the padding was applied
        contrast = upper / lower
        crop = tuple(slice(p, -p) for p in pads)
        contrast = contrast[(..., *crop)]
        return sim, _mean64(contrast.reshape(batch, -1), -1)
    if return_full_image:
        return sim, ssim_full
    return sim


def _ssim_compute(similarities: torch.Tensor, reduction: Optional[str] = "elementwise_mean") -> torch.Tensor:
    return reduce(similarities, reduction)


def structural_similarity_index_measure(
    preds,
    target,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """SSIM over NCHW (or NCDHW) image batches.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import structural_similarity_index_measure
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> structural_similarity_index_measure(preds, target, data_range=1.0)
        tensor(-0.0258)
    """
    preds, target = _ssim_check_inputs(preds, target)
    pack = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )
    if isinstance(pack, tuple):
        similarity, image = pack
        return _ssim_compute(similarity, reduction), image
    return _ssim_compute(pack, reduction)


def _multiscale_ssim_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> torch.Tensor:
    is_3d = preds.ndim == 5
    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    mcs_list = []
    sim = None
    pool = avg_pool2d if len(kernel_size) == 2 else avg_pool3d
    for _ in range(len(betas)):
        sim, contrast = _ssim_update(
            preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
            return_contrast_sensitivity=True,
        )
        if normalize == "relu":
            sim = torch.clamp(sim, min=0.0)
            contrast = torch.clamp(contrast, min=0.0)
        mcs_list.append(contrast)
        preds = pool(preds)
        target = pool(target)
    mcs_list[-1] = sim
    if normalize == "simple":
        mcs_list = [(m + 1) / 2 for m in mcs_list]
    # the betas as float32 exponents, multiplied in scale order as jnp.prod does
    out = mcs_list[0] ** float(torch.tensor(betas[0], dtype=torch.float32))
    for mcs, beta in zip(mcs_list[1:], betas[1:]):
        out = out * mcs ** float(torch.tensor(beta, dtype=torch.float32))
    return out


def multiscale_structural_similarity_index_measure(
    preds,
    target,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al.'s scale pyramid with contrast terms).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiscale_structural_similarity_index_measure
        >>> preds = (torch.arange(3 * 64 * 64, dtype=torch.float32).reshape(1, 3, 64, 64) * 37 % 97) / 97
        >>> target = (torch.arange(3 * 64 * 64, dtype=torch.float32).reshape(1, 3, 64, 64) * 31 % 89) / 89
        >>> multiscale_structural_similarity_index_measure(preds, target, data_range=1.0, betas=(0.5, 0.5))
        tensor(0.0115)
    """
    if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be of a tuple of floats")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None`, `relu` or `simple`")
    preds, target = _ssim_check_inputs(preds, target)
    mcs = _multiscale_ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas, normalize
    )
    return reduce(mcs, reduction)
