"""Spectral Distortion Index, D_lambda (counterpart of
``torchmetrics_tpu/functional/image/d_lambda.py``).

Every band pair ``(k, r)``, ``k < r``, of every sample goes through batched UQI calls,
in chunks under a fixed pixel budget; the pairs are ``torch.triu_indices``'s row-major
order, the JAX package's list order."""

from __future__ import annotations

from typing import Optional

import torch

from .uqi import _uqi_map
from .utils import _jax_tensor, reduce


def _spectral_distortion_index_update(preds, target):
    preds, target = _jax_tensor(preds), _jax_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            f"Expected `ms` and `fused` to have the same data type. Got ms: {preds.dtype} and fused: {target.dtype}."
        )
    if preds.ndim != 4:
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {preds.shape} and target: {target.shape}."
        )
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have same batch and channel sizes."
            f"Got preds: {preds.shape} and target: {target.shape}."
        )
    return preds, target


_CHUNK_PIXELS = 1 << 25  # band-image pixels a UQI call; its temporaries peak at about 25 floats a pixel


def _pairwise_band_uqi(img: torch.Tensor) -> torch.Tensor:
    """(C, C) symmetric matrix of the mean cross-band UQI of every band pair.

    The ``pairs * B`` band-image pairs go through UQI in chunks of at most
    ``_CHUNK_PIXELS`` pixels, each map summed in float64 as it finishes, so the peak
    memory stays bounded however many samples the states hold."""
    batch, length, height, width = img.shape
    m = torch.zeros((length, length), dtype=torch.float32, device=img.device)
    if length < 2:
        return m
    rows, cols = torch.triu_indices(length, length, offset=1, device=img.device)
    pairs = rows.numel()
    chunk = max(1, _CHUNK_PIXELS // (height * width))
    sums, numel = [], 0
    for start in range(0, pairs * batch, chunk):
        item = torch.arange(start, min(start + chunk, pairs * batch), device=img.device)
        pair, sample = item // batch, item % batch  # pair-major, as the JAX package stacks them
        uqi = _uqi_map(img[sample, rows[pair]].unsqueeze(1), img[sample, cols[pair]].unsqueeze(1))
        sums.append(uqi.sum((1, 2, 3), dtype=torch.float64))
        numel = uqi[0].numel()
    scores = torch.cat(sums).reshape(pairs, batch).sum(1) / (batch * numel)  # per pair over (B, 1, H', W')
    m = m.index_put((rows, cols), scores.to(m.dtype))
    return m + m.T


def _spectral_distortion_index_compute(
    preds: torch.Tensor, target: torch.Tensor, p: int = 1, reduction: Optional[str] = "elementwise_mean"
) -> torch.Tensor:
    length = preds.shape[1]
    m1 = _pairwise_band_uqi(target)
    m2 = _pairwise_band_uqi(preds)
    diff = torch.abs(m1 - m2) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (1.0 / (length * (length - 1)) * torch.sum(diff)) ** (1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(preds, target, p: int = 1, reduction: Optional[str] = "elementwise_mean") -> torch.Tensor:
    """D_lambda: the difference of the cross-band UQI structure between the fused image
    and the reference.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import spectral_distortion_index
        >>> preds = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 37 % 97) / 97
        >>> target = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 31 % 89) / 89
        >>> spectral_distortion_index(preds, target)
        tensor(0.2275)
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_index_update(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)
