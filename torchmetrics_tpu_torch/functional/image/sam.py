"""Spectral Angle Mapper (counterpart of ``torchmetrics_tpu/functional/image/sam.py``):
the arccos of the clipped cosine between the spectra over the channel axis."""

from __future__ import annotations

from typing import Optional

import torch

from .utils import _check_image_pair, reduce


def _sam_update(preds, target):
    preds, target = _check_image_pair(preds, target)
    if preds.shape[1] <= 1:
        raise ValueError(
            "Expected channel dimension of `preds` and `target` to be larger than 1."
            f" Got preds: {preds.shape[1]} and target: {target.shape[1]}."
        )
    return preds, target


def _sam_compute(preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "elementwise_mean"):
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(preds, target, reduction: Optional[str] = "elementwise_mean") -> torch.Tensor:
    """Per-pixel spectral angle between prediction and target spectra (radians).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spectral_angle_mapper
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> spectral_angle_mapper(preds, target)
        tensor(0.6537)
    """
    preds, target = _sam_update(preds, target)
    return _sam_compute(preds, target, reduction)
