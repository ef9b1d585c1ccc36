"""Quality with No Reference, QNR (counterpart of ``torchmetrics_tpu/functional/image/qnr.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from .d_lambda import spectral_distortion_index
from .d_s import spatial_distortion_index


def quality_with_no_reference(
    preds,
    ms,
    pan,
    pan_lr=None,
    alpha: float = 1,
    beta: float = 1,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """QNR = (1 - D_lambda)^alpha * (1 - D_s)^beta.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import quality_with_no_reference
        >>> preds = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 37 % 97) / 97
        >>> ms = (torch.arange(3 * 16 * 16, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> pan = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 29 % 83) / 83
        >>> quality_with_no_reference(preds, ms, pan)
        tensor(0.4175)
    """
    if not isinstance(alpha, (int, float)) or alpha < 0:
        raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
    if not isinstance(beta, (int, float)) or beta < 0:
        raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
    d_lambda = spectral_distortion_index(preds, ms, norm_order, reduction)
    d_s = spatial_distortion_index(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
    return (1 - d_lambda) ** alpha * (1 - d_s) ** beta
