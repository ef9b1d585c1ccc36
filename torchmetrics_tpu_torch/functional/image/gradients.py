"""Image gradients (counterpart of ``torchmetrics_tpu/functional/image/gradients.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .utils import _jax_tensor


def image_gradients(img) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-step finite differences (dy, dx), zero-padded at the far edge (TF semantics).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import image_gradients
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> [tuple(g.shape) for g in image_gradients(preds)]
        [(1, 3, 16, 16), (1, 3, 16, 16)]
    """
    if not hasattr(img, "shape"):
        raise TypeError(f"The `img` expects a value of <Tensor> type but got {type(img)}")
    img = _jax_tensor(img)
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1))
