"""Lip Vertex Error (counterpart of ``torchmetrics_tpu/functional/multimodal/lve.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...utilities.checks import _as_tensor
from ...utilities.data import _device_constant, _jax_dtype


def lip_vertex_error(
    vertices_pred,
    vertices_gt,
    mouth_map: Sequence[int],
    validate_args: bool = True,
) -> torch.Tensor:
    r"""Mean over frames of the max squared L2 error over lip vertices:
    ``LVE = mean_i max_{v in lip} ||x_{i,v} - xhat_{i,v}||^2``, on the vertices' device.
    The frame mean adds in float64 and rounds once.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import lip_vertex_error
        >>> vertices_pred = (torch.arange(90, dtype=torch.float32).reshape(5, 6, 3) * 37 % 19) / 19
        >>> vertices_gt = (torch.arange(90, dtype=torch.float32).reshape(5, 6, 3) * 31 % 17) / 17
        >>> lip_vertex_error(vertices_pred, vertices_gt, mouth_map=[1, 2, 3])
        tensor(0.9050)
    """
    vertices_pred = _jax_dtype(_as_tensor(vertices_pred))
    vertices_gt = _jax_dtype(_as_tensor(vertices_gt))
    if validate_args:
        if vertices_pred.ndim != 3 or vertices_gt.ndim != 3:
            raise ValueError(
                f"Expected both vertices_pred and vertices_gt to have 3 dimensions but got "
                f"{vertices_pred.ndim} and {vertices_gt.ndim} dimensions respectively."
            )
        if vertices_pred.shape[1:] != vertices_gt.shape[1:]:
            raise ValueError(
                f"Expected vertices_pred and vertices_gt to have same vertex and coordinate dimensions but got "
                f"{tuple(vertices_pred.shape)} and {tuple(vertices_gt.shape)}."
            )
        if len(mouth_map) == 0:
            raise ValueError("Expected mouth_map to be non-empty.")
        if max(mouth_map) >= vertices_gt.shape[1]:
            raise ValueError(
                f"Invalid vertex index {max(mouth_map)} in mouth_map for mesh with {vertices_gt.shape[1]} vertices."
            )
    min_frames = min(vertices_pred.shape[0], vertices_gt.shape[0])
    # the lip indices are made on the device once, so an update reads nothing back
    mouth = _device_constant(np.asarray, vertices_pred.device, tuple(int(i) for i in mouth_map))
    pred_mouth = vertices_pred[:min_frames, mouth]
    gt_mouth = vertices_gt[:min_frames, mouth]
    sq_err = ((pred_mouth - gt_mouth) ** 2).sum(dim=-1)  # (T, |mouth|)
    return sq_err.amax(dim=-1).mean(dtype=torch.float64).to(sq_err.dtype)
