"""Hausdorff distance for semantic segmentation (counterpart of
``torchmetrics_tpu/functional/segmentation/hausdorff_distance.py``), over the gathered
edge voxels of each (sample, class): see ``utils.edge_surface_distance``."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .utils import _segmentation_inputs_format, edge_surface_distance


def _hausdorff_distance_validate_args(
    num_classes: int,
    include_background: bool,
    distance_metric: str = "euclidean",
    spacing: Optional[Union[torch.Tensor, Sequence[float]]] = None,
    directed: bool = False,
    input_format: str = "one-hot",
) -> None:
    if num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    if distance_metric not in ["euclidean", "chessboard", "taxicab"]:
        raise ValueError(
            f"Arg `distance_metric` must be one of 'euclidean', 'chessboard', 'taxicab', but got {distance_metric}."
        )
    if spacing is not None and not isinstance(spacing, (list, tuple)) and not hasattr(spacing, "shape"):
        raise ValueError(f"Arg `spacing` must be a list or tensor, but got {type(spacing)}.")
    if not isinstance(directed, bool):
        raise ValueError(f"Expected argument `directed` must be a boolean, but got {directed}.")
    if input_format not in ["one-hot", "index", "mixed"]:
        raise ValueError(
            f"Expected argument `input_format` to be one of 'one-hot', 'index', 'mixed', but got {input_format}."
        )


def hausdorff_distance(
    preds,
    target,
    num_classes: int,
    include_background: bool = False,
    distance_metric: str = "euclidean",
    spacing: Optional[Union[torch.Tensor, Sequence[float]]] = None,
    directed: bool = False,
    input_format: str = "one-hot",
) -> torch.Tensor:
    """Hausdorff distance per (sample, class), ``(N, C)`` float32: from the predicted
    edges to the target's when ``directed``, else the larger of both directions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import hausdorff_distance
        >>> preds = torch.tensor([[[0, 1, 1, 0], [1, 1, 0, 0], [2, 2, 1, 0], [2, 0, 0, 0]]])
        >>> target = torch.tensor([[[0, 1, 1, 0], [1, 0, 0, 0], [2, 2, 0, 0], [2, 2, 0, 0]]])
        >>> hausdorff_distance(preds, target, num_classes=3, input_format='index')
        tensor([[2., 1.]])
    """
    _hausdorff_distance_validate_args(num_classes, include_background, distance_metric, spacing, directed, input_format)
    preds, target = _segmentation_inputs_format(preds, target, include_background, num_classes, input_format)
    if directed:
        return edge_surface_distance(preds, target, distance_metric, spacing, symmetric=False)
    d_pt, d_tp = edge_surface_distance(preds, target, distance_metric, spacing, symmetric=True)
    return torch.maximum(d_pt, d_tp)
