"""Pairwise box functions (counterpart of ``torchmetrics_tpu/functional/detection/_box_ops.py``).

Plain torch ops on the device of the boxes they are given. All accept leading batch
dimensions: ``(..., N, 4) x (..., M, 4) -> (..., N, M)``.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-7


def box_convert(boxes: torch.Tensor, in_fmt: str, out_fmt: str = "xyxy") -> torch.Tensor:
    """Convert ``(..., 4)`` boxes between xyxy / xywh / cxcywh formats."""
    if in_fmt == out_fmt:
        return boxes
    if out_fmt != "xyxy":
        raise ValueError(f"Only conversion to 'xyxy' is supported, got {out_fmt}")
    a, b, c, d = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    if in_fmt == "xywh":
        return torch.stack([a, b, a + c, b + d], dim=-1)
    if in_fmt == "cxcywh":
        return torch.stack([a - c / 2, b - d / 2, a + c / 2, b + d / 2], dim=-1)
    raise ValueError(f"Unsupported box format {in_fmt}")


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of ``(..., 4)`` xyxy boxes -> ``(...,)``."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``den > 0``, else 0."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)), torch.zeros_like(num))


def _pairwise_intersection(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(preds[..., :, None, :2], target[..., None, :, :2])
    rb = torch.minimum(preds[..., :, None, 2:], target[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def box_iou_matrix(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: ``(..., N, 4) x (..., M, 4) -> (..., N, M)``."""
    inter = _pairwise_intersection(preds, target)
    union = box_area(preds)[..., :, None] + box_area(target)[..., None, :] - inter
    return _safe_ratio(inter, union)


def box_iou_matrix_crowd(preds: torch.Tensor, target: torch.Tensor, crowd: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with the COCO crowd convention: for crowd ground truths the
    denominator is the detection area alone (pycocotools' iscrowd semantics)."""
    inter = _pairwise_intersection(preds, target)
    pred_area = box_area(preds)[..., :, None]
    union = pred_area + box_area(target)[..., None, :] - inter
    return _safe_ratio(inter, torch.where(crowd[..., None, :], pred_area, union))


def _enclosure_wh(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    lt = torch.minimum(preds[..., :, None, :2], target[..., None, :, :2])
    rb = torch.maximum(preds[..., :, None, 2:], target[..., None, :, 2:])
    return (rb - lt).clamp(min=0)


def generalized_box_iou_matrix(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU = IoU - (enclosure - union) / enclosure."""
    inter = _pairwise_intersection(preds, target)
    union = box_area(preds)[..., :, None] + box_area(target)[..., None, :] - inter
    whi = _enclosure_wh(preds, target)
    areai = whi[..., 0] * whi[..., 1]
    return _safe_ratio(inter, union) - _safe_ratio(areai - union, areai)


def _center_distance_ratio(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    whi = _enclosure_wh(preds, target)
    diag = whi[..., 0] ** 2 + whi[..., 1] ** 2 + _EPS
    cp = (preds[..., :2] + preds[..., 2:]) / 2
    ct = (target[..., :2] + target[..., 2:]) / 2
    d = cp[..., :, None, :] - ct[..., None, :, :]
    return (d[..., 0] ** 2 + d[..., 1] ** 2) / diag


def distance_box_iou_matrix(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pairwise DIoU = IoU - centre-distance^2 / enclosure-diagonal^2."""
    return box_iou_matrix(preds, target) - _center_distance_ratio(preds, target)


def complete_box_iou_matrix(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pairwise CIoU = DIoU - alpha * v (aspect-ratio consistency term)."""
    iou = box_iou_matrix(preds, target)
    diou = iou - _center_distance_ratio(preds, target)
    wp = preds[..., 2] - preds[..., 0]
    hp = preds[..., 3] - preds[..., 1]
    wt = target[..., 2] - target[..., 0]
    ht = target[..., 3] - target[..., 1]
    v = (4 / (math.pi**2)) * (torch.atan(wt / ht)[..., None, :] - torch.atan(wp / hp)[..., :, None]) ** 2
    alpha = v / (1 - iou + v + _EPS)
    return diou - alpha * v
