"""Detection input plumbing (counterpart of ``torchmetrics_tpu/detection/helpers.py``).

Validation of list-of-dict inputs, box normalization on the host, and the padded row
layout of the device evaluator. Inputs may be torch tensors on any device or numpy
arrays; everything here runs in numpy on the host.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from ..functional.detection._map_eval import _bucket
from ..utilities.prints import rank_zero_warn


def _to_numpy(x: Any) -> np.ndarray:
    """A host numpy view of a tensor (on any device) or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_arraylike(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _boxes_to_xyxy_np(boxes, box_format: str) -> np.ndarray:
    """(N, 4) float32 xyxy boxes on the host."""
    arr = _to_numpy(boxes).astype(np.float32)
    arr = arr.reshape(-1, 4) if arr.size else np.zeros((0, 4), np.float32)
    if arr.size == 0 or box_format == "xyxy":
        return arr
    a, b, c, d = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    if box_format == "xywh":
        return np.stack([a, b, a + c, b + d], axis=-1)
    if box_format == "cxcywh":
        return np.stack([a - c / 2, b - d / 2, a + c / 2, b + d / 2], axis=-1)
    raise ValueError(f"Unsupported box format {box_format}")


def _input_validator(
    preds: Sequence[Dict],
    targets: Sequence[Dict],
    iou_type: Union[str, Tuple[str, ...]] = "bbox",
    ignore_score: bool = False,
) -> None:
    """Ensure the correct input format of `preds` and `targets` (the reference's
    ``detection/helpers.py:41``)."""
    if isinstance(iou_type, str):
        iou_type = (iou_type,)
    name_map = {"bbox": "boxes", "segm": "masks"}
    if any(tp not in name_map for tp in iou_type):
        raise Exception(f"IOU type {iou_type} is not supported")
    item_val_name = [name_map[tp] for tp in iou_type]

    if not isinstance(preds, Sequence):
        raise ValueError(f"Expected argument `preds` to be of type Sequence, but got {preds}")
    if not isinstance(targets, Sequence):
        raise ValueError(f"Expected argument `target` to be of type Sequence, but got {targets}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )

    for k in [*item_val_name, "labels"] + (["scores"] if not ignore_score else []):
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in [*item_val_name, "labels"]:
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")

    for ivn in item_val_name:
        if not all(_is_arraylike(pred[ivn]) for pred in preds):
            raise ValueError(f"Expected all {ivn} in `preds` to be of type Tensor")
    if not ignore_score and not all(_is_arraylike(pred["scores"]) for pred in preds):
        raise ValueError("Expected all scores in `preds` to be of type Tensor")
    if not all(_is_arraylike(pred["labels"]) for pred in preds):
        raise ValueError("Expected all labels in `preds` to be of type Tensor")
    for ivn in item_val_name:
        if not all(_is_arraylike(target[ivn]) for target in targets):
            raise ValueError(f"Expected all {ivn} in `target` to be of type Tensor")
    if not all(_is_arraylike(target["labels"]) for target in targets):
        raise ValueError("Expected all labels in `target` to be of type Tensor")

    for i, item in enumerate(targets):
        for ivn in item_val_name:
            if item[ivn].shape[0] != item["labels"].shape[0]:
                raise ValueError(
                    f"Input '{ivn}' and labels of sample {i} in targets have a"
                    f" different length (expected {item[ivn].shape[0]} labels, got {item['labels'].shape[0]})"
                )
    if ignore_score:
        return
    for i, item in enumerate(preds):
        for ivn in item_val_name:
            if not (item[ivn].shape[0] == item["labels"].shape[0] == item["scores"].shape[0]):
                raise ValueError(
                    f"Input '{ivn}', labels and scores of sample {i} in predictions have a"
                    f" different length (expected {item[ivn].shape[0]} labels and scores,"
                    f" got {item['labels'].shape[0]} labels and {item['scores'].shape[0]} scores)"
                )


def _build_device_rows(
    preds: Sequence[Dict],
    targets: Sequence[Dict],
    box_format: str,
    num_classes: int,
    gt_group_cap: int,
    max_det: int,
    warn_many: bool = True,
) -> Tuple[np.ndarray, np.ndarray, int, int, int]:
    """Flatten one update batch into the device evaluator's padded row layout.

    Returns ``(det_rows, gt_rows, n_det, n_gt, n_img)`` where the row arrays are
    bucket-padded (next power of two, floor 8) so repeated updates reuse a handful of
    update shapes instead of one per batch shape. Image ids are batch-
    local (0..n_img); the device merge re-bases them against the absorbed image count.

    Invariants of the device layout that the device program cannot check are enforced here: labels in
    ``[0, num_classes)`` and at most ``gt_group_cap`` ground truths per (image, class)
    cell, the width of the matcher's gt window.
    """
    _input_validator(preds, targets, iou_type="bbox")
    det_parts, gt_parts = [], []
    for i, item in enumerate(preds):
        boxes = _boxes_to_xyxy_np(item["boxes"], box_format)
        labels = _to_numpy(item["labels"]).astype(np.int64).reshape(-1)
        scores = _to_numpy(item["scores"]).astype(np.float32).reshape(-1)
        if labels.size and (labels.min() < 0 or labels.max() >= num_classes):
            raise ValueError(
                f"Device mAP labels must lie in [0, {num_classes}) (the `num_classes` config); "
                f"sample {i} in predictions has labels outside that range"
            )
        if warn_many and labels.size > max_det:
            rank_zero_warn(
                f"Encountered more than {max_det} detections in a single image. "
                "This means that certain detections with the lowest scores will be ignored, that may have "
                "an undesirable impact on performance. Please consider adjusting the `max_detection_threshold` "
                "argument to adjust this behavior.",
                UserWarning,
            )
        det_parts.append(
            np.column_stack([
                np.full(labels.size, i, np.float32),
                labels.astype(np.float32),
                scores,
                boxes.astype(np.float32),
            ]).astype(np.float32)
        )
    for i, item in enumerate(targets):
        labels = _to_numpy(item["labels"]).astype(np.int64).reshape(-1)
        boxes = _boxes_to_xyxy_np(item["boxes"], box_format)
        if labels.size and (labels.min() < 0 or labels.max() >= num_classes):
            raise ValueError(
                f"Device mAP labels must lie in [0, {num_classes}) (the `num_classes` config); "
                f"sample {i} in target has labels outside that range"
            )
        if labels.size:
            _, counts = np.unique(labels, return_counts=True)
            if counts.max() > gt_group_cap:
                raise ValueError(
                    f"Sample {i} in target has {int(counts.max())} ground truths for one class, but the "
                    f"device evaluator's gt window is capped at gt_group_cap={gt_group_cap}. "
                    "Raise `gt_group_cap` on the metric."
                )
        crowd = item.get("iscrowd")
        crowd = (
            _to_numpy(crowd).astype(np.float32).reshape(-1) if crowd is not None else np.zeros(labels.size, np.float32)
        )
        area = item.get("area")
        area = (
            _to_numpy(area).astype(np.float32).reshape(-1) if area is not None else np.zeros(labels.size, np.float32)
        )
        gt_parts.append(
            np.column_stack([
                np.full(labels.size, i, np.float32),
                labels.astype(np.float32),
                crowd,
                area,
                boxes.astype(np.float32),
            ]).astype(np.float32)
        )
    det = np.concatenate(det_parts, axis=0) if det_parts else np.zeros((0, 7), np.float32)
    gt = np.concatenate(gt_parts, axis=0) if gt_parts else np.zeros((0, 8), np.float32)
    n_det, n_gt, n_img = det.shape[0], gt.shape[0], len(preds)
    det_pad = np.zeros((_bucket(max(n_det, 1), floor=8), 7), np.float32)
    det_pad[:n_det] = det
    gt_pad = np.zeros((_bucket(max(n_gt, 1), floor=8), 8), np.float32)
    gt_pad[:n_gt] = gt
    return det_pad, gt_pad, n_det, n_gt, n_img
