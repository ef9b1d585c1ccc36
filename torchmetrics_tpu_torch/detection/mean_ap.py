"""MeanAveragePrecision, COCO mAP (counterpart of ``torchmetrics_tpu/detection/mean_ap.py``).

Two evaluators, as in the JAX package:

- ``MeanAveragePrecision`` keeps the inputs as flat host rows (boxes, scores, labels)
  plus per-image counts, and evaluates on the host with the greedy matcher on the
  metric's device (``functional/detection/_map_eval.py``). Its list states are CPU
  tensors: a sync moves them to the transport and back.
- ``DeviceMeanAveragePrecision`` (``MeanAveragePrecision(backend="device")``) keeps a
  fixed-capacity padded row state on the device and runs the whole evaluation as one
  torch function over it (``functional/detection/_map_device.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..functional.detection._map_device import build_mapeval_program
from ..functional.detection._map_eval import (
    DEFAULT_IOU_THRESHOLDS,
    DEFAULT_REC_THRESHOLDS,
    MAPInputs,
    evaluate_map,
    summarize,
)
from ..metric import HostMetric, Metric
from ..utilities.exceptions import TorchMetricsUserError
from ..utilities.prints import rank_zero_warn
from .helpers import _boxes_to_xyxy_np, _build_device_rows, _input_validator, _to_numpy

_MASK_STATES = ("detection_mask", "groundtruth_mask")


def _split_by_counts(flat: np.ndarray, counts: np.ndarray) -> List[np.ndarray]:
    """Per-image arrays from flat rows and per-image counts."""
    return np.split(flat, np.cumsum(counts)[:-1]) if counts.size else []


def _f32(value: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


def _summary_keys(max_detection_thresholds: List[int]) -> Tuple[str, ...]:
    return (
        "map", "map_50", "map_75", "map_small", "map_medium", "map_large",
        *(f"mar_{m}" for m in max_detection_thresholds),
        "mar_small", "mar_medium", "mar_large",
    )


def _check_config(
    box_format: str,
    iou_thresholds: Optional[List[float]],
    rec_thresholds: Optional[List[float]],
    max_detection_thresholds: Optional[List[int]],
    class_metrics: bool,
    extended_summary: bool,
) -> Tuple[List[float], List[float], List[int]]:
    """Validate the arguments both evaluators share; returns the thresholds with their
    defaults filled in (the reference's float32-quantized ``torch.linspace`` values)."""
    allowed_box_formats = ("xyxy", "xywh", "cxcywh")
    if box_format not in allowed_box_formats:
        raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
    if iou_thresholds is not None and not isinstance(iou_thresholds, list):
        raise ValueError(
            f"Expected argument `iou_thresholds` to either be `None` or a list of floats but got {iou_thresholds}"
        )
    if rec_thresholds is not None and not isinstance(rec_thresholds, list):
        raise ValueError(
            f"Expected argument `rec_thresholds` to either be `None` or a list of floats but got {rec_thresholds}"
        )
    if max_detection_thresholds is not None and not isinstance(max_detection_thresholds, list):
        raise ValueError(
            f"Expected argument `max_detection_thresholds` to either be `None` or a list of ints"
            f" but got {max_detection_thresholds}"
        )
    if max_detection_thresholds is not None and len(max_detection_thresholds) != 3:
        raise ValueError(
            "When providing a list of max detection thresholds it should have length 3."
            f" Got value {len(max_detection_thresholds)}"
        )
    if not isinstance(class_metrics, bool):
        raise ValueError("Expected argument `class_metrics` to be a boolean")
    if not isinstance(extended_summary, bool):
        raise ValueError("Expected argument `extended_summary` to be a boolean")
    return (
        iou_thresholds or list(DEFAULT_IOU_THRESHOLDS),
        rec_thresholds or list(DEFAULT_REC_THRESHOLDS),
        sorted(max_detection_thresholds or [1, 10, 100]),
    )


class MeanAveragePrecision(HostMetric):
    """Mean Average Precision / Recall for object detection (COCO protocol).

    ``box_format`` xyxy/xywh/cxcywh, ``iou_type`` "bbox"/"segm" or a tuple of both,
    custom IoU/recall/max-detection thresholds, ``class_metrics``, ``extended_summary``
    and ``average`` macro/micro, as in the JAX package. ``backend`` is accepted for API
    parity; ``backend="device"`` builds a :class:`DeviceMeanAveragePrecision`.
    ``target`` dicts may carry ``iscrowd`` and ``area``; crowd ground truths use the
    COCO crowd-IoU convention and are ignored in scoring.

    Values come back as float32 tensors on the metric's device (``extended_summary``'s
    per-cell ``ious`` stay on the host); ``last_compute_seconds`` holds the seconds of
    the last ``compute()``'s parts (``rows``, ``iou``, ``matcher``, ``accumulate``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import MeanAveragePrecision
        >>> preds = [{'boxes': torch.tensor([[258.0, 41.0, 606.0, 285.0]]), 'scores': torch.tensor([0.536]), 'labels': torch.tensor([0])}]
        >>> target = [{'boxes': torch.tensor([[214.0, 41.0, 562.0, 285.0]]), 'labels': torch.tensor([0])}]
        >>> metric = MeanAveragePrecision(iou_type='bbox', device='cpu')
        >>> metric.update(preds, target)
        >>> result = metric.compute()
        >>> round(float(result['map']), 4), round(float(result['map_50']), 4)
        (0.6, 1.0)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    warn_on_many_detections: bool = True

    def __new__(cls, *args: Any, **kwargs: Any) -> "MeanAveragePrecision":
        # backend="device" builds the device evaluator; returning an instance of
        # another class skips this __init__
        if cls is MeanAveragePrecision and kwargs.get("backend") == "device":
            return DeviceMeanAveragePrecision(*args, **kwargs)
        return super().__new__(cls)

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        backend: str = "pycocotools",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.iou_thresholds, self.rec_thresholds, self.max_detection_thresholds = _check_config(
            box_format, iou_thresholds, rec_thresholds, max_detection_thresholds, class_metrics, extended_summary)
        self.box_format = box_format
        self.iou_type = (iou_type,) if isinstance(iou_type, str) else tuple(iou_type)
        if any(tp not in ("bbox", "segm") for tp in self.iou_type):
            raise ValueError(f"Expected argument `iou_type` to be one of ('bbox', 'segm') but got {iou_type}")
        self.class_metrics = class_metrics
        self.extended_summary = extended_summary
        if average not in ("macro", "micro"):
            raise ValueError(f"Expected argument `average` to be one of ('macro', 'micro') but got {average}")
        self.average = average
        if backend not in ("pycocotools", "faster_coco_eval"):
            raise ValueError(
                f"Expected argument `backend` to be one of ('pycocotools', 'faster_coco_eval') but got {backend}"
            )
        self.backend = backend  # accepted for parity: the evaluator is always the in-tree one
        self.last_compute_seconds: Dict[str, float] = {}

        for name in ("detection_box", "detection_scores", "detection_labels", "detection_counts", "groundtruth_box",
                     "groundtruth_labels", "groundtruth_crowds", "groundtruth_area", "groundtruth_counts"):
            self.add_state(name, default=[], dist_reduce_fx="cat")
        if "segm" in self.iou_type:
            # ragged (N, H, W) per image: lists of per-image masks, extended
            for name in _MASK_STATES:
                self.add_state(name, default=[], dist_reduce_fx="cat")

    # ------------------------------------------------------------------ update

    def _host_batch_state(self, preds: Sequence[Dict], target: Sequence[Dict]) -> Dict[str, Any]:
        _input_validator(preds, target, iou_type=self.iou_type)
        det_box, det_score, det_label, det_count = [], [], [], []
        det_mask, gt_mask = [], []
        gt_box, gt_label, gt_crowd, gt_area, gt_count = [], [], [], [], []
        bbox = "bbox" in self.iou_type
        for item in preds:
            labels = _to_numpy(item["labels"]).astype(np.int32).reshape(-1)
            boxes = _boxes_to_xyxy_np(item["boxes"], self.box_format) if bbox else np.zeros((labels.size, 4), np.float32)
            scores = _to_numpy(item["scores"]).astype(np.float32).reshape(-1)
            if self.warn_on_many_detections and labels.size > self.max_detection_thresholds[-1]:
                rank_zero_warn(
                    f"Encountered more than {self.max_detection_thresholds[-1]} detections in a single image. "
                    "This means that certain detections with the lowest scores will be ignored, that may have "
                    "an undesirable impact on performance. Please consider adjusting the `max_detection_threshold` "
                    "argument to adjust this behavior.",
                    UserWarning,
                )
            det_box.append(boxes)
            det_score.append(scores)
            det_label.append(labels)
            det_count.append(labels.size)
            if "segm" in self.iou_type:
                det_mask.append(torch.from_numpy(_to_numpy(item["masks"]).astype(bool)))
        for item in target:
            labels = _to_numpy(item["labels"]).astype(np.int32).reshape(-1)
            gt_box.append(_boxes_to_xyxy_np(item["boxes"], self.box_format) if bbox else np.zeros((labels.size, 4), np.float32))
            gt_label.append(labels)
            crowd = item.get("iscrowd")
            gt_crowd.append(
                _to_numpy(crowd).astype(np.int32).reshape(-1) if crowd is not None else np.zeros(labels.size, np.int32)
            )
            area = item.get("area")
            gt_area.append(
                _to_numpy(area).astype(np.float32).reshape(-1) if area is not None else np.zeros(labels.size, np.float32)
            )
            gt_count.append(labels.size)
            if "segm" in self.iou_type:
                gt_mask.append(torch.from_numpy(_to_numpy(item["masks"]).astype(bool)))

        def cat(parts, dtype, width=None):  # one host tensor per state and batch
            flat = np.concatenate(parts).astype(dtype) if parts else np.zeros((0,) if width is None else (0, width), dtype)
            return torch.from_numpy(flat)

        out = {
            "detection_box": cat(det_box, np.float32, 4),
            "detection_scores": cat(det_score, np.float32),
            "detection_labels": cat(det_label, np.int32),
            "detection_counts": torch.as_tensor(det_count, dtype=torch.int32),
            "groundtruth_box": cat(gt_box, np.float32, 4),
            "groundtruth_labels": cat(gt_label, np.int32),
            "groundtruth_crowds": cat(gt_crowd, np.int32),
            "groundtruth_area": cat(gt_area, np.float32),
            "groundtruth_counts": torch.as_tensor(gt_count, dtype=torch.int32),
        }
        if "segm" in self.iou_type:
            out["detection_mask"] = det_mask
            out["groundtruth_mask"] = gt_mask
        return out

    def _fold(self, batch: Dict[str, Any]) -> None:
        # mask entries are lists of ragged per-image masks: extend instead of append
        batch = dict(batch)
        for key in _MASK_STATES:
            if key in batch:
                self._state[key].extend(batch.pop(key))
        super()._fold(batch)

    def _concat_state(self, state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        state = self._state if state is None else state
        out = {}
        for k, v in state.items():
            if k in _MASK_STATES:
                flat: list = []
                for e in v if isinstance(v, list) else [v]:
                    flat.extend(e) if isinstance(e, list) else flat.append(e)
                out[k] = flat
            elif isinstance(v, list):
                if len(v) == 0:
                    out[k] = torch.zeros((0, 4) if k.endswith("_box") else (0,), dtype=torch.float32)
                else:
                    out[k] = torch.cat([torch.as_tensor(e).cpu() for e in v], dim=0)
            else:
                out[k] = v
        return out

    # ----------------------------------------------------------------- compute

    def _inputs_from_state(self, state: Dict[str, Any]) -> MAPInputs:
        det_counts = _to_numpy(state["detection_counts"]).astype(np.int64).reshape(-1)
        gt_counts = _to_numpy(state["groundtruth_counts"]).astype(np.int64).reshape(-1)
        det_masks = state.get("detection_mask")
        gt_masks = state.get("groundtruth_mask")
        det_masks = [_to_numpy(m) for m in det_masks] if det_masks else None
        gt_masks = [_to_numpy(m) for m in gt_masks] if gt_masks else None
        f64 = lambda k: _to_numpy(state[k]).astype(np.float64)  # noqa: E731
        return MAPInputs(
            det_boxes=_split_by_counts(f64("detection_box").reshape(-1, 4), det_counts),
            det_scores=_split_by_counts(f64("detection_scores").reshape(-1), det_counts),
            det_labels=_split_by_counts(_to_numpy(state["detection_labels"]).reshape(-1), det_counts),
            gt_boxes=_split_by_counts(f64("groundtruth_box").reshape(-1, 4), gt_counts),
            gt_labels=_split_by_counts(_to_numpy(state["groundtruth_labels"]).reshape(-1), gt_counts),
            gt_crowds=_split_by_counts(_to_numpy(state["groundtruth_crowds"]).reshape(-1), gt_counts),
            gt_areas=_split_by_counts(f64("groundtruth_area").reshape(-1), gt_counts),
            det_masks=det_masks,
            gt_masks=gt_masks,
        )

    def _compute(self, state: Dict[str, Any]) -> Dict[str, Any]:
        timings: Dict[str, float] = {}
        self.last_compute_seconds = timings
        inputs = self._inputs_from_state(state)
        if self.average == "micro":
            micro_inputs = MAPInputs(
                det_boxes=inputs.det_boxes,
                det_scores=inputs.det_scores,
                det_labels=[np.zeros_like(x) for x in inputs.det_labels],
                gt_boxes=inputs.gt_boxes,
                gt_labels=[np.zeros_like(x) for x in inputs.gt_labels],
                gt_crowds=inputs.gt_crowds,
                gt_areas=inputs.gt_areas,
                det_masks=inputs.det_masks,
                gt_masks=inputs.gt_masks,
            )
        result: Dict[str, Any] = {}
        for i_type in self.iou_type:
            prefix = "" if len(self.iou_type) == 1 else f"{i_type}_"
            main_inputs = micro_inputs if self.average == "micro" else inputs
            if inputs.num_images == 0:
                for key in _summary_keys(self.max_detection_thresholds):
                    result[f"{prefix}{key}"] = _f32(-1.0, self.device)
                result[f"{prefix}map_per_class"] = _f32([-1.0], self.device)
                result[f"{prefix}mar_{self.max_detection_thresholds[-1]}_per_class"] = _f32([-1.0], self.device)
                continue
            ev = evaluate_map(
                main_inputs, i_type, self.iou_thresholds, self.rec_thresholds,
                self.max_detection_thresholds, want_ious=self.extended_summary, device=self.device,
                timings=timings,
            )
            stats = summarize(ev["precision"], ev["recall"], self.iou_thresholds, self.max_detection_thresholds)
            for key, val in stats.items():
                result[f"{prefix}{key}"] = _f32(val, self.device)
            if self.extended_summary:
                result[f"{prefix}ious"] = {k: torch.from_numpy(v) for k, v in ev["ious"].items()}  # host
                result[f"{prefix}precision"] = _f32(ev["precision"], self.device)
                result[f"{prefix}recall"] = _f32(ev["recall"], self.device)
                result[f"{prefix}scores"] = _f32(ev["scores"], self.device)
            if self.class_metrics:
                # per-class eval always uses the true labels (the reference's helpers.py:744-758)
                ev_cls = (
                    ev
                    if self.average == "macro"
                    else evaluate_map(
                        inputs, i_type, self.iou_thresholds, self.rec_thresholds, self.max_detection_thresholds,
                        device=self.device, timings=timings,
                    )
                )
                map_pc, mar_pc = [], []
                for k_idx in range(len(ev_cls["classes"])):
                    s = summarize(
                        ev_cls["precision"], ev_cls["recall"], self.iou_thresholds,
                        self.max_detection_thresholds, class_idx=k_idx,
                    )
                    map_pc.append(s["map"])
                    mar_pc.append(s[f"mar_{self.max_detection_thresholds[-1]}"])
                result[f"{prefix}map_per_class"] = _f32(map_pc, self.device)
                result[f"{prefix}mar_{self.max_detection_thresholds[-1]}_per_class"] = _f32(mar_pc, self.device)
            else:
                result[f"{prefix}map_per_class"] = _f32(-1.0, self.device)
                result[f"{prefix}mar_{self.max_detection_thresholds[-1]}_per_class"] = _f32(-1.0, self.device)
        classes = inputs.classes()
        result["classes"] = torch.as_tensor(np.asarray(classes, np.int32), device=self.device)
        return result

    # ------------------------------------------------------------- converters

    def tm_to_coco(self, name: str = "tm_map_input") -> None:
        """Dump the cached inputs to ``{name}_preds.json`` / ``{name}_target.json`` in
        COCO format (the reference's ``detection/mean_ap.py:430``; no pycocotools needed
        for bbox)."""
        import json

        state = self._concat_state()
        inputs = self._inputs_from_state(state)
        images = [{"id": i} for i in range(inputs.num_images)]
        classes = [{"id": int(c), "name": str(int(c))} for c in inputs.classes()]
        annotations = []
        ann_id = 1
        for i in range(inputs.num_images):
            for j in range(inputs.gt_labels[i].size):
                x1, y1, x2, y2 = inputs.gt_boxes[i][j].tolist()
                annotations.append({
                    "id": ann_id,
                    "image_id": i,
                    "category_id": int(inputs.gt_labels[i][j]),
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "area": float(inputs.gt_areas[i][j]) if inputs.gt_areas[i][j] > 0 else float((x2 - x1) * (y2 - y1)),
                    "iscrowd": int(inputs.gt_crowds[i][j]),
                })
                ann_id += 1
        target_dict = {"images": images, "annotations": annotations, "categories": classes}
        preds_list = []
        for i in range(inputs.num_images):
            for j in range(inputs.det_labels[i].size):
                x1, y1, x2, y2 = inputs.det_boxes[i][j].tolist()
                preds_list.append({
                    "image_id": i,
                    "category_id": int(inputs.det_labels[i][j]),
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "score": float(inputs.det_scores[i][j]),
                })
        with open(f"{name}_preds.json", "w") as f:
            json.dump(preds_list, f)
        with open(f"{name}_target.json", "w") as f:
            json.dump(target_dict, f)

    @staticmethod
    def coco_to_tm(
        coco_preds: str,
        coco_target: str,
        iou_type: Union[str, Tuple[str, ...]] = ("bbox",),
        backend: str = "pycocotools",
    ) -> Tuple[List[Dict[str, torch.Tensor]], List[Dict[str, torch.Tensor]]]:
        """Load COCO-format json files into this metric's input format (the reference's
        ``detection/mean_ap.py:475``; bbox only, no pycocotools needed), as host
        tensors."""
        import json

        with open(coco_target) as f:
            tgt = json.load(f)
        with open(coco_preds) as f:
            prd = json.load(f)
        img_ids = sorted(img["id"] for img in tgt["images"])
        by_img_t: Dict[Any, Dict[str, list]] = {i: {"boxes": [], "labels": [], "iscrowd": [], "area": []} for i in img_ids}
        for ann in tgt["annotations"]:
            x, y, w, h = ann["bbox"]
            rec = by_img_t[ann["image_id"]]
            rec["boxes"].append([x, y, x + w, y + h])
            rec["labels"].append(ann["category_id"])
            rec["iscrowd"].append(ann.get("iscrowd", 0))
            rec["area"].append(ann.get("area", w * h))
        by_img_p: Dict[Any, Dict[str, list]] = {i: {"boxes": [], "labels": [], "scores": []} for i in img_ids}
        for ann in prd if isinstance(prd, list) else prd["annotations"]:
            x, y, w, h = ann["bbox"]
            rec = by_img_p[ann["image_id"]]
            rec["boxes"].append([x, y, x + w, y + h])
            rec["labels"].append(ann["category_id"])
            rec["scores"].append(ann["score"])
        target_out = [
            {
                "boxes": torch.from_numpy(np.asarray(r["boxes"], np.float32).reshape(-1, 4)),
                "labels": torch.from_numpy(np.asarray(r["labels"], np.int32)),
                "iscrowd": torch.from_numpy(np.asarray(r["iscrowd"], np.int32)),
                "area": torch.from_numpy(np.asarray(r["area"], np.float32)),
            }
            for r in (by_img_t[i] for i in img_ids)
        ]
        preds_out = [
            {
                "boxes": torch.from_numpy(np.asarray(r["boxes"], np.float32).reshape(-1, 4)),
                "labels": torch.from_numpy(np.asarray(r["labels"], np.int32)),
                "scores": torch.from_numpy(np.asarray(r["scores"], np.float32)),
            }
            for r in (by_img_p[i] for i in img_ids)
        ]
        return preds_out, target_out


class _MapevalProgram(torch.nn.Module):
    """The device evaluator in the AOT plane's calling convention."""

    def __init__(self, mapeval) -> None:
        super().__init__()
        self.mapeval = mapeval

    def forward(self, tensors: Dict[str, torch.Tensor], n: torch.Tensor, args: tuple, kwargs: dict):
        return self.mapeval(tensors)


class DeviceMeanAveragePrecision(Metric):
    """COCO mAP as one torch function over a fixed-capacity padded row state on the
    device (``MeanAveragePrecision(backend="device")``).

    State: ``det_rows (capacity, 7)``, ``gt_rows (capacity, 8)`` float32 and int32
    cursors ``det_n``, ``gt_n``, ``img_n``, on the metric's device. ``update`` builds a
    batch's rows on the host, copies them once and appends them at the cursors on the
    device; ``compute()`` runs the whole evaluation (greedy matcher, accumulation,
    summary: ``functional/detection/_map_device.py``) on the device and reads the
    summary back.

    - ``capacity``: the most rows accumulated, for detections and ground truths each.
      Overflow raises ``TorchMetricsUserError`` in ``update``, before the append.
    - ``num_classes``: labels must lie in ``[0, num_classes)``.
    - ``gt_group_cap``: the most ground truths in one (image, class) cell, the width of
      the matcher's gt window.

    Restrictions against the host evaluator: ``iou_type="bbox"``, ``average="macro"``
    and ``extended_summary=False`` only. IoU and recall thresholds resolve in float32,
    as in the JAX package: an IoU within float32 rounding of a threshold, or a recall
    that rounds onto one, resolves the other way. At COCO scale the values agree with
    the host evaluator's within 1e-4; with a few ground truths per class they may not.
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True
    _jittable_compute = False  # its compute is a host-orchestrated pass, as in the JAX package
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    warn_on_many_detections: bool = True

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        backend: str = "device",
        capacity: int = 4096,
        num_classes: int = 80,
        gt_group_cap: int = 32,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.iou_thresholds, self.rec_thresholds, self.max_detection_thresholds = _check_config(
            box_format, iou_thresholds, rec_thresholds, max_detection_thresholds, class_metrics, extended_summary)
        self.box_format = box_format
        iou_type = (iou_type,) if isinstance(iou_type, str) else tuple(iou_type)
        if iou_type != ("bbox",):
            raise ValueError(
                f"The device mAP evaluator supports `iou_type='bbox'` only, got {iou_type}. "
                "Use the host backend for segmentation IoU."
            )
        self.iou_type = iou_type
        self.class_metrics = class_metrics
        if extended_summary:
            raise ValueError(
                "The device mAP evaluator does not materialize the extended summary "
                "(precision/recall/score tensors stay on the device); use the host backend."
            )
        self.extended_summary = False
        if average != "macro":
            raise ValueError(f"The device mAP evaluator supports `average='macro'` only, got {average}")
        self.average = average
        if backend != "device":
            raise ValueError(f"Expected argument `backend` to be 'device' but got {backend}")
        self.backend = backend
        for name, val in (("capacity", capacity), ("num_classes", num_classes), ("gt_group_cap", gt_group_cap)):
            if not isinstance(val, int) or val <= 0:
                raise ValueError(f"Expected argument `{name}` to be a positive int but got {val}")
        self.capacity = capacity
        self.num_classes = num_classes
        self.gt_group_cap = gt_group_cap
        self._mapeval = build_mapeval_program(
            capacity, num_classes, gt_group_cap, self.iou_thresholds, self.rec_thresholds,
            self.max_detection_thresholds,
        )

        self.add_state("det_rows", default=torch.zeros((capacity, 7), dtype=torch.float32))
        self.add_state("gt_rows", default=torch.zeros((capacity, 8), dtype=torch.float32))
        self.add_state("det_n", default=torch.zeros((), dtype=torch.int32))
        self.add_state("gt_n", default=torch.zeros((), dtype=torch.int32))
        self.add_state("img_n", default=torch.zeros((), dtype=torch.int32))
        # host mirror of the cursors: the device append drops rows past the capacity,
        # so overflow must raise before it
        self._rows_used = {"det": 0, "gt": 0, "img": 0}

    # ------------------------------------------------------------------ update

    def _prepare_inputs(self, preds: Sequence[Dict], target: Sequence[Dict]) -> Tuple[tuple, dict]:
        det_rows, gt_rows, n_det, n_gt, n_img = _build_device_rows(
            preds,
            target,
            box_format=self.box_format,
            num_classes=self.num_classes,
            gt_group_cap=self.gt_group_cap,
            max_det=self.max_detection_thresholds[-1],
            warn_many=self.warn_on_many_detections,
        )
        for kind, n in (("det", n_det), ("gt", n_gt)):
            if self._rows_used[kind] + n > self.capacity:
                raise TorchMetricsUserError(
                    f"Device mAP state overflow: accumulating {n} more {kind} rows would exceed "
                    f"capacity={self.capacity} ({self._rows_used[kind]} already used). Raise `capacity` "
                    "or compute/reset more often."
                )
        if (self._rows_used["img"] + n_img) * self.num_classes >= np.iinfo(np.int32).max:
            raise TorchMetricsUserError(
                "Device mAP image count overflow: image_count * num_classes must stay below 2**31 "
                "(the evaluator's int32 cell keys)."
            )
        self._rows_used["det"] += n_det
        self._rows_used["gt"] += n_gt
        self._rows_used["img"] += n_img
        counts = torch.tensor([n_det, n_gt, n_img], dtype=torch.int32)
        on = lambda a: torch.from_numpy(a).to(self.device, non_blocking=True)  # noqa: E731
        return (on(det_rows), on(gt_rows), *counts.to(self.device).unbind()), {}

    def _batch_state(self, det_rows, gt_rows, det_n, gt_n, img_n) -> Dict[str, torch.Tensor]:
        return {"det_rows": det_rows, "gt_rows": gt_rows, "det_n": det_n, "gt_n": gt_n, "img_n": img_n}

    @staticmethod
    def _append_rows(rows: torch.Tensor, at: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        """``rows`` with ``new`` written from row ``at`` on, rows past the capacity
        dropped, without reading ``at`` on the host: those rows go to a spare row that
        is cut off."""
        cap = rows.shape[0]
        idx = (at.long() + torch.arange(new.shape[0], device=rows.device)).clamp(max=cap)
        spare = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        return spare.index_copy_(0, idx, new)[:cap]

    def _merge(self, a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # b's image ids are local to its batch (or rank): re-base them by the images a
        # has already absorbed. The host sentinel in _prepare_inputs raises before
        # any row would be dropped here.
        off = a["img_n"].to(torch.float32)
        b_det = torch.cat([b["det_rows"][:, :1] + off, b["det_rows"][:, 1:]], dim=1)
        b_gt = torch.cat([b["gt_rows"][:, :1] + off, b["gt_rows"][:, 1:]], dim=1)
        return {
            "det_rows": self._append_rows(a["det_rows"], a["det_n"], b_det),
            "gt_rows": self._append_rows(a["gt_rows"], a["gt_n"], b_gt),
            "det_n": a["det_n"] + b["det_n"],
            "gt_n": a["gt_n"] + b["gt_n"],
            "img_n": a["img_n"] + b["img_n"],
        }

    def reset(self) -> None:
        super().reset()
        self._rows_used = {"det": 0, "gt": 0, "img": 0}

    # ----------------------------------------------------------------- compute

    # -------------------------------------------------------------- warm start

    def _aot_program(self, tag: str) -> torch.nn.Module:
        """``"mapeval"``: the evaluator over the padded state (no inputs); other tags are
        the base class's."""
        if tag == "mapeval":
            return _MapevalProgram(self._mapeval)
        return super()._aot_program(tag)

    def precompile(
        self,
        *example_inputs: Any,
        tags: Sequence[str] = ("mapeval",),
        cache_dir: Optional[str] = None,
        force: bool = False,
        **example_kwargs: Any,
    ) -> Dict[str, Any]:
        """Like :meth:`Metric.precompile`, plus the ``"mapeval"`` evaluator program.

        The evaluator's dispatch signature is empty (it reads only the padded state), so
        ``"mapeval"`` needs no example inputs; other tags go to the base implementation
        with whatever examples are given. Under ``torch.export`` the evaluator's matcher
        is one traced loop over fixed-width chunks of each rank's detections (the JAX
        package's ``fori_loop``), so the program exports; a loaded program then serves
        ``compute()``.
        """
        tags = tuple(tags)
        rest = tuple(t for t in tags if t != "mapeval")
        report = super().precompile(*example_inputs, tags=rest, cache_dir=cache_dir, force=force,
                                    **example_kwargs) if rest else {}
        if "mapeval" in tags:
            tensors = {k: self._state[k] for k in ("det_rows", "gt_rows", "det_n", "gt_n", "img_n")}
            report["mapeval"] = self._aot_plane(cache_dir).precompile_program(
                self, "mapeval", self._aot_program("mapeval"), tensors, (), {}, force=force)
        return report

    def _empty_result(self) -> Dict[str, torch.Tensor]:
        # no images seen: the host evaluator's sentinel dict, key for key
        result = {key: _f32(-1.0, self.device) for key in _summary_keys(self.max_detection_thresholds)}
        result["map_per_class"] = _f32([-1.0], self.device)
        result[f"mar_{self.max_detection_thresholds[-1]}_per_class"] = _f32([-1.0], self.device)
        result["classes"] = torch.zeros((0,), dtype=torch.int32, device=self.device)
        return result

    def _compute(self, state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if int(state["img_n"]) == 0:
            return self._empty_result()
        tensors = {k: state[k] for k in ("det_rows", "gt_rows", "det_n", "gt_n", "img_n")}
        out = self._program_dispatch("mapeval", tensors, ((), {}), lambda: self._mapeval(tensors))
        last = self.max_detection_thresholds[-1]
        result = {key: out[key].to(torch.float32) for key in _summary_keys(self.max_detection_thresholds)}
        present = out["present"]
        if self.class_metrics:
            result["map_per_class"] = out["map_per_class"][present].to(torch.float32)
            result[f"mar_{last}_per_class"] = out["mar_per_class"][present].to(torch.float32)
        else:
            result["map_per_class"] = _f32(-1.0, self.device)
            result[f"mar_{last}_per_class"] = _f32(-1.0, self.device)
        result["classes"] = torch.nonzero(present).reshape(-1).to(torch.int32)
        return result
