"""One-shot functional COCO mAP (counterpart of
``torchmetrics_tpu/functional/detection/map.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch


def mean_average_precision(
    preds: List[Dict[str, Any]],
    target: List[Dict[str, Any]],
    box_format: str = "xyxy",
    iou_type: Union[str, Tuple[str, ...]] = "bbox",
    iou_thresholds: Optional[List[float]] = None,
    rec_thresholds: Optional[List[float]] = None,
    max_detection_thresholds: Optional[List[int]] = None,
    class_metrics: bool = False,
    extended_summary: bool = False,
    average: str = "macro",
    backend: str = "pycocotools",
    warn_on_many_detections: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Any]:
    """COCO mAP/mAR over one batch of detections: the stateful metric run once, on
    ``device`` (the card if None)."""
    from ...detection.mean_ap import MeanAveragePrecision

    metric = MeanAveragePrecision(
        box_format=box_format,
        iou_type=iou_type,
        iou_thresholds=iou_thresholds,
        rec_thresholds=rec_thresholds,
        max_detection_thresholds=max_detection_thresholds,
        class_metrics=class_metrics,
        extended_summary=extended_summary,
        average=average,
        backend=backend,
        device=device,
    )
    metric.warn_on_many_detections = warn_on_many_detections
    metric.update(preds, target)
    return metric.compute()
