"""IntersectionOverUnion metric class (counterpart of ``torchmetrics_tpu/detection/iou.py``).

Every (detection, ground truth) entry of an image's IoU matrix becomes one flat row:
``iou_values`` plus the gt label of its column. Compute is three masked reductions over
one flat array, and the state gathers across processes as plain concatenations. The
matrices are computed on the metric's device; the rows are kept on the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..functional.detection.iou import _iou_update
from ..metric import HostMetric
from .helpers import _boxes_to_xyxy_np, _input_validator, _to_numpy


class IntersectionOverUnion(HostMetric):
    """Intersection Over Union (IoU) over list-of-dict box inputs.

    ``update`` takes ``preds``/``target`` lists of per-image dicts with ``boxes``
    (N, 4) and ``labels`` (N,) (``scores`` are ignored); ``compute`` returns
    ``{"iou": mean, ...}`` with per-class entries under ``class_metrics``, as float32
    tensors on the metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import IntersectionOverUnion
        >>> preds = [{'boxes': torch.tensor([[296.55, 93.96, 314.97, 152.79]]), 'scores': torch.tensor([0.236]), 'labels': torch.tensor([4])}]
        >>> target = [{'boxes': torch.tensor([[300.00, 100.00, 315.00, 150.00]]), 'labels': torch.tensor([4])}]
        >>> metric = IntersectionOverUnion(device='cpu')
        >>> metric.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'iou': 0.6898}
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True

    _iou_type: str = "iou"
    _invalid_val: float = -1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.respect_labels = respect_labels

        self.add_state("iou_values", default=[], dist_reduce_fx="cat")
        self.add_state("iou_col_labels", default=[], dist_reduce_fx="cat")
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx="cat")
        self.add_state("pred_labels", default=[], dist_reduce_fx="cat")

    @staticmethod
    def _iou_update_fn(*args: Any, **kwargs: Any) -> torch.Tensor:
        return _iou_update(*args, **kwargs)

    def _host_batch_state(self, preds: Sequence[Dict], target: Sequence[Dict]) -> Dict[str, torch.Tensor]:
        _input_validator(preds, target, ignore_score=True)
        values: List[np.ndarray] = []
        col_labels: List[np.ndarray] = []
        gt_labels: List[np.ndarray] = []
        pr_labels: List[np.ndarray] = []
        for p_i, t_i in zip(preds, target):
            det_boxes = _boxes_to_xyxy_np(p_i["boxes"], self.box_format)
            gt_boxes = _boxes_to_xyxy_np(t_i["boxes"], self.box_format)
            p_lab = _to_numpy(p_i["labels"]).astype(np.int32).reshape(-1)
            t_lab = _to_numpy(t_i["labels"]).astype(np.int32).reshape(-1)
            gt_labels.append(t_lab)
            pr_labels.append(p_lab)

            mat = _to_numpy(self._iou_update_fn(
                torch.from_numpy(det_boxes).to(self.device), torch.from_numpy(gt_boxes).to(self.device),
                self.iou_threshold, self._invalid_val,
            ))
            if self.respect_labels:
                if det_boxes.size > 0 and gt_boxes.size > 0:
                    label_eq = p_lab[:, None] == t_lab[None, :]
                else:
                    label_eq = np.eye(mat.shape[0], dtype=bool)
                mat = np.where(label_eq, mat, self._invalid_val)
            # column j of the matrix is gt box j when both sides are non-empty or the
            # preds are empty (gt-square zeros); otherwise no gt exists
            if gt_boxes.size > 0 and mat.shape[-1] == t_lab.shape[0]:
                cols = np.broadcast_to(t_lab[None, :], mat.shape)
            else:
                cols = np.full(mat.shape, -1, np.int32)
            values.append(mat.reshape(-1).astype(np.float32))
            col_labels.append(cols.reshape(-1).astype(np.int32))

        def cat(parts, dtype):
            return torch.from_numpy(np.concatenate(parts).astype(dtype) if parts else np.zeros((0,), dtype))

        return {
            "iou_values": cat(values, np.float32),
            "iou_col_labels": cat(col_labels, np.int32),
            "groundtruth_labels": cat(gt_labels, np.int32),
            "pred_labels": cat(pr_labels, np.int32),
        }

    def _compute(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        values = _to_numpy(state["iou_values"]).astype(np.float64)
        valid = values != self._invalid_val
        score = float(values[valid].mean()) if valid.any() else 0.0
        if np.isnan(score):
            score = 0.0
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)  # noqa: E731
        results = {f"{self._iou_type}": f32(score)}
        if self.class_metrics:
            cols = _to_numpy(state["iou_col_labels"])
            all_labels = np.concatenate([
                _to_numpy(state["groundtruth_labels"]).reshape(-1),
                _to_numpy(state["pred_labels"]).reshape(-1),
            ])
            for cl in np.unique(all_labels).tolist():
                mask = valid & (cols == cl)
                results[f"{self._iou_type}/cl_{cl}"] = f32(float(values[mask].mean()) if mask.sum() else 0.0)
        return results
