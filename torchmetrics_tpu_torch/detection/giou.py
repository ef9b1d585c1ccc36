"""GeneralizedIntersectionOverUnion metric class (counterpart of
``torchmetrics_tpu/detection/giou.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.detection.giou import _giou_update
from .iou import IntersectionOverUnion


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    """GIoU over list-of-dict box inputs; the state design of ``IntersectionOverUnion``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import GeneralizedIntersectionOverUnion
        >>> preds = [{'boxes': torch.tensor([[296.55, 93.96, 314.97, 152.79]]), 'scores': torch.tensor([0.236]), 'labels': torch.tensor([4])}]
        >>> target = [{'boxes': torch.tensor([[300.00, 100.00, 315.00, 150.00]]), 'labels': torch.tensor([4])}]
        >>> metric = GeneralizedIntersectionOverUnion(device='cpu')
        >>> metric.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'giou': 0.6895}
    """

    _iou_type: str = "giou"
    _invalid_val: float = -1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(box_format, iou_threshold, class_metrics, respect_labels, **kwargs)

    @staticmethod
    def _iou_update_fn(*args: Any, **kwargs: Any) -> torch.Tensor:
        return _giou_update(*args, **kwargs)
