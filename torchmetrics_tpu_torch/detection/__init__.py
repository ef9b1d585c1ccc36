"""Detection metrics (counterpart of ``torchmetrics_tpu/detection``; panoptic quality is
not ported yet)."""

from .ciou import CompleteIntersectionOverUnion
from .diou import DistanceIntersectionOverUnion
from .giou import GeneralizedIntersectionOverUnion
from .iou import IntersectionOverUnion
from .mean_ap import DeviceMeanAveragePrecision, MeanAveragePrecision
from .sharded import PaddedDetectionAccumulator, pack_detection_batch

__all__ = [
    "PaddedDetectionAccumulator",
    "pack_detection_batch",
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "DeviceMeanAveragePrecision",
    "MeanAveragePrecision",
]
