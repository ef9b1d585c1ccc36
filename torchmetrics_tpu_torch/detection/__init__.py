"""Detection metrics (counterpart of ``torchmetrics_tpu/detection``)."""

from .ciou import CompleteIntersectionOverUnion
from .diou import DistanceIntersectionOverUnion
from .giou import GeneralizedIntersectionOverUnion
from .iou import IntersectionOverUnion
from .mean_ap import DeviceMeanAveragePrecision, MeanAveragePrecision
from .panoptic_qualities import ModifiedPanopticQuality, PanopticQuality
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
    "ModifiedPanopticQuality",
    "PanopticQuality",
]
