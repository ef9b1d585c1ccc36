"""Detection functions (counterpart of ``torchmetrics_tpu/functional/detection``)."""

from .ciou import complete_intersection_over_union
from .diou import distance_intersection_over_union
from .giou import generalized_intersection_over_union
from .iou import intersection_over_union
from .map import mean_average_precision
from .panoptic_qualities import modified_panoptic_quality, panoptic_quality

__all__ = [
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "mean_average_precision",
    "modified_panoptic_quality",
    "panoptic_quality",
]
