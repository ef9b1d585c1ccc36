"""Functional segmentation metrics: Dice, generalized Dice, mean IoU and the Hausdorff
distance over gathered edge voxels."""

from .dice import dice_score
from .generalized_dice import generalized_dice_score
from .hausdorff_distance import hausdorff_distance
from .mean_iou import mean_iou

__all__ = ["dice_score", "generalized_dice_score", "hausdorff_distance", "mean_iou"]
