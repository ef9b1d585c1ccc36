"""Segmentation metric classes: Dice, generalized Dice, mean IoU and the Hausdorff
distance."""

from .dice import DiceScore
from .generalized_dice import GeneralizedDiceScore
from .hausdorff_distance import HausdorffDistance
from .mean_iou import MeanIoU

__all__ = ["DiceScore", "GeneralizedDiceScore", "HausdorffDistance", "MeanIoU"]
