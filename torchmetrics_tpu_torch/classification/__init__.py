"""Classification metric classes (multiclass so far)."""

from .accuracy import MulticlassAccuracy
from .confusion_matrix import MulticlassConfusionMatrix
from .f_beta import MulticlassF1Score, MulticlassFBetaScore
from .stat_scores import MulticlassStatScores

__all__ = [
    "MulticlassAccuracy",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassStatScores",
]
