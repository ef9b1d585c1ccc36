"""Classification metric classes for the binary, multiclass and multilabel tasks, with
their task facades: the stat-scores family, exact match, Jaccard, MCC, Cohen's kappa, and
the curve family (PR curve, ROC, AUROC, average precision)."""

from .accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from .auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from .average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from .cohen_kappa import BinaryCohenKappa, CohenKappa, MulticlassCohenKappa
from .confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from .exact_match import ExactMatch, MulticlassExactMatch, MultilabelExactMatch
from .f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from .hamming import BinaryHammingDistance, HammingDistance, MulticlassHammingDistance, MultilabelHammingDistance
from .jaccard import BinaryJaccardIndex, JaccardIndex, MulticlassJaccardIndex, MultilabelJaccardIndex
from .matthews_corrcoef import (
    BinaryMatthewsCorrCoef,
    MatthewsCorrCoef,
    MulticlassMatthewsCorrCoef,
    MultilabelMatthewsCorrCoef,
)
from .negative_predictive_value import (
    BinaryNegativePredictiveValue,
    MulticlassNegativePredictiveValue,
    MultilabelNegativePredictiveValue,
    NegativePredictiveValue,
)
from .precision_recall import (
    BinaryPrecision,
    BinaryRecall,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelPrecision,
    MultilabelRecall,
    Precision,
    Recall,
)
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from .roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from .specificity import BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity, Specificity
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores, StatScores

__all__ = sorted(n for n, v in list(globals().items()) if isinstance(v, type))
