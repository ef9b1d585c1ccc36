"""Classification metric classes for the binary, multiclass and multilabel tasks, with
their task facades: the stat-scores family, exact match, Jaccard, MCC, Cohen's kappa,
calibration error, hinge loss, the multilabel ranking metrics, group fairness, the curve
family (PR curve, ROC, AUROC, average precision) and the metrics read off a curve (EER,
LogAUC and the four operating points)."""

from .accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from .auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from .average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from .calibration_error import BinaryCalibrationError, CalibrationError, MulticlassCalibrationError
from .cohen_kappa import BinaryCohenKappa, CohenKappa, MulticlassCohenKappa
from .confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from .eer import EER, BinaryEER, MulticlassEER, MultilabelEER
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
from .group_fairness import BinaryFairness, BinaryGroupStatRates
from .hamming import BinaryHammingDistance, HammingDistance, MulticlassHammingDistance, MultilabelHammingDistance
from .hinge import BinaryHingeLoss, HingeLoss, MulticlassHingeLoss
from .jaccard import BinaryJaccardIndex, JaccardIndex, MulticlassJaccardIndex, MultilabelJaccardIndex
from .logauc import BinaryLogAUC, LogAUC, MulticlassLogAUC, MultilabelLogAUC
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
from .precision_fixed_recall import (
    BinaryPrecisionAtFixedRecall,
    MulticlassPrecisionAtFixedRecall,
    MultilabelPrecisionAtFixedRecall,
    PrecisionAtFixedRecall,
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
from .ranking import MultilabelCoverageError, MultilabelRankingAveragePrecision, MultilabelRankingLoss
from .recall_fixed_precision import (
    BinaryRecallAtFixedPrecision,
    MulticlassRecallAtFixedPrecision,
    MultilabelRecallAtFixedPrecision,
    RecallAtFixedPrecision,
)
from .roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from .sensitivity_specificity import (
    BinarySensitivityAtSpecificity,
    MulticlassSensitivityAtSpecificity,
    MultilabelSensitivityAtSpecificity,
    SensitivityAtSpecificity,
)
from .specificity import BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity, Specificity
from .specificity_sensitivity import (
    BinarySpecificityAtSensitivity,
    MulticlassSpecificityAtSensitivity,
    MultilabelSpecificityAtSensitivity,
    SpecificityAtSensitivity,
)
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores, StatScores

__all__ = sorted(n for n, v in list(globals().items()) if isinstance(v, type))
