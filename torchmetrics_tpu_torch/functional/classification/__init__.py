"""Functional classification metrics for the binary, multiclass and multilabel tasks,
with their task-dispatch functions: the stat-scores family, exact match, Jaccard, MCC,
Cohen's kappa, calibration error, hinge loss, the multilabel ranking metrics, group
fairness, the curve family (PR curve, ROC, AUROC, average precision) and the metrics
read off a curve (EER, LogAUC and the four operating points)."""

from ._operating_point_facades import (
    precision_at_fixed_recall,
    recall_at_fixed_precision,
    sensitivity_at_specificity,
    specificity_at_sensitivity,
)

from .accuracy import accuracy, binary_accuracy, multiclass_accuracy, multilabel_accuracy
from .auroc import auroc, binary_auroc, multiclass_auroc, multilabel_auroc
from .average_precision import (
    average_precision,
    binary_average_precision,
    multiclass_average_precision,
    multilabel_average_precision,
)
from .calibration_error import binary_calibration_error, calibration_error, multiclass_calibration_error
from .cohen_kappa import binary_cohen_kappa, cohen_kappa, multiclass_cohen_kappa
from .confusion_matrix import (
    binary_confusion_matrix,
    confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from .eer import binary_eer, eer, multiclass_eer, multilabel_eer
from .exact_match import exact_match, multiclass_exact_match, multilabel_exact_match
from .f_beta import (
    binary_f1_score,
    binary_fbeta_score,
    f1_score,
    fbeta_score,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multilabel_f1_score,
    multilabel_fbeta_score,
)
from .group_fairness import binary_fairness, binary_groups_stat_rates, demographic_parity, equal_opportunity
from .hamming import (
    binary_hamming_distance,
    hamming_distance,
    multiclass_hamming_distance,
    multilabel_hamming_distance,
)
from .hinge import binary_hinge_loss, hinge_loss, multiclass_hinge_loss
from .jaccard import binary_jaccard_index, jaccard_index, multiclass_jaccard_index, multilabel_jaccard_index
from .logauc import binary_logauc, logauc, multiclass_logauc, multilabel_logauc
from .matthews_corrcoef import (
    binary_matthews_corrcoef,
    matthews_corrcoef,
    multiclass_matthews_corrcoef,
    multilabel_matthews_corrcoef,
)
from .negative_predictive_value import (
    binary_negative_predictive_value,
    multiclass_negative_predictive_value,
    multilabel_negative_predictive_value,
    negative_predictive_value,
)
from .precision_fixed_recall import (
    binary_precision_at_fixed_recall,
    multiclass_precision_at_fixed_recall,
    multilabel_precision_at_fixed_recall,
)
from .precision_recall import (
    binary_precision,
    binary_recall,
    multiclass_precision,
    multiclass_recall,
    multilabel_precision,
    multilabel_recall,
    precision,
    recall,
)
from .precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
    precision_recall_curve,
)
from .ranking import (
    multilabel_coverage_error,
    multilabel_ranking_average_precision,
    multilabel_ranking_loss,
)
from .recall_fixed_precision import (
    binary_recall_at_fixed_precision,
    multiclass_recall_at_fixed_precision,
    multilabel_recall_at_fixed_precision,
)
from .roc import binary_roc, multiclass_roc, multilabel_roc, roc
from .sensitivity_specificity import (
    binary_sensitivity_at_specificity,
    multiclass_sensitivity_at_specificity,
    multilabel_sensitivity_at_specificity,
)
from .specificity import binary_specificity, multiclass_specificity, multilabel_specificity, specificity
from .specificity_sensitivity import (
    binary_specificity_at_sensitivity,
    multiclass_specificity_at_sensitivity,
    multilabel_specificity_at_sensitivity,
)
from .stat_scores import binary_stat_scores, multiclass_stat_scores, multilabel_stat_scores, stat_scores

__all__ = sorted(n for n, v in list(globals().items()) if not n.startswith("_") and callable(v))
