"""Functional classification metrics for the binary, multiclass and multilabel tasks,
with their task-dispatch functions: the stat-scores family, exact match, Jaccard, MCC,
Cohen's kappa, and the curve family (PR curve, ROC, AUROC, average precision)."""

from .accuracy import accuracy, binary_accuracy, multiclass_accuracy, multilabel_accuracy
from .auroc import auroc, binary_auroc, multiclass_auroc, multilabel_auroc
from .average_precision import (
    average_precision,
    binary_average_precision,
    multiclass_average_precision,
    multilabel_average_precision,
)
from .cohen_kappa import binary_cohen_kappa, cohen_kappa, multiclass_cohen_kappa
from .confusion_matrix import (
    binary_confusion_matrix,
    confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
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
from .hamming import (
    binary_hamming_distance,
    hamming_distance,
    multiclass_hamming_distance,
    multilabel_hamming_distance,
)
from .jaccard import binary_jaccard_index, jaccard_index, multiclass_jaccard_index, multilabel_jaccard_index
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
from .roc import binary_roc, multiclass_roc, multilabel_roc, roc
from .specificity import binary_specificity, multiclass_specificity, multilabel_specificity, specificity
from .stat_scores import binary_stat_scores, multiclass_stat_scores, multilabel_stat_scores, stat_scores

__all__ = sorted(n for n, v in list(globals().items()) if not n.startswith("_") and callable(v))
