"""Functional classification metrics: the stat-scores family for the binary,
multiclass and multilabel tasks, with their task-dispatch functions."""

from .accuracy import accuracy, binary_accuracy, multiclass_accuracy, multilabel_accuracy
from .confusion_matrix import (
    binary_confusion_matrix,
    confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
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
from .specificity import binary_specificity, multiclass_specificity, multilabel_specificity, specificity
from .stat_scores import binary_stat_scores, multiclass_stat_scores, multilabel_stat_scores, stat_scores

__all__ = sorted(n for n, v in list(globals().items()) if not n.startswith("_") and callable(v))
