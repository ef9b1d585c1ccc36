"""Functional clustering metrics (counterpart of ``torchmetrics_tpu/functional/clustering``)."""

from .extrinsic import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    cluster_accuracy,
    completeness_score,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from .intrinsic import calinski_harabasz_score, davies_bouldin_score, dunn_index

__all__ = [
    "adjusted_mutual_info_score",
    "adjusted_rand_score",
    "calinski_harabasz_score",
    "cluster_accuracy",
    "completeness_score",
    "davies_bouldin_score",
    "dunn_index",
    "fowlkes_mallows_index",
    "homogeneity_score",
    "mutual_info_score",
    "normalized_mutual_info_score",
    "rand_score",
    "v_measure_score",
]
