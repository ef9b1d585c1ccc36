"""Retrieval metrics (counterpart of ``torchmetrics_tpu/retrieval``): group-by-query
scores over a padded ``(Q, L)`` matrix on the metric's device."""

from .base import RetrievalMetric
from .metrics import (
    RetrievalAUROC,
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRPrecision,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
)

__all__ = [
    "RetrievalAUROC",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
]
