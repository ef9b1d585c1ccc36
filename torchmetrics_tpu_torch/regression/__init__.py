"""Regression metric classes: the sum-state errors, R2, relative squared error and
explained variance, Pearson and concordance by running moments, NRMSE, Spearman, Kendall,
cosine similarity, KL and Jensen-Shannon divergence, CRPS and CSI."""

from .crps import ContinuousRankedProbabilityScore, CriticalSuccessIndex
from .divergence import JensenShannonDivergence, KLDivergence
from .mse import (
    LogCoshError,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    MinkowskiDistance,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from .nrmse import NormalizedRootMeanSquaredError
from .pearson import ConcordanceCorrCoef, PearsonCorrCoef
from .r2 import ExplainedVariance, R2Score, RelativeSquaredError
from .rank import CosineSimilarity, KendallRankCorrCoef, SpearmanCorrCoef

__all__ = [
    "ConcordanceCorrCoef",
    "ContinuousRankedProbabilityScore",
    "CosineSimilarity",
    "CriticalSuccessIndex",
    "ExplainedVariance",
    "JensenShannonDivergence",
    "KLDivergence",
    "KendallRankCorrCoef",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MinkowskiDistance",
    "NormalizedRootMeanSquaredError",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
