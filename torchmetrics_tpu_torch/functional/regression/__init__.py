"""Functional regression metrics: the sum-state errors (MSE, MAE, MSLE, log-cosh, the
MAPE family, Minkowski, Tweedie), R2, relative squared error and explained variance, the
moment correlations (Pearson, concordance) and NRMSE, the rank correlations (Spearman,
Kendall), cosine similarity, KL and Jensen-Shannon divergence, CRPS and CSI."""

from .concordance import concordance_corrcoef
from .cosine_similarity import cosine_similarity
from .crps import continuous_ranked_probability_score
from .csi import critical_success_index
from .explained_variance import explained_variance
from .kendall import kendall_rank_corrcoef
from .kl_divergence import jensen_shannon_divergence, kl_divergence
from .log_mse import log_cosh_error, mean_squared_log_error
from .mae import mean_absolute_error
from .mape import (
    mean_absolute_percentage_error,
    symmetric_mean_absolute_percentage_error,
    weighted_mean_absolute_percentage_error,
)
from .minkowski import minkowski_distance
from .mse import mean_squared_error
from .nrmse import normalized_root_mean_squared_error
from .pearson import pearson_corrcoef
from .r2 import r2_score, relative_squared_error
from .spearman import spearman_corrcoef
from .tweedie_deviance import tweedie_deviance_score

__all__ = [
    "concordance_corrcoef",
    "cosine_similarity",
    "continuous_ranked_probability_score",
    "critical_success_index",
    "explained_variance",
    "jensen_shannon_divergence",
    "kendall_rank_corrcoef",
    "kl_divergence",
    "log_cosh_error",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "minkowski_distance",
    "normalized_root_mean_squared_error",
    "pearson_corrcoef",
    "r2_score",
    "relative_squared_error",
    "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
    "weighted_mean_absolute_percentage_error",
]
