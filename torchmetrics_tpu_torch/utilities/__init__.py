"""Helpers the port shares across its modules, and the JAX package's 13 public names of
``utilities``."""

from .checks import check_forward_full_state_property
from .compute import class_reduce, reduce
from .data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum
from .exceptions import TorchMetricsUserError, TorchMetricsUserWarning
from .prints import rank_zero_debug, rank_zero_info, rank_zero_warn

__all__ = [
    "TorchMetricsUserError",
    "TorchMetricsUserWarning",
    "check_forward_full_state_property",
    "class_reduce",
    "reduce",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_warn",
]
