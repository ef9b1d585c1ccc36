"""Nominal-association shared helpers (counterpart of
``torchmetrics_tpu/functional/nominal/utils.py``).

The NaN policy runs on the inputs' device (``"drop"`` reads the host once, for the
shape). The statistics run on the small ``(C, C)`` table in float64 on the host, from
one copy of the table: the JAX package's numpy, copied here, so the values are its own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...utilities.prints import rank_zero_warn


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    if nan_strategy not in ["replace", "drop"]:
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (float, int)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _handle_nan_in_data(
    preds: torch.Tensor,
    target: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace NaN (``numpy.nan_to_num``: infinities become the dtype's extremes) or drop
    the rows where either side is NaN."""
    if nan_strategy == "replace":
        return tuple(x.nan_to_num(nan=nan_replace_value) if x.is_floating_point() else x for x in (preds, target))
    keep = ~(preds.isnan() | target.isnan())
    return preds[keep], target[keep]


def _drop_empty_rows_and_cols(confmat: np.ndarray) -> np.ndarray:
    confmat = confmat[confmat.sum(1) != 0]
    return confmat[:, confmat.sum(0) != 0]


def _compute_expected_freqs(confmat: np.ndarray) -> np.ndarray:
    margin_rows, margin_cols = confmat.sum(1), confmat.sum(0)
    return np.outer(margin_rows, margin_cols) / confmat.sum()


def _compute_chi_squared(confmat: np.ndarray, bias_correction: bool) -> float:
    """Chi-square independence statistic (scipy.stats.contingency semantics, with the
    Yates continuity correction at one degree of freedom: observed moves toward expected
    by ``min(0.5, |diff|)``, scipy's form)."""
    expected = _compute_expected_freqs(confmat)
    df = expected.size - sum(expected.shape) + expected.ndim - 1
    if df == 0:
        return 0.0
    if df == 1 and bias_correction:
        diff = expected - confmat
        confmat = confmat + np.sign(diff) * np.minimum(0.5, np.abs(diff))
    return float(((confmat - expected) ** 2 / expected).sum())


def _compute_phi_squared_corrected(phi_squared, num_rows, num_cols, confmat_sum) -> float:
    return max(0.0, phi_squared - ((num_rows - 1) * (num_cols - 1)) / (confmat_sum - 1))


def _compute_rows_and_cols_corrected(num_rows, num_cols, confmat_sum) -> Tuple[float, float]:
    rows_corrected = num_rows - (num_rows - 1) ** 2 / (confmat_sum - 1)
    cols_corrected = num_cols - (num_cols - 1) ** 2 / (confmat_sum - 1)
    return rows_corrected, cols_corrected


def _compute_bias_corrected_values(phi_squared, num_rows, num_cols, confmat_sum) -> Tuple[float, float, float]:
    return (
        _compute_phi_squared_corrected(phi_squared, num_rows, num_cols, confmat_sum),
        *_compute_rows_and_cols_corrected(num_rows, num_cols, confmat_sum),
    )


def _unable_to_use_bias_correction_warning(metric_name: str) -> None:
    rank_zero_warn(
        f"Unable to compute {metric_name} using bias correction. Please consider to set `bias_correction=False`."
    )
