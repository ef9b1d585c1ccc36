"""Contingency-table association statistics: Cramer's V, Pearson's contingency
coefficient, Theil's U, Tschuprow's T (counterpart of
``torchmetrics_tpu/functional/nominal/_association.py``).

All four share one sufficient statistic, a ``(C, C)`` int32 table counted on the inputs'
device by the confusion-matrix bincount, and differ only in the scalar computed from it
on the host (float64 numpy, rounded to float32 once). The ``_matrix`` forms loop over
the column pairs on the host, one table a pair, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...utilities.checks import _as_tensor
from ..classification.confusion_matrix import _multiclass_confusion_matrix_update
from .utils import (
    _compute_bias_corrected_values,
    _compute_chi_squared,
    _drop_empty_rows_and_cols,
    _handle_nan_in_data,
    _nominal_input_validation,
    _unable_to_use_bias_correction_warning,
)


def _nominal_update(
    preds,
    target,
    num_classes: Optional[int] = None,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Shared contingency-table update. 2-D inputs collapse through numpy's argmax, then
    the NaN policy applies; ``num_classes=None`` takes the table's size from the largest
    label left (one host read), and float labels are truncated to int32 as numpy's
    ``astype`` truncates them. Labels outside ``[0, num_classes)`` drop out."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    preds = preds.argmax(1) if preds.ndim == 2 else preds
    target = target.argmax(1) if target.ndim == 2 else target
    preds, target = _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)
    if num_classes is None:
        largest = [x.max().double() for x in (preds, target) if x.numel()]
        num_classes = int(max([0.0, *(torch.stack(largest).tolist() if largest else [])])) + 1
    return _multiclass_confusion_matrix_update(preds.to(torch.int32), target.to(torch.int32), None, num_classes)


def _host_table(confmat) -> np.ndarray:
    """The table as float64 numpy (one copy from the device), empty rows and columns
    dropped."""
    return _drop_empty_rows_and_cols(np.asarray(torch.as_tensor(confmat).detach().cpu(), np.float64))


def _as_value(value: float, like) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.tensor(value, dtype=torch.float32, device=device)


def _cramers_v_update(preds, target, num_classes, nan_strategy="replace", nan_replace_value=0.0):
    return _nominal_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _cramers_v_compute(confmat, bias_correction: bool) -> torch.Tensor:
    table = _host_table(confmat)
    cm_sum = table.sum()
    chi_squared = _compute_chi_squared(table, bias_correction)
    phi_squared = chi_squared / cm_sum
    num_rows, num_cols = table.shape
    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, num_rows, num_cols, cm_sum
        )
        if min(rows_corrected, cols_corrected) == 1:
            _unable_to_use_bias_correction_warning(metric_name="Cramer's V")
            return _as_value(float("nan"), confmat)
        value = np.sqrt(phi_squared_corrected / min(rows_corrected - 1, cols_corrected - 1))
    else:
        value = np.sqrt(phi_squared / min(num_rows - 1, num_cols - 1))
    return _as_value(np.clip(value, 0.0, 1.0), confmat)


def cramers_v(
    preds,
    target,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    r"""Cramer's V: ``sqrt((chi^2/n) / min(r-1, k-1))`` association between two
    categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cramers_v
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 1, 0])
        >>> cramers_v(preds, target)
        tensor(0.6847)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _cramers_v_update(preds, target, None, nan_strategy, nan_replace_value)
    return _cramers_v_compute(confmat, bias_correction)


def cramers_v_matrix(matrix, bias_correction: bool = True, nan_strategy="replace", nan_replace_value=0.0):
    """Pairwise Cramer's V over the columns of an observation matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cramers_v_matrix
        >>> matrix = torch.tensor([[0, 1, 1], [1, 1, 0], [2, 0, 1], [0, 1, 1], [1, 0, 0], [2, 0, 0]])
        >>> cramers_v_matrix(matrix, bias_correction=False)
        tensor([[1.0000, 0.8165, 0.8165],
                [0.8165, 1.0000, 0.3333],
                [0.8165, 0.3333, 1.0000]])
    """
    return _nominal_matrix(matrix, lambda p, t: cramers_v(p, t, bias_correction, nan_strategy, nan_replace_value))


def _pearsons_contingency_coefficient_update(preds, target, num_classes, nan_strategy="replace", nan_replace_value=0.0):
    return _nominal_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _pearsons_contingency_coefficient_compute(confmat) -> torch.Tensor:
    table = _host_table(confmat)
    cm_sum = table.sum()
    chi_squared = _compute_chi_squared(table, bias_correction=False)
    phi_squared = chi_squared / cm_sum
    value = np.sqrt(phi_squared / (1 + phi_squared))
    return _as_value(np.clip(value, 0.0, 1.0), confmat)


def pearsons_contingency_coefficient(
    preds, target, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> torch.Tensor:
    r"""Pearson's contingency coefficient ``sqrt(phi^2 / (1 + phi^2))``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pearsons_contingency_coefficient
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 1, 0])
        >>> pearsons_contingency_coefficient(preds, target)
        tensor(0.7348)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _pearsons_contingency_coefficient_update(preds, target, None, nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(confmat)


def pearsons_contingency_coefficient_matrix(matrix, nan_strategy="replace", nan_replace_value=0.0):
    """Pairwise Pearson's contingency coefficient over matrix columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pearsons_contingency_coefficient_matrix
        >>> matrix = torch.tensor([[0, 1, 1], [1, 1, 0], [2, 0, 1], [0, 1, 1], [1, 0, 0], [2, 0, 0]])
        >>> pearsons_contingency_coefficient_matrix(matrix)
        tensor([[1.0000, 0.6325, 0.6325],
                [0.6325, 1.0000, 0.3162],
                [0.6325, 0.3162, 1.0000]])
    """
    return _nominal_matrix(matrix, lambda p, t: pearsons_contingency_coefficient(p, t, nan_strategy, nan_replace_value))


def _theils_u_update(preds, target, num_classes, nan_strategy="replace", nan_replace_value=0.0):
    return _nominal_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _conditional_entropy_compute(confmat: np.ndarray) -> float:
    confmat = _drop_empty_rows_and_cols(confmat)
    total = confmat.sum()
    p_xy = confmat / total
    p_y = (confmat.sum(1) / total)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = p_xy * np.log(p_y / p_xy)
    return float(np.nansum(terms))


def _theils_u_compute(confmat) -> torch.Tensor:
    table = _host_table(confmat)
    s_xy = _conditional_entropy_compute(table)
    total = table.sum()
    p_x = table.sum(0) / total
    with np.errstate(divide="ignore", invalid="ignore"):
        s_x = -np.nansum(p_x * np.log(p_x))
    if s_x == 0:
        return _as_value(0.0, confmat)
    return _as_value((s_x - s_xy) / s_x, confmat)


def theils_u(
    preds, target, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> torch.Tensor:
    r"""Theil's U (uncertainty coefficient) ``(H(X) - H(X|Y)) / H(X)``, asymmetric.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import theils_u
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 1, 0])
        >>> theils_u(preds, target)
        tensor(0.6181)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _theils_u_update(preds, target, None, nan_strategy, nan_replace_value)
    return _theils_u_compute(confmat)


def theils_u_matrix(matrix, nan_strategy="replace", nan_replace_value=0.0):
    """Pairwise Theil's U over matrix columns (asymmetric: every off-diagonal pair).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import theils_u_matrix
        >>> matrix = torch.tensor([[0, 1, 1], [1, 1, 0], [2, 0, 1], [0, 1, 1], [1, 0, 0], [2, 0, 0]])
        >>> theils_u_matrix(matrix)
        tensor([[1.0000, 0.4206, 0.4206],
                [0.6667, 1.0000, 0.0817],
                [0.6667, 0.0817, 1.0000]])
    """
    matrix = _as_tensor(matrix)
    num_vars = matrix.shape[1]
    out = np.eye(num_vars, dtype=np.float32)
    for i in range(num_vars):
        for j in range(num_vars):
            if i != j:
                out[i, j] = float(theils_u(matrix[:, i], matrix[:, j], nan_strategy, nan_replace_value))
    return torch.as_tensor(out, device=matrix.device)


def _tschuprows_t_update(preds, target, num_classes, nan_strategy="replace", nan_replace_value=0.0):
    return _nominal_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _tschuprows_t_compute(confmat, bias_correction: bool) -> torch.Tensor:
    table = _host_table(confmat)
    cm_sum = table.sum()
    chi_squared = _compute_chi_squared(table, bias_correction)
    phi_squared = chi_squared / cm_sum
    num_rows, num_cols = table.shape
    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, num_rows, num_cols, cm_sum
        )
        if min(rows_corrected, cols_corrected) == 1:
            _unable_to_use_bias_correction_warning(metric_name="Tschuprow's T")
            return _as_value(float("nan"), confmat)
        value = np.sqrt(phi_squared_corrected / np.sqrt((rows_corrected - 1) * (cols_corrected - 1)))
    else:
        value = np.sqrt(phi_squared / np.sqrt((num_rows - 1) * (num_cols - 1)))
    return _as_value(np.clip(value, 0.0, 1.0), confmat)


def tschuprows_t(
    preds,
    target,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    r"""Tschuprow's T: ``sqrt((chi^2/n) / sqrt((r-1)(k-1)))``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import tschuprows_t
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 1, 0])
        >>> tschuprows_t(preds, target)
        tensor(0.6847)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _tschuprows_t_update(preds, target, None, nan_strategy, nan_replace_value)
    return _tschuprows_t_compute(confmat, bias_correction)


def tschuprows_t_matrix(matrix, bias_correction: bool = True, nan_strategy="replace", nan_replace_value=0.0):
    """Pairwise Tschuprow's T over matrix columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import tschuprows_t_matrix
        >>> matrix = torch.tensor([[0, 1, 1], [1, 1, 0], [2, 0, 1], [0, 1, 1], [1, 0, 0], [2, 0, 0]])
        >>> tschuprows_t_matrix(matrix, bias_correction=False)
        tensor([[1.0000, 0.6866, 0.6866],
                [0.6866, 1.0000, 0.3333],
                [0.6866, 0.3333, 1.0000]])
    """
    return _nominal_matrix(matrix, lambda p, t: tschuprows_t(p, t, bias_correction, nan_strategy, nan_replace_value))


def _nominal_matrix(matrix, pair_fn) -> torch.Tensor:
    """Symmetric pairwise association matrix over observation-matrix columns, float32,
    on the matrix's device."""
    matrix = _as_tensor(matrix)
    num_vars = matrix.shape[1]
    out = np.eye(num_vars, dtype=np.float32)
    for i, j in [(i, j) for i in range(num_vars) for j in range(i + 1, num_vars)]:
        val = float(pair_fn(matrix[:, i], matrix[:, j]))
        out[i, j] = out[j, i] = val
    return torch.as_tensor(out, device=matrix.device)
