"""Clustering shared helpers (counterpart of ``torchmetrics_tpu/functional/clustering/utils.py``).

Cluster labels are arbitrary integers, so the JAX package builds a dense contingency
table on the host with ``np.unique``. Here the table is counted on the labels' device:
``torch.unique`` with inverse indices on each side, then one count of the fused index
``t_idx * P + p_idx``. The metrics read only the nonzero cells and the margins
(``_contingency_cells``), in int64: exact, and equal to the JAX package's float64 sums bit
for bit while ``n**2 < 2**53``. The dense ``(T, P)`` table (400 MB at 50,000 clusters
against 1,000 classes) is built only by the public ``calculate_contingency_matrix``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ...utilities.checks import _as_tensor, _check_same_shape


def check_cluster_labels(preds, target) -> None:
    """Validate shapes and that labels are real, discrete values (floats only when
    integral: NaN and infinities fail). One host read for float labels."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    for x in (preds, target):
        real = not x.is_complex() and x.dtype != torch.bool
        if not real or (x.is_floating_point() and not bool((torch.remainder(x, 1) == 0).all())):
            raise ValueError(f"Expected real, discrete values for x but received {preds.dtype} and {target.dtype}.")


class _Cells(NamedTuple):
    """A contingency table by its nonzero cells (row-major order) and margins, int64."""

    rows: torch.Tensor
    cols: torch.Tensor
    counts: torch.Tensor
    row_sums: torch.Tensor  # target clusters
    col_sums: torch.Tensor  # predicted clusters


def _label_index(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inverse index into the sorted distinct labels, count of each label)."""
    _, inverse, counts = torch.unique(x.reshape(-1), return_inverse=True, return_counts=True)
    return inverse, counts


def _contingency_cells(preds, target) -> _Cells:
    """The nonzero cells of the ``(T, P)`` contingency table of ``target`` against
    ``preds`` and its margins, without the dense table."""
    t_idx, row_sums = _label_index(_as_tensor(target))
    p_idx, col_sums = _label_index(_as_tensor(preds))
    cells, counts = torch.unique(t_idx * col_sums.numel() + p_idx, return_counts=True)
    return _Cells(cells // col_sums.numel(), cells % col_sums.numel(), counts, row_sums, col_sums)


def calculate_entropy(x) -> float:
    """Shannon entropy of a label vector (log form against roundoff); 1.0 for an empty
    vector, 0.0 for a single label.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering.utils import calculate_entropy
        >>> round(calculate_entropy(torch.tensor([0, 0, 1, 2])), 6)
        1.039721
    """
    x = _as_tensor(x).reshape(-1)
    if x.numel() == 0:
        return 1.0
    p = _label_index(x)[1]
    if p.numel() == 1:
        return 0.0
    n = p.sum()
    p = p.double()
    return float(-((p / n) * (p.log() - n.double().log())).sum())


def calculate_generalized_mean(x, p: Union[int, str]) -> float:
    """Generalized mean with the string shortcuts used by the MI normalizers (host
    float64, the JAX package's numpy).

    Example:
        >>> from torchmetrics_tpu_torch.functional.clustering.utils import calculate_generalized_mean
        >>> calculate_generalized_mean([1.0, 4.0], "geometric")
        2.0
    """
    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64)
    if np.iscomplexobj(x) or np.any(x < 0):
        raise ValueError("`x` must contain positive real numbers")
    if isinstance(p, str):
        if p == "min":
            return float(x.min())
        if p == "geometric":
            return float(np.exp(np.mean(np.log(x))))
        if p == "arithmetic":
            return float(x.mean())
        if p == "max":
            return float(x.max())
        raise ValueError("'method' must be 'min', 'geometric', 'arithmetic', or 'max'")
    return float(np.mean(x**p) ** (1.0 / p))


def _validate_average_method_arg(average_method: str) -> None:
    if average_method not in ("min", "geometric", "arithmetic", "max"):
        raise ValueError(
            "Expected argument `average_method` to be one of `min`, `geometric`, `arithmetic`, `max`,"
            f" but got {average_method}"
        )


def calculate_contingency_matrix(preds, target, eps: Optional[float] = None, sparse: bool = False) -> torch.Tensor:
    """Dense float64 contingency matrix of shape ``(n_classes_target, n_classes_preds)``
    on the labels' device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering.utils import calculate_contingency_matrix
        >>> calculate_contingency_matrix(torch.tensor([2, 1, 0, 1, 0]), torch.tensor([0, 2, 1, 1, 0]))
        tensor([[1., 0., 1.],
                [1., 1., 0.],
                [0., 1., 0.]], dtype=torch.float64)
    """
    if eps is not None and sparse is True:
        raise ValueError("Cannot specify `eps` and return sparse tensor.")
    cells = _contingency_cells(preds, target)
    num_rows, num_cols = cells.row_sums.numel(), cells.col_sums.numel()
    contingency = torch.zeros(num_rows * num_cols, dtype=torch.float64, device=cells.counts.device)
    contingency[cells.rows * num_cols + cells.cols] = cells.counts.double()
    contingency = contingency.reshape(num_rows, num_cols)
    return contingency if eps is None else contingency + eps


class _PairSums(NamedTuple):
    """The exact int64 sums the pair-counting metrics read, as Python ints."""

    n: int
    sum_squares: int  # sum of n_ij^2
    row_weighted: int  # sum of n_ij * (row margin)_i
    col_weighted: int  # sum of n_ij * (column margin)_j
    row_squares: int  # sum of (row margin)^2
    col_squares: int  # sum of (column margin)^2


def _pair_sums(cells: _Cells) -> _PairSums:
    """One host read of the six sums."""
    counts = cells.counts
    sums = torch.stack([counts.sum(), (counts * counts).sum(), (counts * cells.row_sums[cells.rows]).sum(),
                        (counts * cells.col_sums[cells.cols]).sum(), cells.row_sums.square().sum(),
                        cells.col_sums.square().sum()])
    return _PairSums(*sums.tolist())


def _pair_matrix(sums: _PairSums) -> np.ndarray:
    """The 2x2 pair confusion matrix in float64, in the JAX package's order of
    operations on the same (exact) values."""
    n, sum_squares = float(sums.n), float(sums.sum_squares)
    pair_matrix = np.zeros((2, 2), np.float64)
    pair_matrix[1, 1] = sum_squares - n
    pair_matrix[0, 1] = float(sums.col_weighted) - sum_squares
    pair_matrix[1, 0] = float(sums.row_weighted) - sum_squares
    pair_matrix[0, 0] = n**2 - pair_matrix[0, 1] - pair_matrix[1, 0] - sum_squares
    return pair_matrix


def calculate_pair_cluster_confusion_matrix(
    preds=None, target=None, contingency: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """2x2 pair confusion matrix over all sample pairs (sklearn ``pair_confusion_matrix``
    semantics; not symmetric), float64.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering.utils import calculate_pair_cluster_confusion_matrix
        >>> calculate_pair_cluster_confusion_matrix(torch.tensor([2, 1, 0, 1, 0]), torch.tensor([0, 2, 1, 1, 0]))
        tensor([[12.,  4.],
                [ 4.,  0.]], dtype=torch.float64)
    """
    if preds is None and target is None and contingency is None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`.")
    if preds is not None and target is not None and contingency is not None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`, not both.")
    if contingency is None:
        cells = _contingency_cells(preds, target)
        return torch.as_tensor(_pair_matrix(_pair_sums(cells)), device=cells.counts.device)
    contingency = _as_tensor(contingency).double()
    n_samples = contingency.sum()
    n_c = contingency.sum(1)
    n_k = contingency.sum(0)
    sum_squares = contingency.square().sum()
    p01 = (contingency @ n_k).sum() - sum_squares
    p10 = (contingency.T @ n_c).sum() - sum_squares
    return torch.stack([torch.stack([n_samples**2 - p01 - p10 - sum_squares, p01]),
                        torch.stack([p10, sum_squares - n_samples])])


def _validate_intrinsic_cluster_data(data: torch.Tensor, labels: torch.Tensor) -> None:
    if data.ndim != 2:
        raise ValueError(f"Expected 2D data, got {data.ndim}D data instead")
    if not data.is_floating_point():
        raise ValueError(f"Expected floating point data, got {data.dtype} data instead")
    if labels.ndim != 1:
        raise ValueError(f"Expected 1D labels, got {labels.ndim}D labels instead")


def _validate_intrinsic_labels_to_samples(num_labels: int, num_samples: int) -> None:
    if not 1 < num_labels < num_samples:
        raise ValueError(
            "Number of detected clusters must be greater than one and less than the number of samples."
            f" Got {num_labels} clusters and {num_samples} samples."
        )


def _cluster_views(data: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero-indexed labels, float64 cluster sizes and float64 centroids. The centroid
    sums are float64 ``index_add_``: on CUDA its atomics add in no fixed order, which
    moves the sums' last float64 bits from run to run."""
    inverse, counts = _label_index(labels)
    counts = counts.double()
    centroids = torch.zeros((counts.numel(), data.shape[1]), dtype=torch.float64, device=data.device)
    centroids.index_add_(0, inverse, data.double())
    return inverse, counts, centroids / counts[:, None]
