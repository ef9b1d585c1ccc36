"""Extrinsic (label-against-label) clustering metrics (counterpart of
``torchmetrics_tpu/functional/clustering/extrinsic.py``).

All read the contingency table of two label vectors through its nonzero cells and
margins, counted on the labels' device (``utils._contingency_cells``). The pair-counting
metrics take exact int64 sums and do the JAX package's float64 arithmetic on them on the
host; mutual information and the expected mutual information are float64 sums on the
device. ``cluster_accuracy`` solves the assignment on the host with scipy's
``linear_sum_assignment``, as the JAX package does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...utilities.checks import _as_tensor
from .utils import (
    _Cells,
    _contingency_cells,
    _pair_matrix,
    _pair_sums,
    _validate_average_method_arg,
    calculate_entropy,
    calculate_generalized_mean,
    check_cluster_labels,
)

_CHUNK_BYTES = 1 << 28  # the expected mutual information's temporaries: 256 MiB a chunk
_TERM_BYTES = 128  # float64 and int64 temporaries a term of that sum, with a margin
_PAIR_BLOCK = 1 << 20  # (target, prediction) cluster pairs a block


def _as_scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


# ------------------------------------------------------------- mutual information

def _mutual_info_score_update(preds, target) -> _Cells:
    check_cluster_labels(preds, target)
    return _contingency_cells(preds, target)


def _mutual_info_score_compute(cells: _Cells) -> float:
    """Mutual information from the nonzero cells, a float64 sum on the device."""
    if cells.row_sums.numel() == 1 or cells.col_sums.numel() == 1:
        return 0.0
    nz = cells.counts.double()
    n = nz.sum()
    log_outer = cells.row_sums[cells.rows].double().log() + cells.col_sums[cells.cols].double().log()
    return float((nz / n * (n.log() + nz.log() - log_outer)).sum())


def mutual_info_score(preds, target) -> torch.Tensor:
    r"""Mutual information between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mutual_info_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> mutual_info_score(preds, target)
        tensor(0.5004)
    """
    cells = _mutual_info_score_update(preds, target)
    return _as_scalar(_mutual_info_score_compute(cells), cells.counts)


def _expected_terms(a: torch.Tensor, b: torch.Tensor, n: int, lgamma: torch.Tensor, log: torch.Tensor,
                    start: torch.Tensor, counts: torch.Tensor, pairs: torch.Tensor, total: int) -> torch.Tensor:
    """The float64 sum of the hypergeometric terms of the cluster pairs ``pairs`` (flat
    indices into ``a x b``): ``counts[k]`` terms from ``n_ij = start[k]`` for each,
    ``total`` in all. The JAX package's operations, in its order."""
    pair = torch.repeat_interleave(torch.arange(pairs.numel(), device=a.device), counts, output_size=total)
    first = torch.cumsum(counts, 0) - counts
    nij = start[pair] + (torch.arange(total, device=a.device) - first[pair])
    ai, bj = a[pairs // b.numel()][pair], b[pairs % b.numel()][pair]
    term1 = nij.double() / n
    term2 = (log[n] + log[nij]) - log[ai] - log[bj]
    gln = (lgamma[ai] + lgamma[bj] + lgamma[n - ai] + lgamma[n - bj] - (lgamma[nij] + lgamma[n])
           - lgamma[ai - nij] - lgamma[bj - nij] - lgamma[n - ai - bj + nij])
    return (term1 * term2 * gln.exp()).sum()


def _term_chunks(ends: np.ndarray, step: int):
    """``(lo, hi, terms)`` runs of whole pairs, greedily, each of at most ``step`` terms
    (a pair with more is a run of its own); ``ends`` are the pairs' cumulative counts."""
    lo = 0
    while lo < ends.size:
        before = int(ends[lo - 1]) if lo else 0
        hi = max(int(np.searchsorted(ends, before + step, side="right")), lo + 1)
        yield lo, hi, int(ends[hi - 1]) - before
        lo = hi


def expected_mutual_info_score(contingency, n_samples: int) -> float:
    """Expected mutual information under the hypergeometric null (sklearn
    ``_expected_mutual_info_fast`` semantics).

    ``contingency`` is a dense table or the nonzero cells of ``_contingency_cells``; only
    its margins are read. The JAX package loops over every pair of clusters on the host;
    here all pairs' terms are flattened (``repeat_interleave``) and summed in float64 on
    the device, in chunks whose temporaries stay under 256 MiB (one host read of the
    pairs' term counts a block of pairs). Every ``gammaln`` argument is an integer in
    ``[1, n + 1]``, so ``lgamma`` and ``log`` are looked up in tables of ``n + 1`` entries.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering.extrinsic import expected_mutual_info_score
        >>> round(expected_mutual_info_score(torch.tensor([[1.0, 0.0, 1.0], [1.0, 1.0, 0.0], [0.0, 1.0, 0.0]]), 5), 6)
        0.611306
    """
    if isinstance(contingency, _Cells):
        a, b = contingency.row_sums, contingency.col_sums
    else:
        table = _as_tensor(contingency).double()
        a, b = table.sum(1).round().long(), table.sum(0).round().long()
    if a.numel() == 1 or b.numel() == 1:
        return 0.0
    n = int(n_samples)
    grid = torch.arange(n + 1, device=a.device, dtype=torch.float64)
    lgamma = torch.lgamma(grid + 1)  # lgamma[k] = gammaln(k + 1)
    log = torch.log(grid.clamp(min=1))
    emi = torch.zeros((), dtype=torch.float64, device=a.device)
    num_pairs = a.numel() * b.numel()
    for block_start in range(0, num_pairs, _PAIR_BLOCK):
        pairs = torch.arange(block_start, min(block_start + _PAIR_BLOCK, num_pairs), device=a.device)
        ai, bj = a[pairs // b.numel()], b[pairs % b.numel()]
        start = (ai - n + bj).clamp(min=1)
        counts = (torch.minimum(ai, bj) + 1 - start).clamp(min=0)
        ends = torch.cumsum(counts, 0).cpu().numpy()
        for lo, hi, total in _term_chunks(ends, _CHUNK_BYTES // _TERM_BYTES):
            if total:
                emi += _expected_terms(a, b, n, lgamma, log, start[lo:hi], counts[lo:hi], pairs[lo:hi], total)
    return float(emi)


def adjusted_mutual_info_score(preds, target, average_method: str = "arithmetic") -> torch.Tensor:
    r"""Adjusted mutual information: ``(MI - E[MI]) / (normalizer - E[MI])``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import adjusted_mutual_info_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> adjusted_mutual_info_score(preds, target)
        tensor(-0.2500)
    """
    _validate_average_method_arg(average_method)
    cells = _mutual_info_score_update(preds, target)
    mutual_info = _mutual_info_score_compute(cells)
    emi = expected_mutual_info_score(cells, _as_tensor(target).numel())
    normalizer = calculate_generalized_mean(
        np.array([calculate_entropy(preds), calculate_entropy(target)]), average_method
    )
    denominator = normalizer - emi
    eps = float(np.finfo(np.float32).eps)
    denominator = min(denominator, -eps) if denominator < 0 else max(denominator, eps)
    return _as_scalar((mutual_info - emi) / denominator, cells.counts)


def normalized_mutual_info_score(preds, target, average_method: str = "arithmetic") -> torch.Tensor:
    r"""Normalized mutual information: ``MI / generalized_mean(H(preds), H(target))``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import normalized_mutual_info_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> normalized_mutual_info_score(preds, target)
        tensor(0.4744)
    """
    check_cluster_labels(preds, target)
    _validate_average_method_arg(average_method)
    cells = _mutual_info_score_update(preds, target)
    mutual_info = _mutual_info_score_compute(cells)
    if abs(mutual_info) <= np.finfo(np.float32).eps:
        return _as_scalar(mutual_info, cells.counts)
    normalizer = calculate_generalized_mean(
        np.array([calculate_entropy(preds), calculate_entropy(target)]), average_method
    )
    return _as_scalar(mutual_info / normalizer, cells.counts)


# --------------------------------------------------------------------- rand family

def _rand_score_update(preds, target) -> _Cells:
    check_cluster_labels(preds, target)
    return _contingency_cells(preds, target)


def _rand_score_compute(cells: _Cells) -> float:
    pair_matrix = _pair_matrix(_pair_sums(cells))
    numerator = pair_matrix.diagonal().sum()
    denominator = pair_matrix.sum()
    if numerator == denominator or denominator == 0:
        return 1.0
    return float(numerator / denominator)


def rand_score(preds, target) -> torch.Tensor:
    r"""Rand index: fraction of sample pairs on which the clusterings agree.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import rand_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> rand_score(preds, target)
        tensor(0.6000)
    """
    cells = _rand_score_update(preds, target)
    return _as_scalar(_rand_score_compute(cells), cells.counts)


def _adjusted_rand_score_compute(cells: _Cells) -> float:
    (tn, fp), (fn, tp) = _pair_matrix(_pair_sums(cells))
    if fn == 0 and fp == 0:
        return 1.0
    return float(2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn)))


def adjusted_rand_score(preds, target) -> torch.Tensor:
    r"""Chance-adjusted Rand index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import adjusted_rand_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> adjusted_rand_score(preds, target)
        tensor(-0.2500)
    """
    cells = _rand_score_update(preds, target)
    return _as_scalar(_adjusted_rand_score_compute(cells), cells.counts)


def _fowlkes_mallows_index_update(preds, target) -> Tuple[_Cells, int]:
    check_cluster_labels(preds, target)
    return _contingency_cells(preds, target), _as_tensor(preds).numel()


def _fowlkes_mallows_index_compute(cells: _Cells, n: int) -> float:
    sums = _pair_sums(cells)
    tk = float(sums.sum_squares) - n
    if np.isclose(tk, 0):
        return 0.0
    pk = float(sums.col_squares) - n
    qk = float(sums.row_squares) - n
    return float(np.sqrt(tk / pk) * np.sqrt(tk / qk))


def fowlkes_mallows_index(preds, target) -> torch.Tensor:
    r"""Fowlkes-Mallows index: geometric mean of pairwise precision and recall.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import fowlkes_mallows_index
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> fowlkes_mallows_index(preds, target)
        tensor(0.)
    """
    cells, n = _fowlkes_mallows_index_update(preds, target)
    return _as_scalar(_fowlkes_mallows_index_compute(cells, n), cells.counts)


# -------------------------------------------- homogeneity / completeness / v-measure

def _homogeneity_score_compute(preds, target) -> Tuple[float, float, float, float]:
    check_cluster_labels(preds, target)
    if _as_tensor(target).numel() == 0:
        return 0.0, 0.0, 0.0, 0.0
    entropy_target = calculate_entropy(target)
    entropy_preds = calculate_entropy(preds)
    mutual_info = _mutual_info_score_compute(_mutual_info_score_update(preds, target))
    homogeneity = mutual_info / entropy_target if entropy_target else 1.0
    return homogeneity, mutual_info, entropy_preds, entropy_target


def homogeneity_score(preds, target) -> torch.Tensor:
    r"""Homogeneity: each cluster contains only members of a single class.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import homogeneity_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> homogeneity_score(preds, target)
        tensor(0.4744)
    """
    return _as_scalar(_homogeneity_score_compute(preds, target)[0], _as_tensor(target))


def _completeness_score_compute(preds, target) -> Tuple[float, float]:
    homogeneity, mutual_info, entropy_preds, _ = _homogeneity_score_compute(preds, target)
    completeness = mutual_info / entropy_preds if entropy_preds else 1.0
    return completeness, homogeneity


def completeness_score(preds, target) -> torch.Tensor:
    r"""Completeness: all members of a class are assigned to the same cluster.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import completeness_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> completeness_score(preds, target)
        tensor(0.4744)
    """
    return _as_scalar(_completeness_score_compute(preds, target)[0], _as_tensor(target))


def v_measure_score(preds, target, beta: float = 1.0) -> torch.Tensor:
    r"""V-measure: weighted harmonic mean of homogeneity and completeness.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import v_measure_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> v_measure_score(preds, target)
        tensor(0.4744)
    """
    completeness, homogeneity = _completeness_score_compute(preds, target)
    if homogeneity + completeness == 0.0:
        return _as_scalar(1.0, _as_tensor(target))
    return _as_scalar((1 + beta) * homogeneity * completeness / (beta * homogeneity + completeness), _as_tensor(target))


# ------------------------------------------------------------------ cluster accuracy

def _cluster_accuracy_compute(confmat) -> float:
    """The best one-to-one assignment's share of the samples (scipy's Hungarian solve on
    the host, from one copy of the table)."""
    from scipy.optimize import linear_sum_assignment

    confmat = np.asarray(torch.as_tensor(confmat).detach().cpu(), np.float64)
    row_ind, col_ind = linear_sum_assignment(confmat.max() - confmat)
    return float(confmat[row_ind, col_ind].sum() / confmat.sum())


def cluster_accuracy(preds, target, num_classes: int) -> torch.Tensor:
    r"""Clustering accuracy: optimal one-to-one label assignment (Hungarian solve via
    scipy on the host).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cluster_accuracy
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> cluster_accuracy(preds, target, num_classes=3)
        tensor(0.6000)
    """
    from ..classification.confusion_matrix import multiclass_confusion_matrix

    check_cluster_labels(preds, target)
    confmat = multiclass_confusion_matrix(_as_tensor(preds), _as_tensor(target), num_classes=num_classes)
    return _as_scalar(_cluster_accuracy_compute(confmat), confmat)
