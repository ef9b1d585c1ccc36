"""Intrinsic (data and labels) clustering scores (counterpart of
``torchmetrics_tpu/functional/clustering/intrinsic.py``).

float64 on the data's device, as the JAX package's numpy is float64. Cluster sizes and
centroids come from ``utils._cluster_views`` (a float64 ``index_add_``); the per-sample
and per-centroid-pair distances go in row blocks whose float64 temporaries stay under
256 MiB, so no ``(N, D)`` residual or ``(K, K, D)`` difference is held whole.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...utilities.checks import _as_tensor
from ...utilities.data import allclose
from ..pairwise.helpers import _row_blocks
from .utils import _cluster_views, _validate_intrinsic_cluster_data, _validate_intrinsic_labels_to_samples


def _prepare(data, labels):
    """float64 data, labels, cluster views; validated as in the JAX package (which takes
    the data as float64 first, so any real data passes the floating-point check)."""
    data = _as_tensor(data).double()
    labels = _as_tensor(labels)
    _validate_intrinsic_cluster_data(data, labels)
    inverse, counts, centroids = _cluster_views(data, labels)
    _validate_intrinsic_labels_to_samples(counts.numel(), data.shape[0])
    return data, inverse, counts, centroids


def _residual_rows(data: torch.Tensor, inverse: torch.Tensor, centroids: torch.Tensor,
                   reduce: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``reduce`` of each sample's residual ``x - centroid``, one row block at a time."""
    return torch.cat([reduce(data[rows] - centroids[inverse[rows]])
                      for rows in _row_blocks(data.shape[0], 16 * data.shape[1])])


def _centroid_pairs(centroids: torch.Tensor, reduce: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``(K, K)``: ``reduce`` of each difference ``c_i - c_j``, one row block at a time."""
    k, d = centroids.shape
    return torch.cat([reduce(centroids[rows, None, :] - centroids[None]) for rows in _row_blocks(k, 8 * k * d)])


def calinski_harabasz_score(data, labels) -> torch.Tensor:
    r"""Calinski-Harabasz score: between/within dispersion ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import calinski_harabasz_score
        >>> data = torch.tensor([[0.0, 0.0], [0.5, 0.0], [10.0, 10.0], [10.5, 10.0], [20.0, 0.0], [20.5, 0.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> calinski_harabasz_score(data, labels)
        tensor(2133.3333)
    """
    data, inverse, counts, centroids = _prepare(data, labels)
    num_labels, num_samples = counts.numel(), data.shape[0]
    mean = data.mean(0)
    between = ((centroids - mean).square().sum(1) * counts).sum()
    within = _residual_rows(data, inverse, centroids, lambda r: r.square_().sum(1)).sum()
    value = between * (num_samples - num_labels) / (within * (num_labels - 1.0))
    return torch.where(within == 0, 1.0, value).to(torch.float32)


def davies_bouldin_score(data, labels) -> torch.Tensor:
    r"""Davies-Bouldin score: mean worst-case ratio of intra-cluster spread to
    centroid separation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import davies_bouldin_score
        >>> data = torch.tensor([[0.0, 0.0], [0.5, 0.0], [10.0, 10.0], [10.5, 10.0], [20.0, 0.0], [20.5, 0.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> davies_bouldin_score(data, labels)
        tensor(0.0354)
    """
    data, inverse, counts, centroids = _prepare(data, labels)
    dists = _residual_rows(data, inverse, centroids, lambda r: r.square_().sum(1).sqrt_())
    intra = torch.zeros(counts.numel(), dtype=torch.float64, device=data.device).index_add_(0, inverse, dists) / counts
    centroid_distances = _centroid_pairs(centroids, lambda r: r.square_().sum(-1).sqrt_())
    zero = torch.zeros((), dtype=torch.float64, device=data.device)
    if allclose(intra, zero) or allclose(centroid_distances, zero):
        return torch.zeros((), dtype=torch.float32, device=data.device)
    centroid_distances[centroid_distances == 0] = float("inf")
    combined = intra[None, :] + intra[:, None]
    return (combined / centroid_distances).amax(1).mean().to(torch.float32)


def dunn_index(data, labels, p: float = 2) -> torch.Tensor:
    r"""Dunn index: min inter-centroid distance over max intra-cluster radius.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import dunn_index
        >>> data = torch.tensor([[0.0, 0.0], [0.5, 0.0], [10.0, 10.0], [10.5, 10.0], [20.0, 0.0], [20.5, 0.0]])
        >>> labels = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> dunn_index(data, labels)
        tensor(56.5685)
    """
    data, inverse, counts, centroids = _prepare(data, labels)
    num_labels = counts.numel()
    inter = _centroid_pairs(centroids, lambda r: torch.linalg.vector_norm(r, ord=p, dim=-1))
    upper = torch.ones((num_labels, num_labels), dtype=torch.bool, device=data.device).triu(1)
    radii = _residual_rows(data, inverse, centroids, lambda r: torch.linalg.vector_norm(r, ord=p, dim=-1))
    max_intra = torch.zeros(num_labels, dtype=torch.float64, device=data.device)
    max_intra.scatter_reduce_(0, inverse, radii, "amax")
    return (inter[upper].min() / max_intra.max()).to(torch.float32)
