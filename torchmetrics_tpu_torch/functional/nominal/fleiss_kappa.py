"""Fleiss' kappa (counterpart of ``torchmetrics_tpu/functional/nominal/fleiss_kappa.py``).

The ``"probs"`` branch collapses each rater's probabilities by numpy's argmax (the first
maximum, a NaN counting as the maximum) into int32 counts per category. The compute is
float32 as in the JAX package; its sums are taken in float64 and rounded once each.
"""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _float32_sum
from ...utilities.data import _jax_dtype, _one_hot


def _fleiss_kappa_update(ratings, mode: str = "counts") -> torch.Tensor:
    ratings = _as_tensor(ratings)
    if mode == "probs":
        if ratings.ndim != 3 or not ratings.is_floating_point():
            raise ValueError(
                "If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        return _one_hot(ratings.argmax(1), ratings.shape[1]).sum(1, dtype=torch.int32)
    if ratings.ndim != 2 or ratings.is_floating_point():
        raise ValueError(
            "If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return _jax_dtype(ratings)


def _fleiss_kappa_compute(counts: torch.Tensor) -> torch.Tensor:
    counts = counts.to(torch.float32)
    total = counts.shape[0]
    num_raters = _float32_sum(counts, 1).max()
    p_i = _float32_sum(counts, 0) / (total * num_raters)
    p_j = (_float32_sum(counts**2, 1) - num_raters) / (num_raters * (num_raters - 1))
    p_bar = (p_j.sum(dtype=torch.float64) / total).to(torch.float32)
    pe_bar = _float32_sum(p_i**2)
    return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)


def fleiss_kappa(ratings, mode: str = "counts") -> torch.Tensor:
    r"""Fleiss' kappa inter-rater agreement: ``(p_bar - pe_bar) / (1 - pe_bar)``.

    ``ratings`` is ``[n_samples, n_categories]`` integer counts (``mode="counts"``) or
    ``[n_samples, n_categories, n_raters]`` probabilities (``mode="probs"``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import fleiss_kappa
        >>> ratings = torch.tensor([[0, 4, 1], [2, 2, 1], [4, 0, 1], [1, 3, 1]])
        >>> fleiss_kappa(ratings, mode='counts')
        tensor(0.0945)
    """
    if mode not in ["counts", "probs"]:
        raise ValueError("Argument ``mode`` must be one of ['counts', 'probs'].")
    return _fleiss_kappa_compute(_fleiss_kappa_update(ratings, mode))
