"""Procrustes disparity (counterpart of ``torchmetrics_tpu/functional/shape/procrustes.py``).

Batched orthogonal Procrustes analysis: centre, divide by the Frobenius norm, one SVD of
each ``(D, D)`` cross-covariance, rotation ``u @ vt`` and scale ``sum(w)``, then the
squared residual. The inputs are taken as float32, as in the JAX package; the steps run
in float64 and the results are rounded once.

The SVD of 2-D and 3-D clouds (``D <= 3``, shapes and poses) is a one-sided Jacobi SVD in
plain torch ops, batched over the samples with a fixed number of sweeps:
``torch.linalg.svd`` reads the solver's status back to the host on CUDA, which would make
every update wait for the card. Where a singular value is zero, its column of ``u`` is
completed to an orthonormal basis. Above ``D = 3`` the Jacobi's launches grow as
``D**2``, so wider clouds take one ``torch.linalg.svd`` of the whole batch, and an update
reads the host there. Where singular values coincide (or one is zero) the rotation is not
unique, and neither is the JAX package's: LAPACK and this SVD may pick different ones,
while the disparity and the scale, which depend on the singular values only, agree.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ...utilities.checks import _as_tensor, _check_same_shape

_RANK_TOL = 1e-12  # a singular value below this share of the largest counts as zero
_JACOBI_MAX_D = 3  # the widest cross-covariance the Jacobi SVD takes; wider ones go to torch.linalg.svd
# Sweeps over all column pairs: 3x3 matrices converge to float64 precision in 4 and 2x2
# ones in 1 (20,000 random ones, and rank-deficient, clustered and scaled-identity ones);
# two more sweeps are the margin.
_SWEEPS = 6


def _jacobi_svd(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(u, w, vt)`` of a batch of square float64 matrices ``(B, D, D)``, unsorted, for
    ``D <= 3`` (the sweep count is measured there only).

    Each rotation makes a pair of columns of ``a @ v`` orthogonal (Hestenes); after the
    sweeps the column norms are the singular values and the normalised columns ``u``.
    ``a @ v`` and ``v`` are rotated together, stacked as one ``(B, 2D, D)`` tensor.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.shape.procrustes import _jacobi_svd
        >>> a = torch.tensor([[[3.0, 0.0], [4.0, 5.0]]], dtype=torch.float64)
        >>> u, w, vt = _jacobi_svd(a)
        >>> torch.allclose(u @ torch.diag_embed(w) @ vt, a), sorted(w[0].tolist())
        (True, [2.2360679774997894, 6.708203932499369])
    """
    d = a.shape[-1]
    if d > _JACOBI_MAX_D:
        raise ValueError(f"The Jacobi SVD takes matrices up to {_JACOBI_MAX_D}x{_JACOBI_MAX_D}, got {d}x{d}")
    bv = torch.cat([a, torch.eye(d, dtype=a.dtype, device=a.device).expand_as(a)], dim=-2)
    for _ in range(_SWEEPS):
        for p in range(d - 1):
            for q in range(p + 1, d):
                mp, mq = bv[..., p].clone(), bv[..., q].clone()
                bp, bq = mp[..., :d], mq[..., :d]
                alpha, beta, gamma = (bp * bp).sum(-1), (bq * bq).sum(-1), (bp * bq).sum(-1)
                # the smaller root t of t^2 + 2 zeta t - 1 = 0 zeroes the pair's inner product
                zeta = (beta - alpha) / torch.where(gamma == 0, 1.0, 2 * gamma)
                t = torch.where(zeta < 0, -1.0, 1.0) / (zeta.abs() + torch.sqrt(1 + zeta * zeta))
                t = torch.where(gamma == 0, 0.0, t)
                c = torch.rsqrt(1 + t * t)
                s = (c * t)[..., None]
                c = c[..., None]
                bv[..., p] = c * mp - s * mq
                bv[..., q] = s * mp + c * mq
    b, v = bv[..., :d, :], bv[..., d:, :]
    w = torch.linalg.vector_norm(b, dim=-2)
    good = w > _RANK_TOL * w.amax(-1, keepdim=True)
    u = torch.where(good[..., None, :], b / torch.where(good, w, 1.0)[..., None, :], 0.0)
    # complete the columns of the zero singular values: the unit vector of the basis
    # that is farthest from the columns so far, orthogonalised against them
    basis = torch.eye(d, dtype=a.dtype, device=a.device)
    for k in range(d):
        residual = basis - u @ (u.transpose(-1, -2) @ basis)
        norms = torch.linalg.vector_norm(residual, dim=-2)
        pick = norms.argmax(-1)
        column = residual.gather(-1, pick[..., None, None].expand(*pick.shape, d, 1))[..., 0]
        column = column / norms.gather(-1, pick[..., None])
        u[..., k] = torch.where(good[..., k, None], u[..., k], column)
    return u, w, v.transpose(-1, -2)


def _procrustes(point_cloud1, point_cloud2) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float64 ``(disparity (B,), scale (B, 1), rotation (B, D, D))`` of float32 inputs."""
    point_cloud1 = _as_tensor(point_cloud1).to(torch.float32)
    point_cloud2 = _as_tensor(point_cloud2).to(torch.float32)
    _check_same_shape(point_cloud1, point_cloud2)
    if point_cloud1.ndim != 3:
        raise ValueError(
            "Expected both datasets to be 3D tensors of shape (N, M, D), where N is the batch size, M is the number of"
            f" data points and D is the dimensionality of the data points, but got {point_cloud1.ndim} dimensions."
        )
    p1, p2 = point_cloud1.double(), point_cloud2.double()
    p1 = p1 - p1.mean(1, keepdim=True)
    p2 = p2 - p2.mean(1, keepdim=True)
    p1 = p1 / torch.linalg.vector_norm(p1, dim=(1, 2), keepdim=True)
    p2 = p2 / torch.linalg.vector_norm(p2, dim=(1, 2), keepdim=True)
    cross = (p2.transpose(1, 2) @ p1).transpose(1, 2)
    svd = _jacobi_svd if cross.shape[-1] <= _JACOBI_MAX_D else torch.linalg.svd
    u, w, vt = svd(cross)
    rotation = u @ vt
    scale = w.sum(1, keepdim=True)
    p2 = scale[:, None] * (p2 @ rotation.transpose(1, 2))
    disparity = (p1 - p2).square().sum((1, 2))
    return disparity, scale, rotation


def procrustes_disparity(
    point_cloud1: torch.Tensor, point_cloud2: torch.Tensor, return_all: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Batched Procrustes analysis (scipy.spatial.procrustes semantics over a leading
    batch axis). Returns per-sample disparity, plus scale and rotation when
    ``return_all=True``, all float32.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import procrustes_disparity
        >>> point_set1 = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]])
        >>> point_set2 = torch.tensor([[[0.0, 0.0], [2.0, 0.0], [2.0, 2.0], [0.0, 2.0]]])
        >>> procrustes_disparity(point_set1, point_set2)
        tensor([2.4652e-32])
    """
    disparity, scale, rotation = (t.to(torch.float32) for t in _procrustes(point_cloud1, point_cloud2))
    if return_all:
        return disparity, scale, rotation
    return disparity
