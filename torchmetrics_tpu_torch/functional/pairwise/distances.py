"""Pairwise distances and similarities between rows (counterpart of
``torchmetrics_tpu/functional/pairwise/distances.py``).

The JAX package computes each in float32: one matmul for cosine, linear and euclidean
(euclidean by the identity ``clip(|x|^2 + |y|^2 - 2 x y^T, 0)``), and an ``(N, M, D)``
difference for manhattan and minkowski. Here:

- the products are float64 products of the float32 inputs, rounded once, one row block
  at a time into the float32 result: ``allow_tf32`` cannot reach them, and the card and
  the CPU give the same bits. Euclidean keeps the JAX package's identity in float32 on
  those products, with its cancellation, and zeroes the diagonal before the root;
- the differences go in row blocks whose float64 temporary stays under 256 MiB (the
  JAX form would hold 206 GB at 8,192 x 8,192 x 768), each block reduced by one
  ``vector_norm`` in float64 and rounded once;
- integers are exact in int64 and wrap to int32, as the JAX package's int32 arithmetic
  does; cosine and minkowski of integers are float32.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from ...utilities.exceptions import TorchMetricsUserError
from .helpers import _check_input, _reduce_distance_matrix, _row_blocks, _zero_diagonal


def _products(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y.T`` in ``x``'s dtype: floats as float64 products rounded once, integers
    exactly in int64, wrapped to the int32 result."""
    n, m = x.shape[0], y.shape[0]
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if x.is_floating_point():
        y64 = y.double()
        for rows in _row_blocks(n, 8 * m):
            out[rows] = x[rows].double() @ y64.T
        return out
    y64 = y.long()
    for rows in _row_blocks(n, 8 * m * max(y.shape[1], 1)):
        out[rows] = (x[rows, None, :].long() * y64[None]).sum(-1)
    return out


def _squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row sums of squares in ``x``'s dtype (float64 sums rounded once; int64 wrapped)."""
    if x.is_floating_point():
        return x.double().square().sum(1).to(x.dtype)
    return x.long().square().sum(1)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows over their norms (float32 for integers); a zero row gives 0/0: NaN, as in the
    JAX package."""
    x = x if x.is_floating_point() else x.to(torch.float32)
    return x / _squared_norms(x).sqrt()[:, None]


def _pairwise_cosine_similarity_update(x, y=None, zero_diagonal: Optional[bool] = None) -> torch.Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    unit_x = _unit_rows(x)
    return _zero_diagonal(_products(unit_x, unit_x if y is x else _unit_rows(y)), zero_diagonal)


def pairwise_cosine_similarity(
    x, y=None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    r"""Pairwise cosine similarity ``<x,y>/(||x||*||y||)`` between rows of x and y
    (or x with itself when y is omitted, diagonal zeroed by default).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_cosine_similarity
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_cosine_similarity(x, y)
        tensor([[0.5547, 0.8682],
                [0.5145, 0.8437]])
    """
    return _reduce_distance_matrix(_pairwise_cosine_similarity_update(x, y, zero_diagonal), reduction)


def _pairwise_euclidean_distance_update(x, y=None, zero_diagonal: Optional[bool] = None) -> torch.Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_norm, y_norm = _squared_norms(x), _squared_norms(y)
    n, m = x.shape[0], y.shape[0]
    if x.is_floating_point():
        distance = torch.empty((n, m), dtype=x.dtype, device=x.device)
        y64 = y.double()
        for rows in _row_blocks(n, 16 * m):
            product = (x[rows].double() @ y64.T).to(x.dtype)
            # the JAX package's float32 steps: (|x|^2 + |y|^2) - 2 x y^T, clipped at 0
            distance[rows] = ((x_norm[rows, None] + y_norm[None]) - 2 * product).clamp_(min=0)
    else:
        distance = (x_norm[:, None] + y_norm[None] - 2 * _products(x, y).long()).to(torch.int32).clamp_(min=0)
    distance = _zero_diagonal(distance, zero_diagonal)
    return distance.sqrt_() if distance.is_floating_point() else distance.sqrt()


def pairwise_euclidean_distance(
    x, y=None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    r"""Pairwise euclidean distance via the ``||x||^2 + ||y||^2 - 2<x,y>`` identity
    (clamped at zero against cancellation).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_euclidean_distance
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_euclidean_distance(x, y)
        tensor([[3.1623, 2.0000],
                [5.3852, 4.1231]])
    """
    return _reduce_distance_matrix(_pairwise_euclidean_distance_update(x, y, zero_diagonal), reduction)


def _pairwise_linear_similarity_update(x, y=None, zero_diagonal: Optional[bool] = None) -> torch.Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _zero_diagonal(_products(x, y), zero_diagonal)


def pairwise_linear_similarity(
    x, y=None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    r"""Pairwise linear similarity ``<x,y>`` between rows.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_linear_similarity
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_linear_similarity(x, y)
        tensor([[ 2.,  7.],
                [ 3., 11.]])
    """
    return _reduce_distance_matrix(_pairwise_linear_similarity_update(x, y, zero_diagonal), reduction)


def _differences(x: torch.Tensor, y: torch.Tensor, reduce, dtype: torch.dtype) -> torch.Tensor:
    """``reduce`` of the ``(rows, M, D)`` differences, one row block at a time: floats as
    float64 differences (exact for float32), integers as int64."""
    wide = torch.float64 if x.is_floating_point() or dtype.is_floating_point else torch.int64
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    out = torch.empty((n, m), dtype=dtype, device=x.device)
    y_wide = y.to(wide)
    for rows in _row_blocks(n, 8 * m * max(d, 1)):
        out[rows] = reduce(x[rows, None, :].to(wide) - y_wide[None])
    return out


def _l1(diff: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(diff, ord=1, dim=-1) if diff.is_floating_point() else diff.abs_().sum(-1)


def _pairwise_manhattan_distance_update(x, y=None, zero_diagonal: Optional[bool] = None) -> torch.Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _zero_diagonal(_differences(x, y, _l1, x.dtype), zero_diagonal)


def pairwise_manhattan_distance(
    x, y=None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    r"""Pairwise manhattan (L1) distance between rows.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_manhattan_distance
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_manhattan_distance(x, y)
        tensor([[4., 2.],
                [7., 5.]])
    """
    return _reduce_distance_matrix(_pairwise_manhattan_distance_update(x, y, zero_diagonal), reduction)


def _pairwise_minkowski_distance_update(
    x, y=None, exponent: Union[int, float] = 2, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    if not (isinstance(exponent, (float, int)) and exponent >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {exponent}")

    def reduce(diff: torch.Tensor) -> torch.Tensor:
        if math.isfinite(exponent):
            return torch.linalg.vector_norm(diff, ord=exponent, dim=-1)
        return diff.abs_().pow_(exponent).sum(-1).pow_(1.0 / exponent)  # the JAX package's formula: ones

    dtype = x.dtype if x.is_floating_point() else torch.float32
    return _zero_diagonal(_differences(x, y, reduce, dtype), zero_diagonal)


def pairwise_minkowski_distance(
    x,
    y=None,
    exponent: Union[int, float] = 2,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    r"""Pairwise minkowski distance ``(sum |x_i - y_j|^p)^(1/p)`` between rows.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_minkowski_distance
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_minkowski_distance(x, y, exponent=4)
        tensor([[3.0092, 2.0000],
                [5.0317, 4.0039]])
    """
    return _reduce_distance_matrix(_pairwise_minkowski_distance_update(x, y, exponent, zero_diagonal), reduction)
