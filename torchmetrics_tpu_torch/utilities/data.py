"""Data/layout helpers (counterpart of ``torchmetrics_tpu/utilities/data.py``)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor]]) -> torch.Tensor:
    """Concatenate a (possibly nested) list of tensors along dim 0."""
    if isinstance(x, torch.Tensor):
        return x
    x = [torch.atleast_1d(el) for el in _flatten(x)]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def _flatten(x: Sequence) -> list:
    """Flatten one level of nesting."""
    out = []
    for item in x:
        if isinstance(item, (list, tuple)):
            out.extend(item)
        else:
            out.append(item)
    return out


def _flatten_dict(x: dict) -> tuple:
    """Flatten one level of nested dicts; returns (flat_dict, duplicates_found)."""
    new_dict = {}
    duplicates = False
    for key, value in x.items():
        if isinstance(value, dict):
            for k, v in value.items():
                if k in new_dict:
                    duplicates = True
                new_dict[k] = v
        else:
            if key in new_dict:
                duplicates = True
            new_dict[key] = value
    return new_dict, duplicates


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """int32 one-hot over a new last axis; out-of-range labels give an all-zero row
    (``jax.nn.one_hot`` semantics, where ``F.one_hot`` would raise)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(torch.int32)


_TOTAL_ORDER_INT = {torch.float64: torch.int64, torch.float32: torch.int32,
                    torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """An integer key that sorts floats in IEEE total order, the order of
    ``jax.lax.top_k``: -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN. The float's
    bits as a signed integer, with the magnitude bits of the negatives flipped."""
    info = torch.iinfo(_TOTAL_ORDER_INT[x.dtype])
    bits = x.contiguous().view(_TOTAL_ORDER_INT[x.dtype])
    return bits ^ ((bits >> (info.bits - 1)) & info.max)


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """int32 mask of the top-k entries along ``dim``, ranked as ``jax.lax.top_k`` ranks
    them. Among equal values the lower index wins: ``Tensor.topk`` leaves that order
    unspecified, so k > 1 takes the first k of a stable descending sort. Floats sort by
    IEEE total order (``+0.0`` above ``-0.0``, a NaN by its sign bit above ``+inf`` or
    below ``-inf``), where a float sort ties the zeros and puts every NaN first.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utilities.data import select_topk
        >>> select_topk(torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.0]]), topk=3)
        tensor([[1, 1, 0, 1, 0]], dtype=torch.int32)
    """
    mask = torch.zeros_like(prob_tensor, dtype=torch.int32)
    if topk == 1:  # argmax path: ties resolve to the first maximum
        idx = prob_tensor.argmax(dim=dim, keepdim=True)
    else:
        key = _total_order_key(prob_tensor) if prob_tensor.is_floating_point() else prob_tensor
        idx = torch.sort(key, dim=dim, descending=True, stable=True).indices.narrow(dim, 0, topk)
    return mask.scatter_(dim, idx, 1)


def _bincount_2d(
    x: torch.Tensor, y: torch.Tensor, nx: int, ny: int, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Joint histogram (confusion-matrix kernel): ``(nx, ny)`` counts.

    One bincount over the fused index ``x * ny + y``; out-of-range pairs go to a spare
    bin that is dropped, so the shapes stay static. Without ``weights`` the counts are
    taken in int64 (exact and order-independent on CUDA too) and returned as int32.
    With ``weights`` they are float32 sums of the weights per bin, as in the JAX
    package. On CUDA those sums use float atomics: exact for integer weights while each
    bin stays below 2**24, the limit of the JAX package's float32 ``segment_sum``.
    """
    x = x.reshape(-1).long()
    y = y.reshape(-1).long()
    keep = (x >= 0) & (x < nx) & (y >= 0) & (y < ny)
    fused = torch.where(keep, x * ny + y, nx * ny)
    if weights is None:
        counts = torch.bincount(fused, minlength=nx * ny + 1)[: nx * ny]
        return counts.reshape(nx, ny).to(torch.int32)
    counts = torch.bincount(fused, weights=weights.reshape(-1).float(), minlength=nx * ny + 1)[: nx * ny]
    return counts.reshape(nx, ny)


_JAX_DTYPES = {torch.int64: torch.int32, torch.float64: torch.float32, torch.complex128: torch.complex64}


def _jax_dtype(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype ``jnp.asarray`` gives it with 64-bit types off, as the JAX
    package's states hold it: int64 wraps to int32 (a label of 2**33 becomes 0) and
    float64 rounds to float32; other dtypes stay.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utilities.data import _jax_dtype
        >>> _jax_dtype(torch.tensor([2**33 + 1, 1]))
        tensor([1, 1], dtype=torch.int32)
    """
    target = _JAX_DTYPES.get(x.dtype)
    return x if target is None else x.to(target)


def allclose(a: torch.Tensor, b: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """``numpy.allclose`` on two tensors of any dtypes (compared in their promoted dtype).
    On the card the answer is one bool read back to the host."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return bool(torch.allclose(a.to(dtype), b.to(dtype), rtol=rtol, atol=atol))
