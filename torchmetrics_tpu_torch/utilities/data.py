"""Data/layout helpers (counterpart of ``torchmetrics_tpu/utilities/data.py``)."""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Callable, List, Optional, Sequence, Union

import torch


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor]]) -> torch.Tensor:
    """Concatenate a (possibly nested) list of tensors along dim 0."""
    if isinstance(x, torch.Tensor):
        return x
    x = [torch.atleast_1d(el) for el in _flatten(x)]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def dim_zero_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(x, dim=0)


def dim_zero_min(x: torch.Tensor) -> torch.Tensor:
    return torch.amin(x, dim=0)


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
    return mask.scatter(dim, idx, 1)  # out of place: vmap batches it (the in-place form falls back per row)


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
    if _batched(fused) or (weights is not None and _batched(weights)):
        bincount = rows_bincount  # under torch.func.vmap: one count for every row at once
    else:
        bincount = _static_bincount if torch.compiler.is_exporting() else torch.bincount
    if weights is None:
        counts = bincount(fused, minlength=nx * ny + 1)[: nx * ny]
        return counts.reshape(nx, ny).to(torch.int32)
    counts = bincount(fused, weights=weights.reshape(-1).float(), minlength=nx * ny + 1)[: nx * ny]
    return counts.reshape(nx, ny)


def _static_bincount(fused: torch.Tensor, weights: Optional[torch.Tensor] = None, minlength: int = 0) -> torch.Tensor:
    """``torch.bincount`` of indices known to lie in ``[0, minlength)``, as the exported
    (AOT) program computes it: an ``index_add_`` into zeros of length ``minlength``.
    ``bincount``'s length depends on the data, which ``torch.export`` carries only as an
    unbacked size (and torch 2.11 types its weighted form as int64, so a compiled program
    reads its float counts as integers). The same counts: integers in int64, and float32
    sums of integer weights, exact in any order below 2**24 a bin."""
    if weights is None:
        return torch.zeros(minlength, dtype=torch.int64, device=fused.device).index_add_(
            0, fused, torch.ones_like(fused))
    return torch.zeros(minlength, dtype=weights.dtype, device=fused.device).index_add_(0, fused, weights)


def _batched(x: torch.Tensor) -> bool:
    """Whether ``x`` is a ``torch.func.vmap`` batched tensor (the serving engine's rows)."""
    return torch._C._functorch.is_batchedtensor(x)


@torch.library.custom_op("torchmetrics_tpu_torch::rows_bincount", mutates_args=())
def rows_bincount(fused: torch.Tensor, weights: Optional[torch.Tensor] = None, minlength: int = 0) -> torch.Tensor:
    """``torch.bincount`` of indices known to lie in ``[0, minlength)`` that batches under
    ``torch.func.vmap``: the serving engine's megabatch counts every tenant row in one
    launch (``torch.bincount`` has no batching rule and would run once per row, and an
    ``index_add_`` into fresh zeros cannot take batched values). The counts equal
    :func:`_static_bincount`'s, row by row."""
    return _static_bincount(fused, weights, minlength)


@rows_bincount.register_fake
def _(fused: torch.Tensor, weights: Optional[torch.Tensor] = None, minlength: int = 0) -> torch.Tensor:
    return fused.new_empty((minlength,), dtype=torch.int64 if weights is None else weights.dtype)


@rows_bincount.register_vmap
def _(info: Any, in_dims: tuple, fused: torch.Tensor, weights: Optional[torch.Tensor] = None, minlength: int = 0):
    """The batching rule: row ``r``'s indices move up by ``r * minlength``, and one
    ``index_add_`` counts the whole megabatch, whatever its row count."""
    rows = info.batch_size
    f = fused.movedim(in_dims[0], 0) if in_dims[0] is not None else fused.expand(rows, *fused.shape)
    offset = torch.arange(rows, device=f.device, dtype=f.dtype).reshape((rows,) + (1,) * (f.dim() - 1))
    flat = (f + offset * minlength).reshape(-1)
    if weights is not None:
        w = weights.movedim(in_dims[1], 0) if in_dims[1] is not None else weights.expand(rows, *weights.shape)
        weights = w.reshape(-1)
    return _static_bincount(flat, weights, rows * minlength).reshape(rows, minlength), 0


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


@lru_cache(maxsize=None)
def _device_constant(make: Callable, device: torch.device, *args) -> torch.Tensor:
    """``make(*args)``, a numpy constant (a window, a filterbank, an index), as a tensor
    on ``device``, made once a device and argument list: a copy from the host waits for
    the device, so an update that reuses it reads nothing back."""
    return torch.as_tensor(make(*args), device=device)
