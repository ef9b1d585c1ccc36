"""The dispatch signature (counterpart of ``dispatch_signature`` in
``torchmetrics_tpu/aot/keys.py``).

The telemetry compile counters key each dispatch on a shape/dtype/structure string of
its ``(args, kwargs)``. The string must be the JAX package's for the same inputs, so
that the two packages' counters and events compare key for key. Hence the JAX rules,
not ``str(tensor.dtype)``:

- dtypes are canonicalized as JAX canonicalizes them with 64-bit types off: an int64
  tensor signs as ``int32(...)``, float64 as ``float32(...)``, uint64 as ``uint32``
  and complex128 as ``complex64``; names are numpy's (``float32``, not
  ``torch.float32``);
- Python scalars are weakly typed and carry a ``*`` (``float32()*``); ``bool`` is
  never weak (``bool()``);
- leaves come in pytree order: tuples and lists in order, dict keys sorted, ``None``
  is no leaf; anything without a shape and a dtype signs as its type's name.

Metadata only: no device is touched.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

_CANONICAL = {"int64": "int32", "float64": "float32", "uint64": "uint32", "complex128": "complex64"}
_SCALAR = {bool: "bool", int: "int32", float: "float32", complex: "complex64"}


def _dtype_token(dtype: Any) -> str:
    name = str(dtype).replace("torch.", "")
    name = {"bool_": "bool", "half": "float16", "float": "float32", "double": "float64", "long": "int64",
            "int": "int32"}.get(name, name)
    return _CANONICAL.get(name, name)


def _leaf_token(leaf: Any) -> str:
    """Shape/dtype token of one input leaf (metadata only)."""
    t = type(leaf)
    if t in _SCALAR:
        return f"{_SCALAR[t]}()" if t is bool else f"{_SCALAR[t]}()*"
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return f"{_dtype_token(leaf.dtype)}{tuple(int(d) for d in leaf.shape)}"
    return t.__name__


def _leaves(tree: Any) -> Iterator[Any]:
    """Pytree leaves in JAX's flatten order."""
    if tree is None:
        return
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "shape"):
        for item in tree:
            yield from _leaves(item)
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


def dispatch_signature(inputs: Optional[tuple]) -> str:
    """Shape/dtype key of a dispatch's ``(args, kwargs)``: the JAX package's string
    for the same inputs."""
    if not inputs:
        return "()"
    return "|".join(_leaf_token(leaf) for leaf in _leaves(inputs)) or "()"
