"""Dispatch-key signatures and cache-key anatomy for the AOT compile plane (counterpart
of ``torchmetrics_tpu/aot/keys.py``).

A cache entry is addressed by everything that decides which program a dispatch runs,
and nothing else:

    tmaot<format> | package version | runtime fingerprint | metric fingerprint | tag
                  | state signature | input signature | structure hash | exact dtypes

- **runtime fingerprint** (``parallel.mesh.runtime_fingerprint``): torch and CUDA
  versions, backend, card and compute capability, device and process counts, and the
  process-wide flags that change the generated program (TF32, matmul precision,
  default dtype). An AOTInductor package is native code for one runtime: any drift
  must miss, never load.
- **package version** (:func:`package_version`): the coarse invalidator. The bytecode
  digest below only sees the class's own methods; the package version makes every
  library upgrade a miss.
- **metric fingerprint**: class identity, the pure core's code objects
  (``_batch_state``/``_merge``/``_compute``) and the instance's configuration
  attributes, one level of plain-object recursion deep. numpy config arrays hash by
  content. A config that holds a ``torch.Tensor``, or an ``nn.Module`` with parameters
  or buffers, raises :class:`UnfingerprintableConfig`: hashing the values would read
  device memory, and an exported program bakes them in, so such metrics are
  uncacheable rather than false-hittable. (``vars()`` of a module hides its weights
  under ``_parameters``/``_buffers``; the module rule is what keeps FID's trunk from
  being baked into an entry that another instance would hit.)
- **state signature**: tensor-state names, shapes, dtypes and reduction tags.
- **input signature** (:func:`dispatch_signature`): the JAX package's string for the
  same inputs. kwargs commute, Python scalars are value-free (``1.0`` and ``2.0`` are
  one key: the program takes every scalar as a 0-d tensor), and ``device="meta"``
  placeholders sign as concrete tensors of their shape and dtype. The
  :func:`structure_hash` keeps calling conventions with the same leaves apart.
- **exact dtypes**: the port's own field. The input signature canonicalizes dtypes as
  JAX does (int64 signs as ``int32``), which is the JAX program's truth but not
  torch's: an int64 and an int32 target are two programs here. So the exact torch
  dtypes of the states and inputs, and the metric's device type, key too.

A key is a MISS if anything fails to fingerprint: a false miss costs one compile; a
false hit runs the wrong program. Everything here reads host metadata only.
"""

from __future__ import annotations

import enum
import hashlib
import types
from typing import Any, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

#: bump when the key anatomy or the on-disk container changes incompatibly
CACHE_FORMAT_VERSION = 1

_CANONICAL = {"int64": "int32", "float64": "float32", "uint64": "uint32", "complex128": "complex64"}
_SCALAR = {bool: "bool", int: "int32", float: "float32", complex: "complex64"}


class UnfingerprintableConfig(Exception):
    """A metric's configuration cannot be identified without reading device memory (it
    holds tensors, or a module with weights). The plane treats such metrics as
    uncacheable: a false MISS forever beats loading a program whose constants silently
    belong to a different instance."""


def _short_hash(text: str, n: int = 10) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:n]


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


def _is_container(tree: Any) -> bool:
    return isinstance(tree, (tuple, list, dict)) and not hasattr(tree, "shape")


def _leaves(tree: Any) -> Iterator[Any]:
    """Pytree leaves in JAX's flatten order: tuples and lists in order, dict keys sorted,
    ``None`` no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif _is_container(tree):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def _structure(tree: Any) -> str:
    """The tree's structure as JAX prints its ``PyTreeDef`` body: ``*`` a leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if _is_container(tree):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def dispatch_signature(inputs: Optional[tuple]) -> str:
    """Shape/dtype key of a dispatch's ``(args, kwargs)``: the JAX package's string for
    the same inputs. The telemetry compile counters and the AOT cache key both use it,
    which is what lets ``aot_cache_hits`` reconcile exactly against ``dispatches``."""
    return dispatch_signature_parts(inputs)[0]


def dispatch_signature_parts(inputs: Optional[tuple]) -> Tuple[str, str]:
    """``(flat signature, structure hash)``: the form the dispatch path uses."""
    if not inputs:
        return "()", "0"
    sig = "|".join(_leaf_token(leaf) for leaf in _leaves(inputs)) or "()"
    return sig, _short_hash(f"PyTreeDef({_structure(inputs)})", 8)


def structure_hash(inputs: Optional[tuple]) -> str:
    """Short hash of the inputs' structure: keeps ``f(a, b)`` and ``f((a, b))`` apart in
    the cache key and the plane's per-metric memo (same leaves, different calling
    convention, different program). The hash of JAX's ``str(treedef)`` for the same
    structure."""
    return dispatch_signature_parts(inputs)[1]


def exact_token(inputs: Optional[tuple]) -> str:
    """The exact torch dtypes of the input leaves (the input signature canonicalizes
    them as JAX does). Part of the plane's memo key and of the cache key."""
    return ",".join(str(leaf.dtype).replace("torch.", "") if isinstance(leaf, torch.Tensor) else type(leaf).__name__
                    for leaf in _leaves(inputs or ()))


def _value_token(value: Any, depth: int = 1) -> str:
    """Config-attribute token for the metric fingerprint. Primitives, dtypes, devices
    and enum members by value, numpy arrays by content hash, callables by qualname,
    other objects by type plus one level of their own public attributes. Tensors and
    modules that hold weights raise :class:`UnfingerprintableConfig`."""
    if value is None or isinstance(value, (bool, int, float, complex, str, torch.dtype, torch.device, enum.Enum)):
        return repr(value)
    if isinstance(value, (tuple, list)):
        inner = ",".join(_value_token(v, depth) for v in value)
        return f"{type(value).__name__}[{inner}]"
    if isinstance(value, dict):
        inner = ",".join(f"{k!r}:{_value_token(v, depth)}" for k, v in sorted(value.items(), key=lambda kv: repr(kv[0])))
        return f"dict[{inner}]"
    if isinstance(value, (np.ndarray, np.generic)):
        arr = np.asarray(value)
        return f"np:{arr.dtype}{arr.shape}:{hashlib.sha256(arr.tobytes()).hexdigest()[:12]}"
    if isinstance(value, torch.Tensor):
        # a tensor in the CONFIG (not an input: inputs are keyed by shape and dtype) is
        # a constant the exported program bakes in; hashing its values would read
        # device memory, so the metric is uncacheable rather than false-hittable
        raise UnfingerprintableConfig(
            f"config attribute holds a tensor ({_dtype_token(value.dtype)}{tuple(value.shape)}); "
            "hashing it would read device memory — keep program-shaping config as "
            "numpy/python values to make this metric AOT-cacheable"
        )
    if isinstance(value, torch.nn.Module):
        if any(True for _ in value.parameters()) or any(True for _ in value.buffers()):
            raise UnfingerprintableConfig(
                f"config attribute holds a module with weights ({type(value).__qualname__}); "
                "an exported program would bake one instance's weights into an entry that "
                "another instance would hit"
            )
        return f"module:{type(value).__module__}.{type(value).__qualname__}"
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        raise UnfingerprintableConfig(
            f"config attribute holds a device array ({value.dtype}{tuple(value.shape)}); "
            "hashing it would read device memory"
        )
    if callable(value):
        return f"fn:{getattr(value, '__module__', '?')}.{getattr(value, '__qualname__', type(value).__name__)}"
    if depth > 0 and hasattr(value, "__dict__"):
        inner = ",".join(
            f"{k}={_value_token(v, depth - 1)}"
            for k, v in sorted(vars(value).items())
            if not k.startswith("_")
        )
        return f"obj:{type(value).__module__}.{type(value).__qualname__}({inner})"
    return f"obj:{type(value).__module__}.{type(value).__qualname__}"


# runtime/bookkeeping attributes that never shape the compiled program
_FINGERPRINT_SKIP = frozenset({
    "compute_on_cpu", "dist_sync_on_step", "process_group", "dist_sync_fn",
    "distributed_available_fn", "sync_on_compute", "compute_with_cache",
})


def _code_digest(h: "hashlib._Hash", func: Any) -> None:
    code = getattr(func, "__code__", None)
    if code is None:
        h.update(repr(func).encode())
        return
    _digest_code(h, code)


def _digest_code(h: "hashlib._Hash", code: types.CodeType) -> None:
    """A code object's bytecode and constants; a nested function's code object by its
    own digest, since its ``repr`` holds its address, which differs from process to
    process (a key with it would never hit in a fresh process)."""
    h.update(code.co_code)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _digest_code(h, const)
        else:
            h.update(repr(const).encode())


def package_version() -> str:
    """The installed package's own version, folded into every cache key: the coarse
    invalidator that makes any library upgrade a guaranteed miss."""
    try:
        from .. import __version__

        return str(__version__)
    except Exception:  # noqa: BLE001 — a versionless build still gets a stable key
        return "unversioned"


def metric_fingerprint(metric: Any) -> str:
    """Identity of the program-shaping parts of one metric instance.

    Raises :class:`UnfingerprintableConfig` when the config cannot be identified
    without device reads (the plane then treats the metric as uncacheable)."""
    cls = type(metric)
    h = hashlib.sha256()
    for name in ("_batch_state", "_merge", "_compute"):
        fn = getattr(cls, name, None)
        if fn is not None:
            _code_digest(h, fn)
    config_parts = []
    for k, v in sorted(metric.__dict__.items()):
        if k.startswith("_") or k in _FINGERPRINT_SKIP:
            continue
        config_parts.append(f"{k}={_value_token(v)}")
    h.update(";".join(config_parts).encode("utf-8"))
    return f"{cls.__module__}.{cls.__qualname__}:{h.hexdigest()[:16]}"


def state_signature(tensors: Mapping[str, Any], reductions: Mapping[str, Any]) -> str:
    """Tensor-state layout of the state argument."""
    parts = []
    for name in sorted(tensors):
        red = reductions.get(name)
        red_tok = red if isinstance(red, (str, type(None))) else getattr(red, "__qualname__", "callable")
        parts.append(f"{name}:{_leaf_token(tensors[name])}:{red_tok}")
    return ",".join(parts) or "(stateless)"


def cache_key(
    metric: Any,
    tag: str,
    tensors: Mapping[str, Any],
    inputs: Optional[tuple],
    runtime: Optional[str] = None,
    signature: Optional[str] = None,
    tree_hash: Optional[str] = None,
) -> str:
    """The full cache key for one ``(metric, tag, input signature)`` program.
    ``signature``/``tree_hash`` accept precomputed parts (the dispatch path already has
    them); omitted, they derive from ``inputs``."""
    if runtime is None:
        from ..parallel.mesh import runtime_fingerprint

        runtime = runtime_fingerprint()
    if signature is None or tree_hash is None:
        signature, tree_hash = dispatch_signature_parts(inputs)
    states = ",".join(f"{k}:{str(tensors[k].dtype).replace('torch.', '')}" for k in sorted(tensors))
    device = getattr(metric, "device", None)
    return "|".join([
        f"tmaot{CACHE_FORMAT_VERSION}",
        f"pkg={package_version()}",
        runtime,
        metric_fingerprint(metric),
        f"tag={tag}",
        f"state={state_signature(tensors, getattr(metric, '_reductions', {}))}",
        f"in={signature}",
        f"tree={tree_hash}",
        f"exact={getattr(device, 'type', device)}:{states};{exact_token(inputs)}",
    ])
