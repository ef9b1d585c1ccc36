"""Per-dispatch-key cost accounting (counterpart of
``torchmetrics_tpu/observability/costs.py``).

The compile counters (``counters.py``) answer *how many* distinct dispatch
signatures a run saw; this module answers *what each one costs*. The JAX package
harvests XLA's ``cost_analysis()`` and ``memory_analysis()`` from an AOT re-lowering
of the jitted update. Eager PyTorch has no compiled program to ask, so a
:class:`CostRecord` is harvested on the real dispatch itself, at a fresh
``(key, signature)`` pair, with nothing run again:

- ``flops`` — ``torch.utils.flop_counter.FlopCounterMode`` around that one call
  (matmuls, convolutions, attention: the ops it has formulas for). A kernel
  launched through ctypes (``sepconv7``) is invisible to any dispatch mode, so its
  wrapper adds its own count to the open harvest (:func:`add_flops`).
- ``argument_bytes`` — the tensor states and the tensor inputs before the call;
  ``output_bytes`` — the tensor states after it and the cat elements it appended;
  ``alias_bytes`` — the output states that share storage with an argument state.
  All from ``numel``/``element_size``/``data_ptr`` metadata, never a device read.
- ``bytes_accessed``, ``transcendentals``, ``temp_bytes`` and
  ``generated_code_bytes`` are 0: they are properties of a compiled program, which
  an eager dispatch does not have (its kernels are the libraries' and this
  package's, each launched on its own), and no eager mode counts them.

The CUDA allocator's statistics are neither read nor reset here: peak-memory
measurements of the caller stay intact.

The registry reconciles 1:1 with the compile counters: every ``(key, signature)``
pair the counters count as a compile gets exactly one record — a placeholder with
``available=False`` and its ``error`` when the dispatch could not be harvested (a
host dispatch, a harvest that raised) — so ``cost_snapshot().keys() == per-key
compile keys`` always holds.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

#: the JAX package's cost_analysis scalars, in reporting order
COST_FIELDS = ("flops", "bytes_accessed", "transcendentals")
#: the JAX package's memory_analysis scalars (per-program device footprint)
MEMORY_FIELDS = (
    "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "generated_code_bytes",
)


@dataclasses.dataclass(frozen=True)
class CostRecord:
    """Cost of ONE dispatch program — a ``(dispatch key, signature)`` pair.

    ``available=False`` marks a placeholder: the compile was counted but its
    cost could not be harvested (a host dispatch, or a harvest that raised);
    ``error`` says why. The placeholder keeps the registry reconciling 1:1 with the compile counters.
    """

    key: str
    signature: str
    available: bool
    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    alias_bytes: int = 0
    generated_code_bytes: int = 0
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"available": self.available}
        for f in COST_FIELDS + MEMORY_FIELDS:
            out[f] = getattr(self, f)
        if self.error is not None:
            out["error"] = self.error
        return out


# the harvests open on this thread, innermost last: a ctypes-launched kernel adds its
# own flops to each of them, as FlopCounterMode counts an op in every nested mode
_OPEN = threading.local()


def add_flops(n: float) -> None:
    """Add ``n`` flops to every harvest open on this thread (a kernel no dispatch
    mode sees calls this where it launches). Free when none is open."""
    for harvest in getattr(_OPEN, "stack", ()):
        harvest.extra_flops += float(n)


def _nbytes(leaf: Any) -> int:
    numel = getattr(leaf, "numel", None)
    return int(numel()) * int(leaf.element_size()) if callable(numel) else 0


def _tensor_leaves(value: Any) -> List[Any]:
    """The tensor leaves of a nested tuple/list/dict of inputs (metadata walk)."""
    if isinstance(value, (tuple, list)):
        return [leaf for v in value for leaf in _tensor_leaves(v)]
    if isinstance(value, dict):
        return [leaf for k in value for leaf in _tensor_leaves(value[k])]
    return [value] if callable(getattr(value, "numel", None)) else []


class DispatchHarvest:
    """A harvest around one real dispatch: ``with harvest: dispatch()``. It counts the
    dispatch's flops with ``FlopCounterMode`` and takes the argument bytes when it
    opens and the output bytes when :meth:`record` reads the states after the call.
    Never raises out of the dispatch: a mode that could not open leaves ``error``."""

    def __init__(self, state: Dict[str, Any], inputs: Optional[tuple]) -> None:
        self._state = state
        tensors = [v for v in state.values() if callable(getattr(v, "numel", None))]
        self._arg_ptrs = {v.data_ptr() for v in tensors}
        self._lists = {k: len(v) for k, v in state.items() if isinstance(v, list)}
        self.argument_bytes = sum(_nbytes(v) for v in tensors) + sum(
            _nbytes(v) for v in _tensor_leaves(inputs)
        )
        self.extra_flops = 0.0
        self.error: Optional[str] = None
        self._counter: Any = None

    def __enter__(self) -> "DispatchHarvest":
        try:
            from torch.utils.flop_counter import FlopCounterMode

            counter = FlopCounterMode(display=False)
            counter.__enter__()
            self._counter = counter
        except Exception as err:  # noqa: BLE001 — accounting must never break a dispatch
            self.error = f"FlopCounterMode failed: {err!r}"[:240]
        _OPEN.stack = getattr(_OPEN, "stack", ()) + (self,)
        return self

    def __exit__(self, *exc: Any) -> None:
        _OPEN.stack = tuple(h for h in getattr(_OPEN, "stack", ()) if h is not self)
        if self._counter is not None:
            self._counter.__exit__(*exc)

    def record(self, key: str, signature: str) -> CostRecord:
        """The dispatch's :class:`CostRecord`, from the states as the call left them."""
        if self.error is not None:
            return CostRecord(key=key, signature=signature, available=False, error=self.error)
        output = alias = 0
        for name, value in self._state.items():
            if isinstance(value, list):
                output += sum(_nbytes(v) for v in value[self._lists.get(name, 0):])
            elif callable(getattr(value, "numel", None)):
                output += _nbytes(value)
                if value.data_ptr() in self._arg_ptrs:
                    alias += _nbytes(value)
        return CostRecord(
            key=key, signature=signature, available=True,
            flops=float(self._counter.get_total_flops()) + self.extra_flops,
            argument_bytes=self.argument_bytes, output_bytes=output, alias_bytes=alias,
        )


def harvest_record(key: str, signature: str, harvest: Optional[Any]) -> CostRecord:
    """The record of one fresh ``(key, signature)``: ``harvest`` is the dispatch's
    :class:`DispatchHarvest`, or None where nothing could be harvested (a placeholder
    records why not). Never raises."""
    if harvest is None:
        return CostRecord(key=key, signature=signature, available=False,
                          error="no cost harvested (host dispatch or harvest not opened)")
    try:
        return harvest.record(key, signature)
    except Exception as err:  # noqa: BLE001 — accounting must never break a dispatch
        return CostRecord(key=key, signature=signature, available=False,
                          error=f"harvest failed: {err!r}"[:240])


class CostRegistry:
    """Thread-safe per-session store of :class:`CostRecord`s, keyed like the
    compile counters: ``ClassName#n.tag`` → signature → record."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._per_key: Dict[str, Dict[str, CostRecord]] = {}

    def harvest(self, key: str, signature: str, harvest: Optional[Any]) -> CostRecord:
        """Record one dispatch's cost (idempotent per ``(key, signature)``)."""
        with self._lock:
            existing = self._per_key.get(key, {}).get(signature)
        if existing is not None:
            return existing
        record = harvest_record(key, signature, harvest)
        with self._lock:
            self._per_key.setdefault(key, {})[signature] = record
        return record

    def snapshot(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """``{key: {signature: record_dict}}`` — JSON-friendly, immutable copy."""
        with self._lock:
            return {
                key: {sig: rec.to_dict() for sig, rec in sigs.items()}
                for key, sigs in self._per_key.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._per_key = {}
