"""State-memory accounting from tensor metadata — zero device traffic (counterpart
of ``torchmetrics_tpu/observability/memory.py``).

Every number here comes from ``shape``/``dtype``/``numel``/``element_size``
(torch tensors and numpy arrays expose them without a device read), so
``Metric.state_memory()`` is safe under ``torch.cuda.set_sync_debug_mode("error")``
and inside a hot loop. A tensor's bytes are ``numel() * element_size()`` (``.size``
is a method on a tensor, not a count), and its dtype is named as numpy names it
(``float32``, not ``torch.float32``), so the reports equal the JAX package's.

Two consumers:

- :func:`state_memory` — a point-in-time per-state byte report, the body of
  ``Metric.state_memory()`` / ``MetricCollection.state_memory()``.
- :class:`StateMemoryTracker` — owned by the telemetry recorder: tracks the
  peak state footprint per metric across updates and fires the
  unbounded-growth sentinel when a list ("cat") state crosses a configurable
  byte threshold. Cat states are appended per batch and concatenated only at
  compute, which makes them the #1 silent OOM in long evals — nothing else in
  the runtime grows without bound.

Stdlib-only (no torch import): a tensor is recognised by its methods.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def leaf_nbytes(leaf: Any) -> int:
    """Bytes held by one array-like leaf, from metadata only (0 for non-arrays)."""
    numel = getattr(leaf, "numel", None)
    element_size = getattr(leaf, "element_size", None)
    if callable(numel) and callable(element_size):  # a torch.Tensor
        return int(numel()) * int(element_size())
    size = getattr(leaf, "size", None)
    itemsize = getattr(getattr(leaf, "dtype", None), "itemsize", None)
    if size is None or callable(size) or itemsize is None:
        return 0
    return int(size) * int(itemsize)


def _tensor_info(value: Any) -> Dict[str, Any]:
    return {
        "kind": "tensor",
        "nbytes": leaf_nbytes(value),
        "shape": tuple(getattr(value, "shape", ()) or ()),
        "dtype": _dtype_name(getattr(value, "dtype", "")),
    }


def state_memory(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Per-state byte accounting for one metric's state dict.

    Returns ``{"states": {name: info}, "total_bytes": int}`` where tensor
    states carry ``shape``/``dtype`` and list (cat) states carry ``elements``
    — the growth axis the sentinel watches.
    """
    states: Dict[str, Any] = {}
    total = 0
    for name, value in state.items():
        if isinstance(value, list):
            nbytes = sum(leaf_nbytes(x) for x in value)
            info: Dict[str, Any] = {"kind": "list", "nbytes": nbytes, "elements": len(value)}
        else:
            info = _tensor_info(value)
        states[name] = info
        total += info["nbytes"]
    return {"states": states, "total_bytes": total}


class StateMemoryTracker:
    """Peak-footprint tracking + the unbounded-growth sentinel (one per session).

    ``observe(name, state)`` is called by the recorder after every instrumented
    update/forward; it returns the list states that crossed ``warn_bytes`` for
    the FIRST time (the recorder turns those into events + a rank-zero warning
    — this module stays stdlib and side-effect-free).
    """

    def __init__(self, warn_bytes: int) -> None:
        self.warn_bytes = int(warn_bytes)
        self._current: Dict[str, Dict[str, Any]] = {}
        self._peak: Dict[str, int] = {}
        self._peak_per_state: Dict[str, Dict[str, int]] = {}
        self._warned: set = set()
        # name -> state -> (list_id, elements_summed, nbytes): list states are
        # append-only between resets, so re-summing only the tail keeps a
        # per-update observation O(new elements) instead of O(all elements) —
        # a 100k-batch cat-state eval must not go quadratic in its own telemetry
        self._list_cache: Dict[str, Dict[str, Tuple[int, int, int]]] = {}

    def _report(self, name: str, state: Mapping[str, Any]) -> Dict[str, Any]:
        cache = self._list_cache.setdefault(name, {})
        states: Dict[str, Any] = {}
        total = 0
        for sname, value in state.items():
            if isinstance(value, list):
                n = len(value)
                cached = cache.get(sname)
                if cached is not None and cached[0] == id(value) and cached[1] <= n:
                    nbytes = cached[2] + sum(leaf_nbytes(x) for x in value[cached[1]:])
                else:  # fresh/replaced/shrunk list (reset): full re-sum
                    nbytes = sum(leaf_nbytes(x) for x in value)
                cache[sname] = (id(value), n, nbytes)
                info: Dict[str, Any] = {"kind": "list", "nbytes": nbytes, "elements": n}
            else:
                info = _tensor_info(value)
            states[sname] = info
            total += info["nbytes"]
        return {"states": states, "total_bytes": total}

    def observe(self, name: str, state: Mapping[str, Any]) -> Tuple[Tuple[str, Dict[str, Any]], ...]:
        report = self._report(name, state)
        self._current[name] = report
        total = report["total_bytes"]
        if total > self._peak.get(name, -1):
            self._peak[name] = total
        peaks = self._peak_per_state.setdefault(name, {})
        crossings = []
        for sname, info in report["states"].items():
            if info["nbytes"] > peaks.get(sname, -1):
                peaks[sname] = info["nbytes"]
            if info["kind"] != "list" or info["nbytes"] <= self.warn_bytes:
                continue
            wkey = (name, sname)
            if wkey in self._warned:
                continue
            self._warned.add(wkey)
            crossings.append((sname, info))
        return tuple(crossings)

    def snapshot(self) -> Dict[str, Any]:
        """``{metric: {current_bytes, peak_bytes, states, per_state_peak}}``."""
        return {
            name: {
                "current_bytes": report["total_bytes"],
                "peak_bytes": self._peak.get(name, report["total_bytes"]),
                "states": {k: dict(v) for k, v in report["states"].items()},
                "per_state_peak": dict(self._peak_per_state.get(name, {})),
            }
            for name, report in self._current.items()
        }
