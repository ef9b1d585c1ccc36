"""Persistent AOT compile cache + warm-start precompile plane (counterpart of
``torchmetrics_tpu/aot``).

A freshly booted process pays for its first dispatch of every metric: the first
call of each program through the allocator, cuBLAS/cuDNN heuristics and, wherever
a program is compiled, the compile itself. The unit worth persisting is the
**program**: this plane exports a metric's pure fold for one input signature with
``torch.export``, compiles it with AOTInductor into a package of generated kernels,
parks it in an on-disk content-addressed cache keyed by the same ``(callable,
shape/dtype signature)`` identity the telemetry compile counters track, and teaches
``Metric._dispatch`` to LOAD that program for a first-seen signature instead of
running the eager path.

The program for a tag is the metric's fold:

- ``update``: ``(tensor states, n, args, kwargs) -> (new tensor states, cat
  appends, n + 1)``;
- ``forward``: ``-> (new tensor states, cat appends, batch value, batch state)``.

``n`` is the update count as a 0-d float32 tensor (the weight of the running-mean
fold); every Python scalar argument enters as a 0-d tensor, so one entry serves every
value of it; cat states stay outside the program.

Usage::

    from torchmetrics_tpu_torch import aot

    # boot-time warm start (or: python -m torchmetrics_tpu_torch.aot.warm_cache --set flagship)
    aot.enable("/var/cache/metrics-aot")
    metric.precompile(example_preds, example_target)     # populates the cache

    # …in the serving process (same cache dir):
    aot.enable("/var/cache/metrics-aot")
    metric.update(preds, target)      # loads the package — no trace, no compile

Design contracts:

- **Opt-in, zero overhead when disabled**: the dispatch path reads one module
  attribute (``_ACTIVE``) — the same discipline as the telemetry layer.
- **Stale-safe keys**: the cache key carries the torch/CUDA/card fingerprint
  (``parallel.mesh.runtime_fingerprint``) plus the metric's code + config
  fingerprint, so an upgraded runtime or a changed metric MISSES; it never loads a
  wrong program.
- **Corruption is a miss**: undecodable bytes anywhere (container, header, checksum,
  codec payload) fall back to the eager path — never an exception on the dispatch
  path.
- **Counters reconcile exactly**: with a telemetry session active,
  ``jit_compiles + jit_cache_hits + aot_cache_hits == dispatches`` holds — a dispatch
  is served by exactly one of {first eager run of a signature, repeat, cache load}.
  ``aot_cache_misses`` and ``aot_deserialize_us`` ride along, and every load emits an
  ``aot_load`` telemetry event + histogram sample.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, Mapping, Optional

import torch

from . import codecs, compat, keys
from .cache import AotCache
from .keys import CACHE_FORMAT_VERSION, cache_key, dispatch_signature, metric_fingerprint

__all__ = [
    "AotCache",
    "AotConfig",
    "AotPlane",
    "CACHE_FORMAT_VERSION",
    "DEFAULT_CACHE_ENV",
    "active_plane",
    "aot_session",
    "cache_key",
    "codecs",
    "compat",
    "default_cache_dir",
    "disable",
    "dispatch_signature",
    "enable",
    "enabled",
    "keys",
    "metric_fingerprint",
]

#: environment override for the default cache directory (the test suite points it at
#: a per-test tmp dir, so tests never share a cache)
DEFAULT_CACHE_ENV = "TORCHMETRICS_TPU_AOT_CACHE"


def default_cache_dir() -> str:
    env = os.environ.get(DEFAULT_CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "torchmetrics_tpu_torch", "aot")


@dataclasses.dataclass(frozen=True)
class AotConfig:
    """Knobs for one AOT plane.

    Args:
        cache_dir: on-disk cache root (default: ``$TORCHMETRICS_TPU_AOT_CACHE`` or
            ``~/.cache/torchmetrics_tpu_torch/aot``).
        store_portable: also write the ``torch.export`` archive next to the
            AOTInductor package — a runtime whose package format drifted still loads
            the program without tracing it.
        write_on_miss: write-through — after a dispatch-time cache miss ran eagerly,
            export and compile that signature into the cache so the NEXT boot
            warm-starts. Costs one export + AOTInductor compile per new signature on
            the dispatch path, so it is off by default; turn it on in long-lived
            services, keep it off in one-shot jobs.
    """

    cache_dir: Optional[str] = None
    store_portable: bool = True
    write_on_miss: bool = False


class _DispatchEntry:
    """Per-``(tag, signature, structure, dtypes)`` memo slot on a metric instance.

    ``compiled is None`` marks a remembered miss (the eager path owns this signature for
    the rest of the process — no repeat disk probes). ``event_pending``/
    ``miss_pending`` are one-shot flags consumed the first time a telemetry session
    observes the dispatch, so counters/events land even when the session starts after
    the plane. ``flops`` is the count the entry's metadata carries for the program
    (a loaded program is opaque to ``FlopCounterMode``).
    """

    __slots__ = ("compiled", "key", "signature", "codec", "nbytes", "load_s",
                 "source", "event_pending", "miss_pending", "store_pending", "flops")

    def __init__(self, compiled: Any, key: str, signature: str, codec: str = "",
                 nbytes: int = 0, load_s: float = 0.0, source: str = "disk",
                 event_pending: bool = False, miss_pending: bool = False,
                 store_pending: bool = False, flops: float = 0.0) -> None:
        self.compiled = compiled
        self.key = key
        self.signature = signature
        self.codec = codec
        self.nbytes = nbytes
        self.load_s = load_s
        self.source = source
        self.event_pending = event_pending
        self.miss_pending = miss_pending
        self.store_pending = store_pending
        self.flops = flops

    def demote(self) -> None:
        """The loaded program refused this call before running it (calling
        convention, device, dtype): the slot becomes a remembered miss."""
        self.compiled = None
        self.source = "demoted"
        self.event_pending = False
        self.miss_pending = True


_SCALAR_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float32, complex: torch.complex64}


def program_inputs(value: Any, device: Any) -> Any:
    """A dispatch's ``(args, kwargs)`` as the program takes them: every Python scalar a
    0-d tensor on ``device`` (a scalar enters the program as a value, never as a
    constant), ``device="meta"`` placeholders zero tensors of their shape and dtype on
    ``device`` (export reads shapes only; the cost count runs on them), the rest as
    given."""
    t = type(value)
    if t in _SCALAR_DTYPES:
        return torch.tensor(value, dtype=_SCALAR_DTYPES[t], device=device)
    if isinstance(value, torch.Tensor):
        return torch.zeros(value.shape, dtype=value.dtype, device=device) if value.is_meta else value
    if isinstance(value, dict):
        return {k: program_inputs(v, device) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(program_inputs(v, device) for v in value)
    return value


def has_placeholder(inputs: Any) -> bool:
    """Whether any leaf of ``inputs`` is a ``device="meta"`` placeholder."""
    return any(isinstance(leaf, torch.Tensor) and leaf.is_meta for leaf in keys._leaves(inputs))


def _counter(device: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _count_flops(program: Any, example: tuple) -> float:
    """Flops of one eager run of ``program`` on the example (the loaded program is
    opaque to ``FlopCounterMode``, so the entry carries this count)."""
    from ..observability.costs import DispatchHarvest

    harvest = DispatchHarvest({}, None)
    try:
        with torch.no_grad(), harvest:
            program(*example)
    except Exception:  # noqa: BLE001 — a cost count must never fail a precompile
        return 0.0
    return harvest.total_flops


class AotPlane:
    """The live plane: one on-disk cache + per-process load bookkeeping."""

    def __init__(self, config: Optional[AotConfig] = None) -> None:
        self.config = config or AotConfig()
        self.cache = AotCache(self.config.cache_dir or default_cache_dir())
        # host-side stats independent of any telemetry session (the CLI reads these);
        # lock-guarded because MetricCollection.precompile prefetches from a thread pool
        self.stats: Dict[str, int] = {
            "loads": 0, "misses": 0, "corrupt": 0, "writes": 0, "load_ns": 0,
        }
        self._stats_lock = threading.Lock()

    def _bump(self, **deltas: int) -> None:
        with self._stats_lock:
            for key, delta in deltas.items():
                self.stats[key] += delta

    # ------------------------------------------------------------ dispatch path

    def lookup_dispatch(
        self, metric: Any, tag: str, tensors: Mapping[str, Any], inputs: Optional[tuple]
    ) -> Optional[_DispatchEntry]:
        """Resolve one dispatch against the cache (memo → disk → miss).

        Returns a :class:`_DispatchEntry` whose ``compiled`` is the loaded program, or
        one marking a remembered miss, or ``None`` when the dispatch cannot be keyed at
        all (no inputs metadata)."""
        if inputs is None:
            return None
        memo = metric.__dict__.get("_aot_memo")
        if memo is None:
            memo = metric.__dict__.setdefault("_aot_memo", {})
        # the memo key carries the structure hash and the exact dtypes too: two calling
        # conventions can flatten to the same leaf signature, and handing one the
        # other's program would fail on the dispatch path
        sig, tree = keys.dispatch_signature_parts(inputs)
        memo_key = (tag, sig, tree, keys.exact_token(inputs))
        slot = memo.get(memo_key)
        if slot is not None:
            return slot
        try:
            key = keys.cache_key(metric, tag, tensors, inputs, signature=sig, tree_hash=tree)
        except keys.UnfingerprintableConfig:
            # the metric cannot be safely identified (tensor or weighted-module config):
            # permanently uncacheable — the eager path owns every signature, no disk
            # probes, no miss counting (nothing was probed)
            slot = _DispatchEntry(None, "", sig, source="unfingerprintable")
            memo[memo_key] = slot
            return slot
        t0 = time.perf_counter()
        entry = self.cache.get(key)
        if entry is None:
            # an entry file that EXISTS but failed container validation is
            # corruption, not absence — both are misses, the distinction is the
            # operator's
            if os.path.exists(self.cache.path_for(key)):
                self._bump(corrupt=1)
            self._bump(misses=1)
            slot = _DispatchEntry(None, key, sig, miss_pending=True, store_pending=self.config.write_on_miss)
            memo[memo_key] = slot
            return slot
        try:
            compiled, codec = codecs.decode_entry(entry.sections)
        except codecs.CodecError:
            # every payload in the entry is undecodable on this runtime — treat as
            # corruption: miss, eager path, no exception
            self._bump(corrupt=1, misses=1)
            slot = _DispatchEntry(None, key, sig, miss_pending=True, store_pending=self.config.write_on_miss)
            memo[memo_key] = slot
            return slot
        load_s = time.perf_counter() - t0
        self._bump(loads=1, load_ns=int(load_s * 1e9))
        slot = _DispatchEntry(
            compiled, key, sig, codec=codec, nbytes=entry.nbytes, load_s=load_s,
            source="disk", event_pending=True, flops=float(entry.meta.get("flops") or 0.0),
        )
        memo[memo_key] = slot
        return slot

    def store_from_dispatch(
        self, metric: Any, tag: str, tensors: Mapping[str, Any], inputs: tuple, entry: _DispatchEntry
    ) -> None:
        """Write-through after a missed dispatch ran eagerly: export and compile the
        program from the shapes of that dispatch (one extra export + compile). Any
        failure is swallowed: a cache write must never break a dispatch."""
        entry.store_pending = False  # one attempt per signature
        try:
            program = metric._aot_program(tag)
            example = (dict(tensors), _counter(metric.device), *program_inputs(tuple(inputs), metric.device))
            exported = compat.export_program(program, example)
            sections, meta = codecs.encode_sections(exported, store_portable=self.config.store_portable)
            meta.update(self._entry_meta(metric, tag, entry.signature, _count_flops(program, example)))
            self.cache.put(entry.key, sections, meta)
            self._bump(writes=1)
            # the program also serves this signature's future dispatches in-process
            entry.compiled, entry.codec = codecs.decode_entry(sections)
            entry.flops = meta["flops"]
            entry.source = "write_on_miss"
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------- precompile

    def precompile_program(
        self,
        metric: Any,
        tag: str,
        program: Any,
        tensors: Mapping[str, Any],
        example_args: tuple,
        example_kwargs: Dict[str, Any],
        force: bool = False,
    ) -> Dict[str, Any]:
        """Export and compile one ``(metric, tag, signature)`` program ahead of traffic
        and publish it. Returns a report row; primes the metric's in-process memo so the
        first real dispatch is already warm. A program that does not export reports
        ``"failed"`` with the exporter's first error line."""
        inputs = (example_args, example_kwargs)
        sig, tree = keys.dispatch_signature_parts(inputs)
        key = keys.cache_key(metric, tag, tensors, inputs, signature=sig, tree_hash=tree)
        row: Dict[str, Any] = {"tag": tag, "signature": sig, "entry": self.cache.entry_name(key)}
        if not force and self.cache.has(key):
            row["status"] = "cached"
            return row
        t0 = time.perf_counter()
        example = (dict(tensors), _counter(metric.device), *program_inputs(inputs, metric.device))
        try:
            exported = compat.export_program(program, example)
            export_s = time.perf_counter() - t0
            sections, meta = codecs.encode_sections(exported, store_portable=self.config.store_portable)
        except Exception as err:  # noqa: BLE001 — a host read or data-dependent shape inside
            row.update({"status": "failed", "error": str(err) if isinstance(err, codecs.CodecError)
                        else codecs._first_line(err)})
            return row
        compile_s = time.perf_counter() - t0
        meta.update(self._entry_meta(metric, tag, sig, _count_flops(program, example)))
        path = self.cache.put(key, sections, meta)
        self._bump(writes=1)
        compiled, codec = codecs.decode_entry(sections)
        memo = metric.__dict__.setdefault("_aot_memo", {})
        memo[(tag, sig, tree, keys.exact_token(inputs))] = _DispatchEntry(
            compiled, key, sig, codec=codec, nbytes=os.path.getsize(path), source="precompile",
            flops=meta["flops"],
        )
        row.update({
            "status": "written",
            "compile_s": round(compile_s, 4),
            "export_s": round(export_s, 4),
            "bytes": os.path.getsize(path),
            "codecs": meta.get("codecs", []),
        })
        return row

    @staticmethod
    def _entry_meta(metric: Any, tag: str, sig: str, flops: float) -> Dict[str, Any]:
        from ..parallel.mesh import runtime_fingerprint

        return {
            "tag": tag,
            "donate": [],
            "signature": sig,
            "class": f"{type(metric).__module__}.{type(metric).__qualname__}",
            "runtime": runtime_fingerprint(),
            "torch": torch.__version__,
            "flops": float(flops),
            "created_unix": int(time.time()),
        }


# ---------------------------------------------------------------------------
# module-level switch — the one attribute the dispatch path reads
# ---------------------------------------------------------------------------

_ACTIVE: Optional[AotPlane] = None


def active_plane() -> Optional[AotPlane]:
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def enable(cache_dir: Optional[str] = None, config: Optional[AotConfig] = None) -> AotPlane:
    """Activate the AOT plane process-wide (replaces any active plane)."""
    global _ACTIVE
    if config is None:
        config = AotConfig(cache_dir=cache_dir)
    elif cache_dir is not None:
        config = dataclasses.replace(config, cache_dir=cache_dir)
    _ACTIVE = AotPlane(config)
    return _ACTIVE


def disable() -> Optional[AotPlane]:
    """Deactivate; returns the (inert) plane for post-hoc inspection."""
    global _ACTIVE
    plane, _ACTIVE = _ACTIVE, None
    return plane


class aot_session:
    """``with aot.aot_session(cache_dir) as plane: ...`` — enable for the block,
    restore the previous plane after."""

    def __init__(self, cache_dir: Optional[str] = None, config: Optional[AotConfig] = None) -> None:
        self._cache_dir = cache_dir
        self._config = config
        self._prev: Optional[AotPlane] = None

    def __enter__(self) -> AotPlane:
        self._prev = _ACTIVE
        return enable(self._cache_dir, self._config)

    def __exit__(self, *exc: Any) -> None:
        global _ACTIVE
        _ACTIVE = self._prev
