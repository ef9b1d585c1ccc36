"""Multi-tenant serving engine: vmapped megabatch dispatch over stacked states
(counterpart of ``torchmetrics_tpu/serving/engine.py``).

A metric service holds thousands of logical sessions, each a small per-tenant state
fed a trickle of traffic; one Python dispatch per tenant per batch would cost far more
than the per-tenant math. So all tenants of a *shape class* (the shape/dtype signature
of their batches, the key the compile counters and the AOT cache use) live as one
stack, every tensor-state leaf with a leading tenant-row axis, and many tenants update
in one call:

- ``update(tenant_id, *batch)`` queues the batch on its shape class;
- a **megabatch** is up to ``megabatch_size`` distinct tenants' batches stacked along a
  leading axis and padded with scratch rows to exactly ``megabatch_size``, so one
  program per (shape class × tag) serves every tenant count;
- the program (``Metric._get_vupdate_fn``) gathers the addressed rows, runs the
  single-metric fold on every row under ``torch.func.vmap`` and writes the rows back,
  dispatched through ``Metric._tenant_dispatch`` so the telemetry counters and the AOT
  plane apply. Its launches do not grow with the row count: the confusion matrix's
  counts and FID's sepconv7 convs batch over the rows (``utilities.data.rows_bincount``,
  ``kernels.sepconv.sepconv7_rows``).

Host batches (numpy arrays, CPU tensors) stay on the host until their megabatch is
stacked there and uploaded with one copy per leaf; the template's ``_prepare_inputs``
sees them on the host, as the JAX engine's sees the caller's arrays. Batches already on
the card stay there. Stacks live on the template's device.

PyTorch donates no buffer: the eager program writes the addressed rows into the stack
in place (``index_copy_``). ``on_error="quarantine"`` copies the stack before every
megabatch and restores the copy on failure; a loaded (AOT) program returns a new stack.
Each megabatch dispatch, the copy included, runs inside a ``torch.profiler`` range named
``DISPATCH_RANGE``.

Around the hot path: admission with LRU spill of cold tenants' rows to host memory
(optionally compressed by the quantized sync plane's codecs, ``spill_codec``) and
transparent readmission, a token-bucket admission rate limit with an injectable
``clock``, per-tenant ``compute``/``reset``/checkpoints by slicing the stack, fault
isolation (``on_error="quarantine"``), crash-consistent snapshots and a write-ahead
traffic journal (``serving/durability.py``), windowed tenants (the dual and two-stack
window tiers), the self-warming boot (``aot_cache_dir``) and ``sync_async`` over the
async sync plane.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import aot as _aot
from .. import observability as _observability
from ..aot import keys as _aot_keys
from ..metric import (
    TENANT_COUNT_KEY,
    Metric,
    _dual_fold,
    _stack_fold,
    window_defaults,
    window_stack_geometry,
    window_tier,
)
from ..observability import spans as _spans
from ..observability import tracing as _tracing
from ..parallel import quantize as _quantize
from ..utilities.exceptions import StateCorruptionError, TorchMetricsUserError
from . import durability as _durability

StateDict = Dict[str, Any]

_ON_ERROR_MODES = ("raise", "quarantine")
DISPATCH_RANGE = "ServingEngine.dispatch"  # the profiler range of one megabatch dispatch
# a Python scalar leaf of a batch stacks into a tensor of the AOT plane's dtype for it
# (a scalar enters a program as a value)
_SCALAR_DTYPES = _aot._SCALAR_DTYPES


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs for one :class:`ServingEngine` (the JAX package's, with its checks).

    Args:
        capacity: resident tenant slots per shape-class stack. Each stack allocates
            ``capacity + 1`` rows: the extra row is the scratch slot the megabatch
            padding writes into.
        megabatch_size: tenant rows per dispatch. Every megabatch is padded to exactly
            this many rows, so each shape class runs one program; an undersized flush
            burns scratch rows, an oversized queue splits into several dispatches.
        auto_flush: dispatch a shape class as soon as a full megabatch of distinct
            tenants is pending (otherwise only :meth:`ServingEngine.flush` dispatches).
        spill: evict the least-recently-used tenant's rows to host memory when a stack
            is full (off: admission past capacity raises).
        spill_codec: compress spilled tenant state with the quantized sync plane's
            codecs (``"none"``, exact, the default; ``"bf16"``; ``"int8"``):
            float32/float64 rows shrink 2-4x in host memory; integer/bool rows stay
            exact. Each spill-readmit cycle is one bounded quantization round trip
            (error <= block_range/510 for int8, relative 2^-8 for bf16).
        on_error: ``"raise"`` propagates any dispatch failure (no copies on the hot
            path, the default); ``"quarantine"`` copies the stack before every
            megabatch, restores it on failure, re-drives the entries one tenant at a
            time and quarantines only the offending tenant(s).
        max_tenants_per_sec: admission rate limit, a token bucket refilled at this
            rate (burst: one second's tokens, at least one); a batch arriving with the
            bucket empty is shed (``update`` returns ``False``, ``serve_rejected``
            fires). ``None`` (default) admits everything.
        clock: monotonic-seconds source of the token bucket (default
            ``time.monotonic``); a virtual clock makes admission reproducible.
        aot_cache_dir: activate the AOT plane process-wide at construction, pointed at
            this directory, with ``write_on_miss`` below: the self-warming boot (a
            second boot loads the megabatch programs instead of building them).
        write_on_miss: with ``aot_cache_dir``: write each missed program through.
        sharding: a :class:`~torchmetrics_tpu_torch.parallel.mesh.TenantSharding`
            (``parallel.tenant_sharding``) that places every stack leaf along its row
            axis.
        window: give every tenant a sliding window of this many updates, in the
            constant-memory dual or two-stack tier (tag ``vwupdate``). Metrics whose
            reduce tags admit only the ring tier are refused.
        window_tier: ``"auto"`` derives dual/two_stack from the reduce tags; force
            ``"two_stack"`` for a one-pane hop on sum/mean metrics.
        window_pane: two-stack pane length override.
        journal: directory of a write-ahead traffic journal: every admitted batch
            appends a ``(seq, tenant_id, batch-digest, clock)`` record before it is
            queued, so :meth:`ServingEngine.restore` plus journal replay reaches the
            exact pre-crash state. Only str/int tenant ids can be journaled.
        journal_fsync_every: fsync the journal every this many appends (``1``: no
            admitted batch can be lost).
        journal_segment_records: rotate the journal segment after this many records.
        retain_snapshots: keep only the newest N snapshot generations (and drop the
            journal segments every retained snapshot covers). ``None`` keeps all.
    """

    capacity: int = 1024
    megabatch_size: int = 256
    auto_flush: bool = True
    spill: bool = True
    spill_codec: str = "none"
    on_error: str = "raise"
    max_tenants_per_sec: Optional[float] = None
    clock: Optional[Callable[[], float]] = None
    aot_cache_dir: Optional[str] = None
    write_on_miss: bool = True
    sharding: Any = None
    window: Optional[int] = None
    window_tier: str = "auto"
    window_pane: Optional[int] = None
    journal: Optional[str] = None
    journal_fsync_every: int = 1
    journal_segment_records: int = 512
    retain_snapshots: Optional[int] = None

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.window is not None and not (isinstance(self.window, int) and self.window > 0):
            raise ValueError(f"window must be a positive integer (or None), got {self.window}")
        if self.window_tier not in ("auto", "dual", "two_stack"):
            raise ValueError(
                f"window_tier must be 'auto', 'dual' or 'two_stack', got {self.window_tier!r} "
                "(the ring tier cannot be stacked per tenant — its rows scale with the window)"
            )
        if self.max_tenants_per_sec is not None and not self.max_tenants_per_sec > 0:
            raise ValueError(f"max_tenants_per_sec must be > 0 (or None), got {self.max_tenants_per_sec}")
        if self.clock is not None and not callable(self.clock):
            raise ValueError(f"clock must be a zero-arg callable returning seconds, got {self.clock!r}")
        if self.spill_codec not in _quantize.CODEC_NAMES:
            raise ValueError(
                f"spill_codec must be one of {sorted(_quantize.CODEC_NAMES)}, got {self.spill_codec!r}"
            )
        if self.megabatch_size < 1:
            raise ValueError(f"megabatch_size must be >= 1, got {self.megabatch_size}")
        if self.megabatch_size > self.capacity:
            # every megabatch member needs a resident slot for the duration of its dispatch
            raise ValueError(f"megabatch_size ({self.megabatch_size}) must be <= capacity ({self.capacity})")
        if self.on_error not in _ON_ERROR_MODES:
            raise ValueError(f"Expected `on_error` to be one of {_ON_ERROR_MODES}, got {self.on_error!r}")
        if self.journal is not None and not isinstance(self.journal, str):
            raise ValueError(f"journal must be a directory path (or None), got {self.journal!r}")
        if self.journal_fsync_every < 1:
            raise ValueError(f"journal_fsync_every must be >= 1, got {self.journal_fsync_every}")
        if self.journal_segment_records < 1:
            raise ValueError(f"journal_segment_records must be >= 1, got {self.journal_segment_records}")
        if self.retain_snapshots is not None and self.retain_snapshots < 1:
            raise ValueError(
                f"retain_snapshots must be >= 1 (or None for unbounded), got {self.retain_snapshots}"
            )


class _Tenant:
    """Host-side bookkeeping of one logical session."""

    __slots__ = ("tenant_id", "shape_key", "slot", "update_count", "last_touch",
                 "pending", "quarantined", "error", "spilled", "unfolded", "trace")

    def __init__(self, tenant_id: Hashable) -> None:
        self.tenant_id = tenant_id
        self.shape_key: Optional[str] = None
        self.slot: Optional[int] = None  # row in the shape-class stack; None = not resident
        self.update_count = 0
        self.last_touch = 0
        self.pending = 0  # queued batches not yet dispatched
        self.quarantined = False
        self.error: Optional[str] = None
        # host copy of the state rows while evicted: {"state": {name: np}, "count": float}
        self.spilled: Optional[Dict[str, Any]] = None
        # journal seqs admitted but not yet folded (journaling engines only); a
        # quarantine rolls these back and records them so replay skips them
        self.unfolded: List[int] = []
        # span active at the last admission (telemetry only): the megabatch dispatch
        # links its fan-in back to the request traces it folds
        self.trace: Optional[Any] = None

    @property
    def resident(self) -> bool:
        return self.slot is not None


class _ShapeClass:
    """One stack and its traffic queue: every tenant whose batches share a shape/dtype
    signature.

    The residents are also kept in LRU order, a list of ``(last_touch, seat order)``
    keys sorted ascending, so that choosing an eviction victim reads from its front in
    place of scanning every resident (the JAX package's ``min`` over ``(pending > 0,
    last_touch)``, with the same result: ties fall to the earlier seat)."""

    __slots__ = ("key", "stacked", "free", "slot_tenant", "queue", "pad_example", "dispatches", "lru", "lru_tid",
                 "lru_key", "seats")

    def __init__(self, key: str, stacked: StateDict, capacity: int, pad_example: Tuple[tuple, dict]) -> None:
        self.key = key
        self.stacked = stacked  # tensor states + TENANT_COUNT_KEY, leaves (capacity+1, ...)
        self.free: List[int] = list(range(capacity))  # row `capacity` is the scratch slot
        self.slot_tenant: Dict[int, Hashable] = {}
        self.queue: deque = deque()  # (tenant_id, args, kwargs) in arrival order
        self.pad_example = pad_example  # zero batch used for megabatch padding
        self.dispatches = 0
        self.lru: List[Tuple[int, int]] = []
        self.lru_tid: Dict[Tuple[int, int], Hashable] = {}
        self.lru_key: Dict[Hashable, Tuple[int, int]] = {}
        self.seats = itertools.count()

    def seat(self, slot: int, t: "_Tenant") -> None:
        self.slot_tenant[slot] = t.tenant_id
        self._order(t, next(self.seats))

    def _order(self, t: "_Tenant", seat: int) -> None:
        key = (t.last_touch, seat)
        bisect.insort(self.lru, key)
        self.lru_tid[key] = t.tenant_id
        self.lru_key[t.tenant_id] = key

    def _unorder(self, tid: Hashable) -> Optional[Tuple[int, int]]:
        key = self.lru_key.pop(tid, None)
        if key is not None:
            del self.lru[bisect.bisect_left(self.lru, key)]
            del self.lru_tid[key]
        return key

    def unseat(self, slot: int) -> None:
        tid = self.slot_tenant.pop(slot, None)
        if tid is not None:
            self._unorder(tid)

    def touch(self, t: "_Tenant") -> None:
        """``t``'s ``last_touch`` changed (a resident's new traffic)."""
        key = self._unorder(t.tenant_id)
        if key is not None:
            self._order(t, key[1])

    def reorder(self, tenants: Dict[Hashable, "_Tenant"]) -> None:
        """Rebuild the LRU order from ``slot_tenant`` (after a seating rollback)."""
        self.lru, self.lru_tid, self.lru_key = [], {}, {}
        for tid in self.slot_tenant.values():
            self._order(tenants[tid], next(self.seats))

    def victim(self, pinned: frozenset, tenants: Dict[Hashable, "_Tenant"]) -> Optional[Hashable]:
        """The least recently touched unpinned resident without queued traffic, else the
        least recently touched unpinned one (None if every resident is pinned)."""
        fallback = None
        for key in self.lru:
            tid = self.lru_tid[key]
            if tid in pinned:
                continue
            if tenants[tid].pending == 0:
                return tid
            if fallback is None:
                fallback = tid
        return fallback


class ServingEngine:
    """Sessionized multi-tenant metric serving over one metric template.

    The template must hold only static-shape tensor states (no concat lists). The
    engine works on a private clone, so the caller's object is never touched.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine
        >>> template = MulticlassAccuracy(3, average="micro", validate_args=False, device="cpu")
        >>> engine = ServingEngine(template, ServingConfig(capacity=4, megabatch_size=2))
        >>> engine.update("user-1", torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
        True
        >>> engine.update("user-2", torch.tensor([0, 0, 0, 0]), torch.tensor([0, 1, 2, 2]))
        True
        >>> round(float(engine.compute("user-1")), 4), round(float(engine.compute("user-2")), 4)
        (0.75, 0.25)
        >>> engine.summary()["dispatches"]
        1
    """

    def __init__(self, template: Metric, config: Optional[ServingConfig] = None) -> None:
        if not isinstance(template, Metric):
            raise TorchMetricsUserError(f"ServingEngine needs a Metric template, got {type(template).__name__}")
        self.config = config or ServingConfig()
        if template._list_state_names:
            raise TorchMetricsUserError(
                f"{type(template).__name__} holds dynamic-length concat states and cannot be "
                "served from a stacked pytree; use a binned/static-shape variant."
            )
        # a private clone: the engine's dispatches must not disturb the caller's object,
        # and a per-metric retry's restore writes into `_state`, not into a stack (fault
        # tolerance is engine-level: on_error="quarantine")
        self._metric = template.clone()
        self._metric._reliability = None
        self._metric._fault_hook = None
        self._device = self._metric.device
        self._defaults_t = self._metric._tensor_defaults()
        # windowed tenants: the constant-memory dual/two-stack window per row; the ring
        # tier is refused, its per-row cost is x window
        self._window = self.config.window
        self._wtier: Optional[str] = None
        self._wpane: Optional[int] = None
        self._wdepth: int = 0
        self._wparam_arr: Optional[torch.Tensor] = None
        if self._window is not None:
            tier = self.config.window_tier
            if tier == "auto":
                tier = window_tier(self._metric)
            if tier == "ring":
                raise TorchMetricsUserError(
                    f"{type(template).__name__}'s reduce-tags only admit the 'ring' window "
                    "tier (custom _merge / cat states), whose per-tenant cost is ×window — "
                    "windowed serving needs a dual/two-stack-admissible metric "
                    "(see the window-tier column in docs/serving.md)."
                )
            self._metric._check_windowable(tier)
            self._wtier = tier
            if tier == "two_stack":
                self._wpane, self._wdepth = window_stack_geometry(self._window, self.config.window_pane)
            self._row_defaults = window_defaults(self._metric, self._window, tier, self._wpane)
        else:
            self._row_defaults = dict(self._defaults_t)
        self._classes: Dict[str, _ShapeClass] = {}
        self._tenants: Dict[Hashable, _Tenant] = {}
        self._touch = itertools.count(1)
        # (structure, leaf metadata) -> shape-class key: repeat shapes skip building the
        # signature string
        self._sig_cache: Dict[Any, str] = {}
        #: fault-injection seam (tests): called with the megabatch's tenant ids right
        #: before each dispatch; raising fails the dispatch
        self._fault_hook: Optional[Callable[[List[Hashable]], None]] = None
        self.stats: Dict[str, int] = {
            "dispatches": 0, "tenant_rows": 0, "padded_rows": 0, "flushes": 0,
            "spills": 0, "readmissions": 0, "spill_ns": 0, "spill_bytes_saved": 0,
            "quarantined": 0,
            "dropped_batches": 0, "rejected_batches": 0, "window_rotations": 0,
        }
        # admission token bucket: starts full (one second's burst, at least one token)
        self._clock: Callable[[], float] = self.config.clock or time.monotonic
        self._rl_tokens = (
            max(float(self.config.max_tenants_per_sec), 1.0) if self.config.max_tenants_per_sec is not None else 0.0
        )
        self._rl_last: Optional[float] = None
        # batch-compute memo: None = untried, False = this metric's _compute cannot vmap
        self._vcompute_ok: Optional[bool] = None
        # durability plane: the journal and the cursor pair that makes restore + replay
        # exactly-once (_next_seq = next admission's record, _applied_seq = highest folded)
        self._journal: Optional[_durability.TrafficJournal] = None
        self._next_seq = 1
        self._applied_seq = 0
        self._replaying = False
        self._replay_clock: Optional[float] = None
        if self.config.journal is not None:
            self._journal = _durability.TrafficJournal(
                self.config.journal,
                fsync_every=self.config.journal_fsync_every,
                segment_records=self.config.journal_segment_records,
            )
        if self.config.aot_cache_dir is not None:
            _aot.enable(config=_aot.AotConfig(
                cache_dir=self.config.aot_cache_dir, write_on_miss=self.config.write_on_miss,
            ))

    # ------------------------------------------------------------- shape-classes

    @staticmethod
    def _shape_key(args: tuple, kwargs: dict) -> str:
        sig, tree = _aot_keys.dispatch_signature_parts((args, kwargs))
        return f"{sig}#{tree}"

    def _shape_key_cached(self, args: tuple, kwargs: dict) -> str:
        """The shape-class key through a memo keyed by the tree structure and every
        leaf's (type, shape, dtype): the facts the signature encodes, compared without
        building it. Flat batches (tensors, arrays and scalars, the usual traffic) key by
        their positions and keyword names; nested ones by their tree spec."""
        names = sorted(kwargs)
        metas = [_leaf_meta(a) for a in args] + [_leaf_meta(kwargs[k]) for k in names]
        if None not in metas:
            ck = (len(args), tuple(names), tuple(metas))
        else:
            leaves, spec = pytree.tree_flatten((args, kwargs))
            ck = (str(spec), tuple(_leaf_meta(leaf) for leaf in leaves))
        key = self._sig_cache.get(ck)
        if key is None:
            key = self._shape_key(args, kwargs)
            self._sig_cache[ck] = key
        return key

    def _fresh_stack(self) -> StateDict:
        """A default-valued stack in the engine's layout (rows = capacity + scratch,
        every tensor leaf and :data:`TENANT_COUNT_KEY`, placed by ``sharding``): the one
        definition shared by shape-class creation and window rotation."""
        rows = self.config.capacity + 1
        stacked: StateDict = {
            name: leaf[None].repeat((rows,) + (1,) * leaf.dim()).to(self._device)
            for name, leaf in self._row_defaults.items()
        }
        stacked[TENANT_COUNT_KEY] = torch.zeros((rows,), dtype=torch.float32, device=self._device)
        if self.config.sharding is not None:
            stacked = {k: self.config.sharding.place(v) for k, v in stacked.items()}
        return stacked

    def _ensure_class(self, key: str, args: tuple, kwargs: dict) -> _ShapeClass:
        cls = self._classes.get(key)
        if cls is not None:
            return cls
        # zero batch with the class's leaf shapes and dtypes: its values never reach a
        # real tenant (padding rows write into the scratch slot)
        pad = pytree.tree_map(_zero_like, (args, kwargs))
        cls = _ShapeClass(key, self._fresh_stack(), self.config.capacity, pad)
        self._classes[key] = cls
        return cls

    # ------------------------------------------------------------------ tenants

    def _tenant(self, tenant_id: Hashable) -> _Tenant:
        t = self._tenants.get(tenant_id)
        if t is None:
            t = _Tenant(tenant_id)
            self._tenants[tenant_id] = t
        return t

    def _write_row(self, cls: _ShapeClass, slot: int, state: StateDict, count: float) -> None:
        for name, value in state.items():
            cls.stacked[name][slot] = torch.as_tensor(value).to(self._device)
        cls.stacked[TENANT_COUNT_KEY][slot] = count

    def _admit(self, t: _Tenant, cls: _ShapeClass, pinned: frozenset = frozenset()) -> None:
        """Give ``t`` a slot, evicting the LRU resident if needed, and upload its
        spilled rows (readmission) or a default row. ``pinned`` tenants (the megabatch
        being seated) are never evicted."""
        if t.resident:
            return
        if not cls.free:
            self._evict_lru(cls, pinned)
        slot = cls.free.pop()
        t.slot = slot
        cls.seat(slot, t)
        if t.spilled is not None:
            t0 = time.perf_counter()
            host = t.spilled
            self._write_row(cls, slot, _quantize.decode_spill_state(host["state"]), float(host["count"]))
            dur = time.perf_counter() - t0
            t.spilled = None
            self.stats["readmissions"] += 1
            self.stats["spill_ns"] += int(dur * 1e9)
            rec = _observability._ACTIVE
            if rec is not None:
                rec.record_tenant_spill(self._metric, dur, _quantize.spill_state_bytes(host["state"]), readmit=True)
        else:
            # the slot may hold a previously evicted tenant's stale rows
            self._write_row(cls, slot, self._row_defaults, 0.0)

    def _evict_lru(self, cls: _ShapeClass, pinned: frozenset = frozenset()) -> None:
        if not self.config.spill:
            raise TorchMetricsUserError(
                f"shape-class stack is full ({self.config.capacity} resident tenants) and "
                "spill is disabled — raise ServingConfig.capacity or enable spill."
            )
        # least-recently-touched unpinned resident; tenants with queued traffic go only
        # when every candidate has some
        victim = cls.victim(pinned, self._tenants)
        if victim is None:  # unreachable: megabatch_size <= capacity by config
            raise TorchMetricsUserError(
                "every resident tenant is part of the megabatch being seated — "
                "megabatch_size must not exceed capacity"
            )
        self._spill(self._tenants[victim], cls)

    def _spill(self, t: _Tenant, cls: _ShapeClass) -> None:
        """Move one resident tenant's rows to host memory (LRU spill): a deliberate
        device-to-host copy, its bytes counted from metadata."""
        t0 = time.perf_counter()
        state = {name: _host(cls.stacked[name][t.slot]) for name in self._row_defaults}
        count = float(cls.stacked[TENANT_COUNT_KEY][t.slot])
        enc = _quantize.encode_spill_state(state, self.config.spill_codec)
        dur = time.perf_counter() - t0
        t.spilled = {"state": enc, "count": count}
        cls.unseat(t.slot)
        cls.free.append(t.slot)
        t.slot = None
        self.stats["spills"] += 1
        self.stats["spill_ns"] += int(dur * 1e9)
        nbytes = _quantize.spill_state_bytes(enc)
        raw_bytes = _state_bytes(state)
        self.stats["spill_bytes_saved"] += max(0, raw_bytes - nbytes)
        rec = _observability._ACTIVE
        if rec is not None:
            rec.record_tenant_spill(self._metric, dur, nbytes)
            # the device-to-host copy moved the full-width rows; the codec shrinks what
            # stays on the host, not what crossed
            rec.record_d2h("tenant_spill", raw_bytes, metric=self._metric)

    # ------------------------------------------------------------------ ingest

    def _admit_rate(self) -> bool:
        """Token-bucket admission: refill at ``max_tenants_per_sec``, burst one second's
        tokens, at least one. ``True`` = admitted (one token spent)."""
        rate = self.config.max_tenants_per_sec
        if rate is None:
            return True
        # replay drives the bucket with the journaled admission clock, so a standby's
        # tokens converge on the primary's
        now = self._replay_clock if self._replaying and self._replay_clock is not None else self._clock()
        if self._rl_last is None:
            self._rl_last = now
        cap = max(float(rate), 1.0)
        self._rl_tokens = min(cap, self._rl_tokens + (now - self._rl_last) * float(rate))
        self._rl_last = now
        if self._rl_tokens >= 1.0:
            self._rl_tokens -= 1.0
            return True
        return False

    def _prepare(self, args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
        """Host arrays as CPU tensors (no copy), then the template's ``_prepare_inputs``."""
        args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
        kwargs = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
        return self._metric._prepare_inputs(*args, **kwargs)

    def update(self, tenant_id: Hashable, *args: Any, **kwargs: Any) -> bool:
        """Route one ``(tenant_id, batch)`` into its shape-class megabatch queue
        (dispatched when a full megabatch accumulates, at :meth:`flush`, or before any
        per-tenant read).

        Returns ``True`` when the batch was admitted. With ``max_tenants_per_sec`` set,
        an over-rate batch is shed: ``False`` comes back, ``serve_rejected`` fires, and
        no tenant state, queue or LRU bookkeeping is touched."""
        if not self._admit_rate():
            self.stats["rejected_batches"] += 1
            rec = _observability._ACTIVE
            if rec is not None:
                rec.record_serve_rejected(self._metric, tenant_id)
            return False
        t = self._tenant(tenant_id)
        if t.quarantined:
            raise TorchMetricsUserError(
                f"tenant {tenant_id!r} is quarantined (last error: {t.error}); reset() lifts it."
            )
        args, kwargs = self._prepare(args, kwargs)
        key = self._shape_key_cached(args, kwargs)
        if t.shape_key is None:
            t.shape_key = key
        elif t.shape_key != key:
            raise TorchMetricsUserError(
                f"tenant {tenant_id!r} sent a batch of shape-class {key} but its state lives "
                f"in shape-class {t.shape_key}; per-tenant traffic must keep a stable "
                "batch shape/dtype (pad or bucket inputs)."
            )
        cls = self._ensure_class(key, args, kwargs)
        self._admit(t, cls)
        if self._journal is not None and not self._replaying:
            # write-ahead: the record lands before the batch can dispatch
            seq = self._next_seq
            synced = self._journal.append(
                tenant_id, _durability.batch_digest(args, kwargs), seq,
                t=self._rl_last if self.config.max_tenants_per_sec is not None else 0.0,
            )
            self._next_seq = seq + 1
            self._applied_seq = seq
            t.unfolded.append(seq)
            rec = _observability._ACTIVE
            if rec is not None:
                rec.counters.record_journal_append(synced)
        if _observability._ACTIVE is not None:
            ctx = _spans.current()
            if ctx is not None:
                t.trace = ctx
        cls.queue.append((tenant_id, args, kwargs))
        t.pending += 1
        t.last_touch = next(self._touch)
        cls.touch(t)
        if self.config.auto_flush and len(cls.queue) >= self.config.megabatch_size:
            with _tracing.trace_span(DISPATCH_RANGE):
                self._dispatch_chunk(cls)
        return True

    def flush(self) -> int:
        """Dispatch every pending megabatch (partial ones padded with scratch rows).
        Returns the number of tenant batches served."""
        served = 0
        self.stats["flushes"] += 1
        for cls in self._classes.values():
            while cls.queue:
                with _tracing.trace_span(DISPATCH_RANGE):
                    served += self._dispatch_chunk(cls)
        return served

    # ---------------------------------------------------------------- dispatch

    def _dispatch_chunk(self, cls: _ShapeClass) -> int:
        """Pull up to ``megabatch_size`` distinct tenants' batches off the queue and
        serve them with one dispatch. A tenant with several queued batches contributes
        one per chunk; the rest go back to the queue front in order."""
        entries: List[Tuple[Hashable, tuple, dict]] = []
        seen: set = set()
        holdback: List[Tuple[Hashable, tuple, dict]] = []
        while cls.queue and len(entries) < self.config.megabatch_size:
            tid, args, kwargs = cls.queue.popleft()
            t = self._tenants[tid]
            if t.quarantined:
                t.pending -= 1
                self.stats["dropped_batches"] += 1
                continue
            if tid in seen:
                holdback.append((tid, args, kwargs))
                continue
            seen.add(tid)
            entries.append((tid, args, kwargs))
        cls.queue.extendleft(reversed(holdback))
        if not entries:
            return 0
        if self.config.on_error == "raise":
            self._dispatch_rows(cls, entries)
            return len(entries)
        # quarantine mode: copy, restore on failure, isolate per tenant. Seating happens
        # inside _dispatch_rows (readmissions, evictions), so the rollback restores the
        # seating bookkeeping with the stack
        backup = {k: v.clone() for k, v in cls.stacked.items()}
        seating = self._seating_snapshot(cls, entries)
        try:
            self._dispatch_rows(cls, entries)
            return len(entries)
        except Exception:
            cls.stacked = backup
            self._restore_seating(cls, seating)
        served = 0
        for entry in entries:
            single_backup = {k: v.clone() for k, v in cls.stacked.items()}
            single_seating = self._seating_snapshot(cls, [entry])
            try:
                self._dispatch_rows(cls, [entry])
                served += 1
            except Exception as err:  # noqa: BLE001 — quarantine, never poison the stack
                cls.stacked = single_backup
                self._restore_seating(cls, single_seating)
                self._quarantine(entry[0], err)
        return served

    def _seating_snapshot(
        self, cls: _ShapeClass, entries: List[Tuple[Hashable, tuple, dict]]
    ) -> Tuple[Dict[int, Hashable], List[int], Dict[Hashable, Tuple[Optional[int], Any]]]:
        """Rollback unit of the seating a dispatch may perform: the class's slot maps
        and (slot, spilled) of every tenant seating can touch (current residents and the
        megabatch members). Spilled dicts are never changed in place."""
        tids = set(cls.slot_tenant.values()) | {tid for tid, _, _ in entries}
        return (
            dict(cls.slot_tenant),
            list(cls.free),
            {tid: (self._tenants[tid].slot, self._tenants[tid].spilled) for tid in tids},
        )

    def _restore_seating(
        self, cls: _ShapeClass,
        snap: Tuple[Dict[int, Hashable], List[int], Dict[Hashable, Tuple[Optional[int], Any]]],
    ) -> None:
        slot_tenant, free, per_tenant = snap
        cls.slot_tenant = dict(slot_tenant)
        cls.free = list(free)
        for tid, (slot, spilled) in per_tenant.items():
            t = self._tenants[tid]
            t.slot = slot
            t.spilled = spilled
        cls.reorder(self._tenants)

    def _dispatch_rows(self, cls: _ShapeClass, entries: List[Tuple[Hashable, tuple, dict]]) -> None:
        """One megabatch dispatch: seat the entries, stack and pad them to exactly
        ``megabatch_size`` rows, run the program through ``Metric._tenant_dispatch``,
        then commit the host bookkeeping."""
        m = self.config.megabatch_size
        real = len(entries)
        scratch = self.config.capacity  # the reserved pad row
        # seat every member first, pinned against each other
        pinned = frozenset(tid for tid, _, _ in entries)
        for tid, _, _ in entries:
            t = self._tenants[tid]
            if not t.resident:
                self._admit(t, cls, pinned)
        idx = np.full((m,), scratch, np.int64)
        batches = []
        for i, (tid, args, kwargs) in enumerate(entries):
            idx[i] = self._tenants[tid].slot
            batches.append((args, kwargs))
        mb_args, mb_kwargs = self._stack_batches(batches, cls.pad_example, m - real)
        idx_dev = torch.from_numpy(idx).to(self._device)
        if self._fault_hook is not None:
            self._fault_hook([tid for tid, _, _ in entries])
        if self._wtier is not None:
            fn = self._metric._get_vwupdate_fn(self._wtier, self._wdepth)
            warr = self._wparam()
            cls.stacked = self._metric._tenant_dispatch(
                "vwupdate", cls.stacked, (warr, idx_dev, mb_args, mb_kwargs), {},
                lambda st: fn(st, None, warr, idx_dev, mb_args, mb_kwargs),
            )
        else:
            fn = self._metric._get_vupdate_fn()
            cls.stacked = self._metric._tenant_dispatch(
                "vupdate", cls.stacked, (idx_dev, mb_args, mb_kwargs), {},
                lambda st: fn(st, None, idx_dev, mb_args, mb_kwargs),
            )
        cls.dispatches += 1
        self.stats["dispatches"] += 1
        self.stats["tenant_rows"] += real
        self.stats["padded_rows"] += m - real
        hop = self._window if self._wtier == "dual" else self._wpane
        rotations = 0
        for tid, _, _ in entries:
            t = self._tenants[tid]
            t.update_count += 1
            t.pending -= 1
            if t.unfolded:
                del t.unfolded[0]  # this fold retires its write-ahead admission
            if self._wtier is not None and t.update_count % hop == 0:
                rotations += 1
        self.stats["window_rotations"] += rotations
        rec = _observability._ACTIVE
        if rec is not None:
            links: List[str] = []
            for tid, _, _ in entries:
                t = self._tenants[tid]
                if t.trace is not None:
                    if len(links) < 8:  # bounded: a megabatch folds many requests
                        links.append(t.trace.trace_id)
                    t.trace = None
            rec.record_serve_dispatch(self._metric, real, m - real, links=links)
            if self._wtier is not None:
                rec.counters.record_window_rolls(real, rotations)

    def _stack_batches(self, batches: List[Tuple[tuple, dict]], pad: Tuple[tuple, dict],
                       pads: int) -> Tuple[tuple, dict]:
        """Every leaf of ``batches`` and then ``pads`` copies of ``pad`` stacked along a
        new leading axis and on the engine's device: host leaves stack on the host and
        upload in one copy per leaf, card leaves stack on the card, Python scalars become
        tensors (``_SCALAR_DTYPES``). The pad is flattened once, not once a row (a
        quarantine re-drive pads a single batch to the whole megabatch)."""
        flat = [pytree.tree_flatten(b) for b in batches]
        spec = flat[0][1]
        pad_leaves = pytree.tree_flatten(pad)[0]
        stacked = []
        for leaves, pad_leaf in zip(zip(*(f[0] for f in flat)), pad_leaves):
            leaves = leaves + (pad_leaf,) * pads
            first = leaves[0]
            if isinstance(first, torch.Tensor):
                stacked.append(torch.stack(leaves).to(self._device))
            elif type(first) in _SCALAR_DTYPES:
                stacked.append(torch.tensor(leaves, dtype=_SCALAR_DTYPES[type(first)], device=self._device))
            elif first is None or isinstance(first, str):
                stacked.append(first)  # a static leaf: the same in every batch of the class
            else:
                stacked.append(torch.as_tensor(np.stack([np.asarray(x) for x in leaves])).to(self._device))
        return pytree.tree_unflatten(stacked, spec)

    def _quarantine(self, tenant_id: Hashable, exc: BaseException) -> None:
        t = self._tenants[tenant_id]
        err_text = f"{type(exc).__name__}: {exc}"[:240]
        synced: Optional[bool] = None
        if self._journal is not None and not self._replaying:
            # the quarantine is a transition the journal must carry: it names the
            # rolled-back admissions (admitted, never folded), which replay skips. It
            # takes a seq from the admission counter but does not advance _applied_seq
            seq = self._next_seq
            synced = self._journal.append(
                tenant_id, err_text, seq, kind="quarantine", rolled_back=list(t.unfolded),
            )
            self._next_seq = seq + 1
            t.unfolded = []
        t.quarantined = True
        t.error = err_text
        # drop the tenant's remaining queued batches
        if t.shape_key is not None and t.shape_key in self._classes:
            cls = self._classes[t.shape_key]
            kept = [e for e in cls.queue if e[0] != tenant_id]
            self.stats["dropped_batches"] += len(cls.queue) - len(kept)
            cls.queue = deque(kept)
        t.pending = 0
        self.stats["quarantined"] += 1
        rec = _observability._ACTIVE
        if rec is not None:
            if synced is not None:
                rec.counters.record_journal_append(synced)
            rec.record_quarantine(repr(tenant_id), "vupdate", "quarantined", exc, t.update_count)

    # ---------------------------------------------------------------- reads

    def _wparam(self) -> torch.Tensor:
        """The window parameter (window length for dual, pane length for two-stack) as
        a cached 0-d float32 tensor on the device."""
        if self._wparam_arr is None:
            wparam = self._window if self._wtier == "dual" else self._wpane
            self._wparam_arr = torch.tensor(float(wparam), dtype=torch.float32, device=self._device)
        return self._wparam_arr

    def _fold_row(self, row_state: StateDict) -> StateDict:
        """One tenant's windowed row collapsed into a compute-ready state (identity
        when unwindowed)."""
        if self._wtier is None:
            return row_state
        if self._wtier == "dual":
            return _dual_fold(dict(self._metric._reductions), self._defaults_t, row_state)
        return _stack_fold(dict(self._metric._reductions), self._defaults_t, self._wdepth, row_state, self._wparam())

    def covered_updates(self, tenant_id: Hashable) -> int:
        """How many trailing updates one tenant's value folds (``SlidingWindow.
        covered_updates`` per tenant; the whole history when unwindowed)."""
        n = self._require(tenant_id).update_count
        if self._wtier == "dual":
            return (self._window if n >= self._window else 0) + n % self._window
        if self._wtier == "two_stack":
            full_panes, cc = divmod(n, self._wpane)
            return min(full_panes, self._wdepth) * self._wpane + cc
        return n

    def _tenant_state(self, t: _Tenant) -> StateDict:
        """One tenant's (window-layout) state: a stack slice when resident, the host
        copy on the device when spilled (a read never readmits)."""
        if t.spilled is not None:
            return {k: torch.as_tensor(v).to(self._device)
                    for k, v in _quantize.decode_spill_state(t.spilled["state"]).items()}
        if t.slot is None:
            return {k: v.clone() for k, v in self._row_defaults.items()}
        cls = self._classes[t.shape_key]
        return {name: cls.stacked[name][t.slot] for name in self._row_defaults}

    def compute(self, tenant_id: Hashable) -> Any:
        """One tenant's value from its rows of the stack (pending traffic is flushed
        first; a windowed row folds its window first)."""
        t = self._require(tenant_id)
        if t.quarantined:
            raise TorchMetricsUserError(
                f"tenant {tenant_id!r} is quarantined (last error: {t.error}); reset() lifts it."
            )
        if t.pending:
            self.flush()
        return self._metric._compute(self._fold_row(self._tenant_state(t)))

    def compute_all(self) -> Dict[Hashable, Any]:
        """Every non-quarantined tenant's value (flushes pending traffic once).

        Resident tenants compute through one vmapped call per shape class
        (``vcompute``/``vwcompute``); spilled tenants, and every tenant of a metric
        whose ``_compute`` cannot vmap (a host read), take the per-tenant path. The
        values are the same either way."""
        self.flush()
        out: Dict[Hashable, Any] = {}
        done: set = set()
        if self._vcompute_ok is not False:
            for cls in self._classes.values():
                residents = [(slot, tid) for slot, tid in cls.slot_tenant.items()
                             if not self._tenants[tid].quarantined]
                if not residents:
                    continue
                try:
                    vals = self._vcompute(cls)
                except Exception:  # noqa: BLE001 — the per-tenant path below serves everyone
                    self._vcompute_ok = False
                    break
                self._vcompute_ok = True
                for slot, tid in residents:
                    out[tid] = pytree.tree_map(lambda a, s=slot: a[s], vals)
                    done.add(tid)
        for tid, t in self._tenants.items():
            if tid in done or t.quarantined:
                continue
            out[tid] = self._metric._compute(self._fold_row(self._tenant_state(t)))
        return {tid: out[tid] for tid in self._tenants if tid in out}

    def _pad_on_device(self, cls: _ShapeClass) -> Tuple[tuple, dict]:
        return pytree.tree_map(lambda x: x.to(self._device) if isinstance(x, torch.Tensor) else x, cls.pad_example)

    def _vcompute(self, cls: _ShapeClass) -> Any:
        """One whole-stack compute through ``Metric._tenant_dispatch`` (telemetry and
        AOT apply; the program only reads the stack). Every row computes, so the
        signature is fixed per shape class; the class's zero pad example rides along as
        the signature carrier."""
        pa, pk = self._pad_on_device(cls)
        if self._wtier is not None:
            fn = self._metric._get_vwcompute_fn(self._wtier, self._wdepth)
            warr = self._wparam()
            return self._metric._tenant_dispatch(
                "vwcompute", cls.stacked, (warr,) + tuple(pa), pk, lambda st: fn(st, None, warr, *pa, **pk))
        fn = self._metric._get_vcompute_fn()
        return self._metric._tenant_dispatch("vcompute", cls.stacked, tuple(pa), pk, lambda st: fn(st, None, *pa, **pk))

    def update_count(self, tenant_id: Hashable) -> int:
        return self._require(tenant_id).update_count

    def tenants(self) -> Dict[Hashable, Dict[str, Any]]:
        """Fleet roster: per-tenant residency, quarantine and update status."""
        return {
            tid: {
                "resident": t.resident, "spilled": t.spilled is not None,
                "quarantined": t.quarantined, "update_count": t.update_count,
                "pending": t.pending, "shape_class": t.shape_key,
            }
            for tid, t in self._tenants.items()
        }

    def _require(self, tenant_id: Hashable) -> _Tenant:
        t = self._tenants.get(tenant_id)
        if t is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        return t

    # ------------------------------------------------------------- lifecycle

    def reset(self, tenant_id: Hashable) -> None:
        """Restore one tenant to its default state (lifts a quarantine, drops its queued
        traffic, keeps its slot)."""
        t = self._require(tenant_id)
        if t.shape_key is not None and t.shape_key in self._classes:
            cls = self._classes[t.shape_key]
            kept = [e for e in cls.queue if e[0] != tenant_id]
            self.stats["dropped_batches"] += len(cls.queue) - len(kept)
            cls.queue = deque(kept)
            if t.slot is not None:
                self._write_row(cls, t.slot, self._row_defaults, 0.0)
        t.spilled = None
        t.pending = 0
        t.update_count = 0
        t.quarantined = False
        t.error = None

    def evict(self, tenant_id: Hashable) -> None:
        """Force-spill one resident tenant's state to host (admin path)."""
        t = self._require(tenant_id)
        if t.resident and t.shape_key is not None:
            self._spill(t, self._classes[t.shape_key])

    def forget(self, tenant_id: Hashable) -> None:
        """Drop one tenant entirely: its slot freed (the row back to defaults), its
        spilled copy and bookkeeping discarded. Queued traffic is flushed first, so no
        admitted batch is silently dropped."""
        t = self._require(tenant_id)
        if t.pending:
            self.flush()
        if t.resident and t.shape_key in self._classes:
            cls = self._classes[t.shape_key]
            self._write_row(cls, t.slot, self._row_defaults, 0.0)
            cls.unseat(t.slot)
            cls.free.append(t.slot)
        del self._tenants[tenant_id]

    def _host_rows(self, tenants: List[_Tenant]) -> List[Optional[Tuple[Dict[str, np.ndarray], float]]]:
        """Each tenant's state rows on the host (window layout) and its row count; None
        for a tenant with no state. A spilled tenant decodes its host copy; resident rows
        come down in one gather and one copy a leaf a shape class, not a copy a leaf a
        tenant (the snapshot's and the fleet's reads)."""
        by_class: Dict[str, List[int]] = {}
        for t in tenants:
            if t.spilled is None and t.slot is not None:
                by_class.setdefault(t.shape_key, []).append(t.slot)
        resident: Dict[Tuple[str, int], Tuple[Dict[str, np.ndarray], float]] = {}
        for key, slots in by_class.items():
            stacked = self._classes[key].stacked
            idx = torch.tensor(slots, dtype=torch.int64, device=self._device)
            host = {name: _host(stacked[name].index_select(0, idx)) for name in (*self._row_defaults, TENANT_COUNT_KEY)}
            for i, slot in enumerate(slots):
                resident[(key, slot)] = ({name: host[name][i] for name in self._row_defaults},
                                         float(host[TENANT_COUNT_KEY][i]))
        out: List[Optional[Tuple[Dict[str, np.ndarray], float]]] = []
        for t in tenants:
            if t.spilled is not None:
                out.append((_quantize.decode_spill_state(t.spilled["state"]), float(t.spilled["count"])))
            else:
                out.append(resident.get((t.shape_key, t.slot)))
        return out

    def state_dict(self, tenant_id: Hashable) -> Dict[str, Any]:
        """One tenant's checkpoint, shaped like ``Metric.state_dict`` (tensors on the
        engine's device, the update count and the saved-state count), so it loads into
        a standalone metric and back through :meth:`load_state_dict`. Windowed engines
        checkpoint the window-layout leaves (restorable into the same geometry only)."""
        t = self._require(tenant_id)
        if t.pending:
            self.flush()
        state = self._tenant_state(t)
        out: Dict[str, Any] = {name: v.clone() for name, v in state.items()}
        out["_update_count"] = int(t.update_count)
        out["_saved_states"] = len(out) - 1
        return out

    def load_state_dict(self, tenant_id: Hashable, state_dict: Dict[str, Any]) -> None:
        """Restore one tenant from a checkpoint (its own or, unwindowed, a standalone
        ``Metric.state_dict``; tensors or numpy arrays). The state parks on the host
        (spilled) and uploads into a slot on the tenant's next traffic."""
        t = self._tenant(tenant_id)
        if t.pending:
            raise TorchMetricsUserError(
                f"tenant {tenant_id!r} has {t.pending} undispatched batches; flush() before restoring."
            )
        unknown = [k for k in state_dict if k not in self._row_defaults and not k.startswith("_")]
        if unknown:
            raise TorchMetricsUserError(f"checkpoint carries unknown state keys {sorted(unknown)}")
        missing = [k for k in self._row_defaults if k not in state_dict]
        if missing:
            raise TorchMetricsUserError(
                f"checkpoint is missing state keys {sorted(missing)}"
                + (" (windowed engines need window-layout checkpoints of the same geometry)"
                   if self._wtier is not None else "")
            )
        if t.resident and t.shape_key is not None:
            cls = self._classes[t.shape_key]
            cls.unseat(t.slot)
            cls.free.append(t.slot)
            t.slot = None
        t.update_count = int(state_dict.get("_update_count", 1))
        t.spilled = {
            "state": _quantize.encode_spill_state(
                {k: _host(state_dict[k]) for k in self._row_defaults}, self.config.spill_codec),
            "count": float(t.update_count),
        }
        t.quarantined = False
        t.error = None

    # ------------------------------------------------------------- durability

    def _geometry(self) -> Dict[str, Any]:
        """The config facts a snapshot must match to be restorable."""
        return {
            "capacity": self.config.capacity,
            "megabatch_size": self.config.megabatch_size,
            "spill_codec": self.config.spill_codec,
            "max_tenants_per_sec": self.config.max_tenants_per_sec,
            "window": self._window,
            "window_tier": self._wtier,
            "window_pane": self._wpane,
            "window_depth": self._wdepth,
            "state_keys": sorted(self._row_defaults),
        }

    def snapshot(self, directory: str) -> Dict[str, Any]:
        """Write one crash-consistent whole-engine snapshot generation: pending
        megabatches flushed, then every tenant's rows (window layout included), the
        seating, LRU, quarantine and admission bookkeeping, the stats and the journal
        cursors in one container (``SnapshotStore``). Returns ``{"generation", "path",
        "bytes", "tenants"}``."""
        t0 = time.perf_counter()
        self.flush()
        store = _durability.SnapshotStore(directory)
        sections: Dict[str, np.ndarray] = {}
        tenants_meta: List[Dict[str, Any]] = []
        tenants = list(self._tenants.items())
        rows = self._host_rows([t for _, t in tenants])
        for i, ((tid, t), row) in enumerate(zip(tenants, rows)):
            entry: Dict[str, Any] = {
                "id": _durability.encode_tenant_id(tid),
                "shape_key": t.shape_key,
                "update_count": int(t.update_count),
                "last_touch": int(t.last_touch),
                "quarantined": bool(t.quarantined),
                "error": t.error,
                "state": False,
            }
            if row is not None:
                state, entry["count"] = row
                for name in self._row_defaults:
                    sections[f"t{i}/{name}"] = state[name]
                entry["state"] = True
            tenants_meta.append(entry)
        meta = {
            "engine": self._geometry(),
            "tenants": tenants_meta,
            "stats": dict(self.stats),
            "rl": {"tokens": float(self._rl_tokens), "last": self._rl_last},
            # one tick consumed here shifts every later touch by one; the order, which
            # is all LRU eviction compares, is kept
            "touch": next(self._touch),
            "applied_seq": int(self._applied_seq),
            "next_seq": int(self._next_seq),
        }
        out = store.write(meta, sections)
        out["tenants"] = len(tenants_meta)
        if self.config.retain_snapshots is not None:
            pruned = store.prune(keep_last=self.config.retain_snapshots)
            out["pruned_generations"] = len(pruned)
            if pruned and self._journal is not None:
                # the oldest retained snapshot's cursor bounds what replay can need
                oldest_meta, _ = store.read(store.generations()[0])
                self._journal.prune_covered(int(oldest_meta.get("applied_seq", 0)))
        rec = _observability._ACTIVE
        if rec is not None:
            rec.record_snapshot(self._metric, "write", time.perf_counter() - t0, out["bytes"], out["generation"])
        return out

    def restore(self, directory: str, generation: Optional[int] = None) -> Dict[str, Any]:
        """Load one snapshot generation (the latest by default) into this engine.

        The engine must have the snapshot's geometry (capacity, megabatch size, window
        shape, spill codec, admission rate; a mismatch raises
        ``TorchMetricsUserError``); a torn or corrupt snapshot raises
        ``StateCorruptionError`` and loads nothing. Every tenant parks on the host and
        reseats on its next traffic. Follow with :meth:`replay_journal`."""
        t0 = time.perf_counter()
        store = _durability.SnapshotStore(directory)
        meta, sections = store.read(generation)
        theirs = meta.get("engine")
        mine = self._geometry()
        if theirs != mine:
            raise TorchMetricsUserError(
                f"snapshot engine geometry {theirs!r} does not match this engine's {mine!r}; "
                "restore into an identically configured engine."
            )
        self._classes = {}
        self._tenants = {}
        try:
            for i, entry in enumerate(meta["tenants"]):
                tid = _durability.decode_tenant_id(entry["id"])
                t = _Tenant(tid)
                self._tenants[tid] = t
                t.shape_key = entry["shape_key"]
                t.update_count = int(entry["update_count"])
                t.last_touch = int(entry["last_touch"])
                t.quarantined = bool(entry["quarantined"])
                t.error = entry["error"]
                if entry["state"]:
                    state = {name: np.asarray(sections[f"t{i}/{name}"]) for name in self._row_defaults}
                    t.spilled = {
                        "state": _quantize.encode_spill_state(state, self.config.spill_codec),
                        "count": float(entry["count"]),
                    }
            self.stats = {k: meta["stats"].get(k, 0) for k in self.stats}
            rl = meta["rl"]
            self._rl_tokens = float(rl["tokens"])
            self._rl_last = None if rl["last"] is None else float(rl["last"])
            self._touch = itertools.count(int(meta["touch"]))
            self._applied_seq = int(meta["applied_seq"])
            self._next_seq = int(meta["next_seq"])
        except (KeyError, TypeError, ValueError) as err:
            raise StateCorruptionError(
                f"snapshot in {directory!r} decodes but its bookkeeping is malformed: {err}"
            ) from err
        gens = store.generations()
        used = int(generation) if generation is not None else gens[-1]
        rec = _observability._ACTIVE
        if rec is not None:
            rec.record_snapshot(self._metric, "restore", time.perf_counter() - t0, 0, used)
        return {"generation": used, "tenants": len(self._tenants)}

    def replay_journal(
        self,
        records: List[_durability.JournalRecord],
        fetch: Callable[[_durability.JournalRecord], Tuple[tuple, dict]],
    ) -> int:
        """Roll a restored engine forward through the journal tail.

        ``fetch(record) -> (args, kwargs)`` resolves each record's batch from the
        traffic source's retention buffer; its digest is checked against the journaled
        one before it is applied. Records at or below the snapshot's cursor are skipped,
        so replay is exactly-once however often it is retried. ``kind="quarantine"``
        records re-apply the primary's quarantine, and the admissions they name as
        rolled back are skipped. Returns the number of records applied."""
        t0 = time.perf_counter()
        replayed = 0
        # admissions a later quarantine rolled back on the primary (they come before
        # the quarantine record that dooms them)
        rolled: set = set()
        for jrec in records:
            if jrec.kind == "quarantine":
                rolled.update(jrec.rolled_back)
        for jrec in records:
            if jrec.seq <= self._applied_seq:
                continue  # already folded before the snapshot
            if jrec.kind == "quarantine":
                t = self._tenant(jrec.tenant_id)
                if not t.quarantined:
                    t.quarantined = True
                    t.error = jrec.digest
                    t.pending = 0
                    t.unfolded = []
                    self.stats["quarantined"] += 1
                self._applied_seq = jrec.seq
                self._next_seq = max(self._next_seq, jrec.seq + 1)
                replayed += 1
                continue
            if jrec.seq in rolled:
                self._applied_seq = jrec.seq
                self._next_seq = max(self._next_seq, jrec.seq + 1)
                continue
            args, kwargs = fetch(jrec)
            pargs, pkwargs = self._prepare(args, kwargs)
            if _durability.batch_digest(pargs, pkwargs) != jrec.digest:
                raise StateCorruptionError(
                    f"journal seq {jrec.seq}: refetched batch does not match the journaled "
                    "digest — the retention buffer diverged from what the primary admitted."
                )
            ctx = _spans.enter("replay", jrec.seq, repr(jrec.tenant_id)) if _observability._ACTIVE is not None else None
            self._replaying = True
            self._replay_clock = jrec.t
            try:
                ok = self.update(jrec.tenant_id, *args, **kwargs)
            finally:
                self._replaying = False
                self._replay_clock = None
                if ctx is not None:
                    _spans.exit(ctx)
            if not ok:
                raise StateCorruptionError(
                    f"journal seq {jrec.seq}: replayed admission was shed — the admission "
                    "bucket diverged from the journaled run (config mismatch?)."
                )
            self._applied_seq = jrec.seq
            self._next_seq = max(self._next_seq, jrec.seq + 1)
            replayed += 1
        rec = _observability._ACTIVE
        if rec is not None and replayed:
            rec.record_journal_replay(self._metric, replayed, time.perf_counter() - t0)
        return replayed

    def close(self) -> None:
        """Release the journal (flushes its pending tail); a no-op without one."""
        if self._journal is not None:
            self._journal.close()

    # ------------------------------------------------------------ warm start

    def _megabatch_examples(self, example_inputs: tuple, example_kwargs: dict) -> Tuple[str, _ShapeClass, tuple]:
        """Shape-class key, its (created) stack, and the megabatch's program inputs for
        one example batch as ``device="meta"`` placeholders: the calling convention
        ``_dispatch_rows`` dispatches, so warm-start keys match what traffic looks up."""
        args, kwargs = self._prepare(example_inputs, example_kwargs)
        key = self._shape_key(args, kwargs)
        cls = self._ensure_class(key, args, kwargs)
        m = self.config.megabatch_size

        def placeholder(leaf: Any) -> Any:
            if isinstance(leaf, torch.Tensor):
                return torch.empty((m,) + tuple(leaf.shape), dtype=leaf.dtype, device="meta")
            if type(leaf) in _SCALAR_DTYPES:
                return torch.empty((m,), dtype=_SCALAR_DTYPES[type(leaf)], device="meta")
            return leaf

        mb_args, mb_kwargs = pytree.tree_map(placeholder, (args, kwargs))
        idx = torch.empty((m,), dtype=torch.int64, device="meta")
        if self._wtier is not None:
            return key, cls, (torch.empty((), dtype=torch.float32, device="meta"), idx, mb_args, mb_kwargs)
        return key, cls, (idx, mb_args, mb_kwargs)

    def _serve_tag(self) -> str:
        """The megabatch dispatch tag: ``vwupdate`` when windowed."""
        return "vupdate" if self._wtier is None else "vwupdate"

    def _build_serve_fn(self) -> None:
        """Build the megabatch program for this engine's mode (the windowed getters
        record the geometry ``_aot_program`` exports)."""
        if self._wtier is None:
            self._metric._get_vupdate_fn()
        else:
            self._metric._get_vwupdate_fn(self._wtier, self._wdepth)

    def precompile(self, *example_inputs: Any, force: bool = False, **example_kwargs: Any) -> Dict[str, Any]:
        """Export and compile (or confirm cached) the megabatch program of the example
        batch's shape class ahead of traffic and publish it into the active AOT cache."""
        plane = _aot._ACTIVE
        if plane is None:
            raise TorchMetricsUserError(
                "precompile needs an active AOT plane — pass ServingConfig(aot_cache_dir=...) "
                "or call torchmetrics_tpu_torch.aot.enable(cache_dir) first."
            )
        key, cls, mb = self._megabatch_examples(example_inputs, example_kwargs)
        tag = self._serve_tag()
        self._build_serve_fn()
        try:
            row = plane.precompile_program(
                self._metric, tag, self._metric._aot_program(tag), cls.stacked, mb, {}, force=force)
        except _aot_keys.UnfingerprintableConfig as err:
            row = {"status": "skipped", "reason": f"uncacheable: {err}"}
        return {key: row}

    def prefetch(self, *example_inputs: Any, **example_kwargs: Any) -> Dict[str, Any]:
        """Load the example shape class's cached megabatch program into the dispatch
        memo, without compiling on a miss."""
        plane = _aot._ACTIVE
        if plane is None:
            raise TorchMetricsUserError("prefetch needs an active AOT plane.")
        key, cls, mb = self._megabatch_examples(example_inputs, example_kwargs)
        self._build_serve_fn()
        slot = plane.lookup_dispatch(self._metric, self._serve_tag(), cls.stacked, (mb, {}))
        if slot is not None and slot.compiled is not None:
            return {key: {"status": "loaded", "codec": slot.codec, "load_s": round(slot.load_s, 6)}}
        return {key: {"status": "miss"}}

    # ------------------------------------------------------------ async sync

    def sync_async(
        self,
        process_group: Any = None,
        dist_sync_fn: Optional[Callable] = None,
        reset_window: bool = False,
        sync_config: Optional[Any] = None,
    ) -> Any:
        """Launch a background coalesced sync of every shape class's stack.

        Pending queues are flushed first. ``handle.commit()`` returns
        ``{shape_class_key: synced_stack}``, a cross-rank snapshot of the resident rows;
        the live stacks keep serving traffic. Spilled tenants are not in the stacks and
        not in the snapshot. Cross-rank folding requires every rank to seat the same
        tenant in the same slot; "mean"-tagged leaves are refused (a rowwise mean cannot
        weigh per-row counts).

        ``reset_window=True`` rotates: the frozen stacks keep the current tensors, the
        live stacks restart from defaults and spilled tenants' host copies are dropped.
        Otherwise the live stacks are re-buffered (one copy per leaf), since the
        engine's in-place row writes must not reach the tensors the gather reads.
        ``sync_config`` (:class:`~torchmetrics_tpu_torch.parallel.SyncConfig`) opts the
        gather into the quantized buckets; pass one config across repeated syncs."""
        from ..parallel.async_sync import AsyncSyncHandle

        if self._wtier is not None:
            raise TorchMetricsUserError(
                "sync_async cannot fold windowed tenant stacks across ranks: dual/two-stack "
                "accumulators carry block/pane phase that has no defined rowwise cross-rank "
                "merge. Compute per-rank windowed values instead (compute_all), or sync an "
                "unwindowed engine."
            )
        if any(fx == "mean" for fx in self._metric._reductions.values()):
            raise TorchMetricsUserError(
                "sync_async cannot fold bare 'mean'-reduced stacked states across ranks "
                "without per-row counts; keep sum+weight states instead (see MeanMetric)."
            )
        self.flush()
        keys_list = list(self._classes)
        if not keys_list:
            return AsyncSyncHandle.noop(label="ServingEngine.sync_async")
        states: List[StateDict] = []
        reductions: List[Dict[str, Any]] = []
        for key in keys_list:
            cls = self._classes[key]
            frozen = dict(cls.stacked)
            cls.stacked = self._fresh_stack() if reset_window else {n: v.clone() for n, v in cls.stacked.items()}
            states.append(frozen)
            red = {name: self._metric._reductions.get(name) for name in self._defaults_t}
            red[TENANT_COUNT_KEY] = "sum"  # per-row update counts sum across ranks
            reductions.append(red)
        if reset_window:
            # spilled tenants' host copies are old-window state
            for t in self._tenants.values():
                if t.spilled is not None:
                    t.spilled = None

        def committer(synced: List[StateDict]) -> Dict[str, StateDict]:
            return dict(zip(keys_list, synced))

        return AsyncSyncHandle(
            states, reductions, process_group=process_group, dist_sync_fn=dist_sync_fn,
            committer=committer, label="ServingEngine.sync_async", sync_config=sync_config,
        )

    # ----------------------------------------------------------- observability

    def memory(self) -> Dict[str, Any]:
        """Resident (stacked, device) against spilled (host) state bytes, from
        metadata only."""
        from ..observability import memory as _memory

        classes = {}
        resident = 0
        for key, cls in self._classes.items():
            report = _memory.state_memory(cls.stacked)
            classes[key] = {
                "rows": self.config.capacity + 1,
                "resident_tenants": len(cls.slot_tenant),
                "total_bytes": report["total_bytes"],
            }
            resident += report["total_bytes"]
        spilled = sum(_quantize.spill_state_bytes(t.spilled["state"])
                      for t in self._tenants.values() if t.spilled is not None)
        return {
            "classes": classes,
            "resident_bytes": resident,
            "spilled_tenants": sum(1 for t in self._tenants.values() if t.spilled is not None),
            "spilled_host_bytes": spilled,
        }

    def summary(self) -> Dict[str, Any]:
        """Engine-side stats (independent of any telemetry session)."""
        s = dict(self.stats)
        s["tenants"] = len(self._tenants)
        s["shape_classes"] = len(self._classes)
        s["tenants_per_dispatch"] = round(s["tenant_rows"] / s["dispatches"], 3) if s["dispatches"] else 0.0
        s["tenant_spill_us"] = s.pop("spill_ns") // 1000
        s["window"] = self._window
        s["window_tier"] = self._wtier
        if self._wtier == "two_stack":
            s["window_pane"] = self._wpane
            s["window_depth"] = self._wdepth
        return s

    def block_until_ready(self) -> None:
        """Wait for every stack's pending device work (a timing aid)."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)


def _leaf_meta(leaf: Any) -> Optional[tuple]:
    """(type, shape, dtype) of a tensor or array, (type,) of a scalar or None; None for
    a container."""
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
        return type(leaf), tuple(leaf.shape), leaf.dtype
    if isinstance(leaf, (tuple, list, dict)):
        return None
    return (type(leaf),)


def _zero_like(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return torch.zeros_like(leaf)
    if isinstance(leaf, np.ndarray):
        return np.zeros_like(leaf)
    if type(leaf) in _SCALAR_DTYPES:
        return type(leaf)(0)
    return leaf


def _host(value: Any) -> np.ndarray:
    """A host copy (never a view of a CPU stack row, which later writes would change)."""
    return np.array(value.detach().cpu()) if isinstance(value, torch.Tensor) else np.array(value)


def _state_bytes(state: Dict[str, Any]) -> int:
    return int(sum(np.asarray(v).size * np.asarray(v).dtype.itemsize for v in state.values()))
