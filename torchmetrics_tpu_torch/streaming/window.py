"""Windowed and decayed metric transforms over infinite streams (counterpart of
``torchmetrics_tpu/streaming/window.py``).

A metric accumulates forever: its state is a sufficient statistic of the whole stream.
Monitoring asks windowed questions ("accuracy over the last 10k predictions", "error
rate with a one-hour halflife"), which the two transforms here answer with bounded
state and O(1) work per update:

- :class:`SlidingWindow`: the metric over the last ``window`` updates, in the tier its
  reduce tags admit (:func:`~torchmetrics_tpu_torch.metric.window_tier`): a
  constant-size dual pair (sum/mean), a paned two-stack (max/min/callable semigroups)
  or the exact per-update bucket ring (custom merges, cat states).
- :class:`ExponentialDecay`: the metric with exponentially discounted history; the
  decay folds into the sum, count and mean leaves at update time.

Each update is one step under its own dispatch tag (``wdual``, ``wstack``, ``wupdate``,
``dupdate``) through ``Metric._window_dispatch``, so the retry plane, telemetry and
the AOT warm-start plane apply to windowed traffic as to ``update``. The window, pane
and decay enter each step as 0-d tensors, so one program serves every length. The
wrappers are stream-local: ``merge_state`` and a distributed ``sync`` raise.

PyTorch donates no buffer: a step returns a new state and leaves the old one intact,
and under a retry policy the state is also cloned before the first attempt (the
reliability plane's rule), so a failed attempt rolls the window back.

The JAX package's last guard of ``_check_base`` (a metric built with ``jit=False``) has
no counterpart: the port has no ``jit=`` switch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .. import observability as _observability
from ..metric import (
    DECAY_WEIGHT_KEY,
    WINDOW_COUNT_KEY,
    WINDOW_CURSOR_KEY,
    WINDOW_TIERS,
    HostMetric,
    Metric,
    _dual_fold,
    _stack_fold,
    window_defaults,
    window_stack_geometry,
    window_step,
    window_tier,
)
from ..observability import memory as _obs_memory
from ..parallel import sync as _sync
from ..utilities.exceptions import TorchMetricsUserError
from ..utilities.prints import rank_zero_warn

StateDict = Dict[str, Any]

_RING_RESERVED = (WINDOW_CURSOR_KEY, WINDOW_COUNT_KEY)


def _check_base(base: Metric, transform: str) -> None:
    if not isinstance(base, Metric):
        raise TorchMetricsUserError(f"{transform} wraps a torchmetrics_tpu_torch.Metric, got {type(base).__name__}")
    if isinstance(base, HostMetric):
        raise TorchMetricsUserError(
            f"{transform} needs a pure batch-state core; {type(base).__name__} computes its "
            "batch state on host (text/detection/audio paths)."
        )
    if type(base)._batch_state is Metric._batch_state:
        raise TorchMetricsUserError(
            f"{type(base).__name__} has no pure _batch_state core to window "
            "(compositions/wrappers: wrap the operands instead)."
        )


def _mask_rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a ``(B,)`` slot mask against ``(B, *state_shape)`` buckets."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def _prepared(base: Metric, args: tuple, kwargs: dict) -> tuple:
    args, kwargs = base._on_device(args, kwargs)
    return base._prepare_inputs(*args, **kwargs)


def _stream_local(name: str, what: str) -> TorchMetricsUserError:
    return TorchMetricsUserError(f"{name} is stream-local and cannot cross-process sync; {what}")


class SlidingWindow(Metric):
    """Metric value over the last ``window`` updates of a stream.

    The representation is tiered, chosen from the metric's reduce tags
    (``tier="auto"``):

    - ``"dual"`` (sum/mean/None tags): a constant-size pair of block accumulators; the
      boundary advances in hops of ``window`` updates, so the value is the metric over
      the trailing :meth:`covered_updates` updates, ``window <= covered < 2*window``
      once warm.
    - ``"two_stack"`` (adds max/min/callable semigroup folds): a paned two-stack of
      ``2*depth + 2`` accumulators, a hop of one pane; ``pane=1`` is exact per-update
      sliding.
    - ``"ring"`` (custom ``_merge``, list states, or forced): the per-update bucket
      ring, exact at every step, O(window) state.

    Every tier meets the window-parity oracle: ``compute()`` equals a fresh metric fed
    the trailing :meth:`covered_updates` batches.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.streaming import SlidingWindow
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> metric = SlidingWindow(SumMetric(device="cpu"), window=2)
        >>> for batch in [1.0, 2.0, 3.0, 4.0]:
        ...     metric.update(batch)
        >>> metric.covered_updates()
        2
        >>> float(metric.compute())
        7.0
    """

    def __init__(self, base_metric: Metric, window: int, tier: str = "auto", pane: Optional[int] = None) -> None:
        _check_base(base_metric, "SlidingWindow")
        super().__init__(device=base_metric.device)
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        for name, fx in base_metric._reductions.items():
            if fx == "cat" and name not in base_metric._list_state_names:
                raise TorchMetricsUserError(
                    f"{type(base_metric).__name__}.{name} is a 'cat'-reduced TENSOR state whose "
                    "shape grows per update — it cannot live in a fixed ring; keep cat data in "
                    "list states."
                )
        if tier not in ("auto",) + WINDOW_TIERS:
            raise ValueError(f"Expected `tier` to be 'auto' or one of {WINDOW_TIERS}, got {tier!r}")
        if tier == "auto":
            tier = window_tier(base_metric)
            if pane is not None and tier != "two_stack":
                # an explicit pane is a granularity request: it forces the paned tier
                base_metric._check_windowable("two_stack")
                tier = "two_stack"
        elif tier != "ring":
            base_metric._check_windowable(tier)
        if pane is not None and tier != "two_stack":
            raise ValueError(f"`pane` only applies to the two-stack tier, but tier={tier!r} was forced")
        self.base_metric = base_metric
        self.window = int(window)
        self.tier = tier
        if tier == "two_stack":
            self.pane, self.depth = window_stack_geometry(self.window, pane)
            owned = base_metric.__dict__.get("_wstack_depth")
            if owned is not None and owned != self.depth:
                raise TorchMetricsUserError(
                    "one metric instance can back only one two-stack depth "
                    f"(built {owned}, requested {self.depth}); wrap a clone() for a different pane geometry."
                )
            base_metric.__dict__["_wstack_depth"] = self.depth
        else:
            self.pane, self.depth = None, None
        self._ring: Optional[StateDict] = None  # ring tier only; made at the first update
        self._append_ring: List[Optional[Dict[str, list]]] = []
        self._wstate: Optional[StateDict] = None  # dual and two-stack tiers
        self._wparam: Optional[torch.Tensor] = None  # 0-d window (dual) or pane (two-stack)

    # ------------------------------------------------------------------ ring

    def _ring_defaults(self) -> StateDict:
        """The empty ring: ``window`` buckets of each tensor state, the fill vector and
        the cursor."""
        defaults_t = self.base_metric._tensor_defaults()
        ring: StateDict = {k: v[None].repeat((self.window,) + (1,) * v.dim()) for k, v in defaults_t.items()}
        ring[WINDOW_COUNT_KEY] = torch.zeros((self.window,), dtype=torch.float32, device=self.device)
        ring[WINDOW_CURSOR_KEY] = torch.zeros((), dtype=torch.int32, device=self.device)
        return ring

    def _slot_order(self) -> List[int]:
        """Live slots, oldest update first (the host's mirror of the device cursor)."""
        filled = min(self._update_count, self.window)
        return [(self._update_count - filled + i) % self.window for i in range(filled)]

    # ------------------------------------------------------------- lifecycle

    def _flip_now(self) -> bool:
        """Whether this two-stack update flips the back stack: the pane it completes is
        the ``k * depth + 1``-th, ``k >= 1`` (the step derives the same from its counts
        on the device)."""
        n = self._update_count + 1
        if n % self.pane:
            return False
        panes = n // self.pane
        return panes > self.depth and (panes - 1) % self.depth == 0

    def _wparam_arr(self) -> torch.Tensor:
        if self._wparam is None:
            value = self.window if self.tier == "dual" else self.pane
            self._wparam = torch.tensor(float(value), dtype=torch.float32, device=self.device)
        return self._wparam

    def _wstate_or_defaults(self) -> StateDict:
        if self._wstate is None:
            self._wstate = window_defaults(self.base_metric, self.window, self.tier, self.pane)
        return self._wstate

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Fold this batch into the windowed state: one step under the tier's dispatch
        tag (``wdual``, ``wstack`` or ``wupdate``)."""
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric shouldn't be synced when performing ``update``. "
                "HINT: Did you forget to call ``unsync`` ?"
            )
        base = self.base_metric
        args, kwargs = _prepared(base, args, kwargs)
        if self.tier == "ring":
            if self._ring is None:
                self._ring, self._append_ring = self._ring_defaults(), [None] * self.window
            slot = self._update_count % self.window
            self._ring, appends = base._window_dispatch(
                "wupdate", self._ring, args, kwargs,
                lambda st: window_step(base, "wupdate", st, args, kwargs),
            )
            if base._list_state_names:
                # the bounded host ring of cat contributions: the slot's previous
                # occupant expires with the overwrite, as the device buckets do
                self._append_ring[slot] = {k: [v] for k, v in appends.items()}
        else:
            tag = "wdual" if self.tier == "dual" else "wstack"
            wargs = (self._wparam_arr(),) + tuple(args)
            flip = self._flip_now() if tag == "wstack" else None
            self._wstate = base._window_dispatch(
                tag, self._wstate_or_defaults(), wargs, kwargs,
                lambda st: window_step(base, tag, st, wargs, kwargs, flip_now=flip),
            )
        self._update_count += 1
        self._computed = None
        rec = _observability._ACTIVE
        if rec is not None:
            n = self._update_count
            hop = self.window if self.tier != "two_stack" else self.pane
            rec.record_window_roll(
                base, self.window, min(n, self.window), wrapped=n % self.window == 0,
                tier=self.tier, rotated=self.tier != "ring" and n % hop == 0,
            )

    def covered_updates(self) -> int:
        """How many trailing updates the current value folds: ``min(n, window)`` for the
        ring; the constant-memory tiers advance in hops (``window`` for dual, one pane
        for two-stack), so once warm ``window <= covered < window + hop``."""
        n = self._update_count
        if self.tier == "dual":
            return (self.window if n >= self.window else 0) + n % self.window
        if self.tier == "two_stack":
            full_panes, cc = divmod(n, self.pane)
            return min(full_panes, self.depth) * self.pane + cc
        return min(n, self.window)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Fold the batch in and return the batch's own value (its contribution
        computed alone, no second update)."""
        self.update(*args, **kwargs)
        if self.tier == "ring":
            return self._bucket_value((self._update_count - 1) % self.window)
        base = self.base_metric
        args, kwargs = _prepared(base, args, kwargs)
        batch = base.init_state()
        batch.update(base._batch_state(*args, **kwargs))
        return base._compute(base._concat_state(batch))

    __call__ = forward

    def _bucket_value(self, slot: int) -> Any:
        base = self.base_metric
        batch = base.init_state()
        for k, v in self._ring.items():
            if k not in _RING_RESERVED:
                batch[k] = v[slot]
        if base._list_state_names:
            bucket = self._append_ring[slot] or {}
            for name in base._list_state_names:
                batch[name] = list(bucket.get(name, []))
        return base._compute(base._concat_state(batch))

    # --------------------------------------------------------------- folding

    def window_state(self) -> StateDict:
        """The trailing window folded into one compute-ready state: the state a fresh
        metric fed the last :meth:`covered_updates` batches would hold (list states
        stay lists)."""
        base = self.base_metric
        defaults = base.init_state()
        reductions = dict(base._reductions)
        if self.tier != "ring":
            if self._wstate is None:
                return defaults
            defaults_t = base._tensor_defaults()
            if self.tier == "dual":
                return _dual_fold(reductions, defaults_t, self._wstate)
            return _stack_fold(reductions, defaults_t, self.depth, self._wstate, float(self.pane))
        if self._ring is None:
            return defaults
        order = self._slot_order()
        states = {k: v for k, v in self._ring.items() if k not in _RING_RESERVED}
        out: StateDict = {}
        if base._has_custom_merge():
            # the metric's own merge, in stream order: the per-update fold of a plain metric
            acc = {k: defaults[k] for k in states}
            for slot in order:
                merged = base._merge(dict(acc), {k: v[slot] for k, v in states.items()})
                acc = {k: v.to(states[k].dtype) if k in states else v for k, v in merged.items()}
            out.update(acc)
        else:
            mask = self._ring[WINDOW_COUNT_KEY] > 0
            for k, v in states.items():
                fx = reductions.get(k)
                d = defaults[k]
                m = _mask_rows(mask, v.dim())
                if fx is None:
                    out[k] = d  # None keeps the local default, as update does
                elif callable(fx):
                    acc = d
                    for slot in order:
                        acc = _sync.pairwise_merge(fx, acc, v[slot])
                    out[k] = acc
                elif fx == "sum":
                    out[k] = (d + torch.where(m, v, torch.zeros_like(v)).sum(0)).to(v.dtype)
                elif fx == "mean":
                    n = mask.sum()
                    mean = (v * m.to(v.dtype)).sum(0) / n.clamp(min=1).to(v.dtype)
                    out[k] = torch.where(n > 0, mean, d.to(mean.dtype)).to(v.dtype)
                elif fx == "max":
                    out[k] = torch.maximum(d, torch.where(m, v, d).amax(0))
                elif fx == "min":
                    out[k] = torch.minimum(d, torch.where(m, v, d).amin(0))
                else:  # construction rejects cat tensor states
                    raise TorchMetricsUserError(f"Unsupported reduction {fx!r} in a window fold")
        for name in base._list_state_names:
            rows: list = []
            for slot in order:
                rows.extend((self._append_ring[slot] or {}).get(name, []))
            out[name] = rows
        return out

    def compute(self) -> Any:
        if self._update_count == 0 and not self._update_called_warned:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the "
                "``update`` method which may lead to errors, as metric states have not yet been updated.",
                UserWarning,
            )
            self._update_called_warned = True
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        base = self.base_metric
        value = base._compute(base._concat_state(self.window_state()))
        if self.compute_with_cache:
            self._computed = value
        return value

    def reset(self) -> None:
        self._ring = None
        self._append_ring = []
        self._wstate = None
        self._update_count = 0
        self._computed = None
        self._is_synced = False
        self._cache = None

    # -------------------------------------------------------------- warm start

    def precompile(self, *example_inputs: Any, tags: Optional[Any] = None, cache_dir: Optional[str] = None,
                   force: bool = False, **example_kwargs: Any) -> Dict[str, Any]:
        """Export and compile the base metric's window step (the tier's tag by default)
        for the example batch, with this window's state layout, into the AOT cache."""
        base = self.base_metric
        tier_tag = {"dual": "wdual", "two_stack": "wstack", "ring": "wupdate"}[self.tier]
        tags = (tier_tag,) if tags is None else tuple(tags)
        plane = base._aot_plane(cache_dir)
        args, kwargs = base._aot_examples(example_inputs, example_kwargs)
        if self.tier == "ring":
            state = self._ring if self._ring is not None else self._ring_defaults()
        else:
            state = self._wstate if self._wstate is not None else window_defaults(
                base, self.window, self.tier, self.pane)
            args = (self._wparam_arr(),) + tuple(args)
        report: Dict[str, Any] = {}
        for tag in tags:
            if tag != tier_tag:
                report[tag] = {"status": "skipped", "reason": f"this window runs {tier_tag!r}"}
                continue
            report[tag] = plane.precompile_program(base, tag, base._aot_program(tag), state, args, kwargs,
                                                   force=force)
        return report

    # ------------------------------------------------------------- contracts

    def merge_state(self, incoming_state: Any) -> None:
        """A window is a property of one update stream: merging two ranks' windows has
        no defined update order, so this raises."""
        raise TorchMetricsUserError(
            "SlidingWindow holds a stream-local window of the last updates; merging windows "
            "across ranks has no defined update order. Sync the window FOLD instead: "
            "compute per-rank, or feed window_state() into the sync planes."
        )

    def sync(self, dist_sync_fn: Any = None, process_group: Any = None, should_sync: bool = True,
             distributed_available: Any = None) -> None:
        """The wrapper's own ``_state`` is empty (the window is the real state), so an
        inherited sync would ship nothing and then block ``update``: raise instead (a
        no-op where nothing would sync, as ``Metric.sync``)."""
        if not should_sync or not (distributed_available or self.distributed_available_fn)():
            return
        raise _stream_local(
            "SlidingWindow", "sync the window FOLD instead (feed window_state() into the sync planes, "
            "or compute per-rank)."
        )

    def state_memory(self) -> Dict[str, Any]:
        """The windowed state's footprint from metadata, with no device read: for the
        dual and two-stack tiers independent of the window's length, for the ring
        bounded by it. Before the first update the layout's cost is reported from
        meta tensors (nothing is allocated to be counted)."""
        if self.tier != "ring":
            state = self._wstate
            if state is None:
                state = window_defaults(_MetaView(self.base_metric), self.window, self.tier, self.pane)
            return _obs_memory.state_memory(dict(state))
        return _obs_memory.state_memory(dict(self._ring or {}))

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.base_metric._filter_kwargs(**kwargs)

    def __repr__(self) -> str:
        return f"SlidingWindow({self.base_metric!r}, window={self.window}, tier={self.tier!r})"


class _MetaView:
    """The parts of a metric that ``window_defaults`` reads, with its defaults as meta
    tensors: a layout built from it allocates nothing."""

    def __init__(self, metric: Metric) -> None:
        self._reductions = metric._reductions
        self.device = torch.device("meta")
        self._defaults_t = {k: v.to("meta") for k, v in metric._tensor_defaults().items()}

    def _tensor_defaults(self) -> StateDict:
        return self._defaults_t


class ExponentialDecay(Metric):
    """Metric over the whole stream with exponentially discounted history.

    ``halflife`` is in updates: a batch ``h`` updates old carries half the weight of
    the current one (``decay = 2**(-1/halflife)``; or pass ``decay``). The factor folds
    into the leaves at update time:

    - ``sum`` leaves: ``s_n = d * s_{n-1} + x_n``,
    - ``mean`` leaves: a weighted mean against the decayed count ``w_n = d * w_{n-1} + 1``,
    - ``max``/``min``/``None`` leaves keep their plain merge.

    Integer sum and mean leaves become float32 at construction: discounted counts are
    fractional.

    Example:
        >>> from torchmetrics_tpu_torch.streaming import ExponentialDecay
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> metric = ExponentialDecay(SumMetric(device="cpu"), decay=0.5)
        >>> for batch in [1.0, 1.0, 1.0]:
        ...     metric.update(batch)
        >>> float(metric.compute())
        1.75
    """

    def __init__(self, base_metric: Metric, halflife: Optional[float] = None, decay: Optional[float] = None) -> None:
        _check_base(base_metric, "ExponentialDecay")
        super().__init__(device=base_metric.device)
        if (halflife is None) == (decay is None):
            raise ValueError("Pass exactly one of `halflife` (in updates) or `decay` (per-update factor).")
        if halflife is not None:
            if not halflife > 0:
                raise ValueError(f"Expected `halflife` > 0, got {halflife}")
            decay = float(2.0 ** (-1.0 / float(halflife)))
        if not 0.0 < decay < 1.0:
            raise ValueError(f"Expected `decay` in (0, 1), got {decay}")
        base_metric._check_decayable()
        for name, fx in base_metric._reductions.items():
            if callable(fx) or fx == "cat":
                raise TorchMetricsUserError(
                    f"{type(base_metric).__name__}.{name} uses reduction {fx!r}, which has no "
                    "defined exponential discount; only sum/mean/max/min/None states decay."
                )
        self.base_metric = base_metric
        self.halflife = float(halflife) if halflife is not None else None
        self.decay = float(decay)
        self._dstate: Optional[StateDict] = None
        self._decay_arr: Optional[torch.Tensor] = None  # the 0-d decay the program takes

    def _init_dstate(self) -> None:
        base = self.base_metric
        st: StateDict = {}
        for k, v in base._tensor_defaults().items():
            if base._reductions.get(k) in ("sum", "mean") and not v.is_floating_point():
                v = v.to(torch.float32)  # discounted counts are fractional
            st[k] = v.clone()
        st[DECAY_WEIGHT_KEY] = torch.zeros((), dtype=torch.float32, device=self.device)
        self._dstate = st

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Fold this batch in with the decay applied: one step under ``dupdate``."""
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric shouldn't be synced when performing ``update``. "
                "HINT: Did you forget to call ``unsync`` ?"
            )
        base = self.base_metric
        args, kwargs = _prepared(base, args, kwargs)
        if self._dstate is None:
            self._init_dstate()
        if self._decay_arr is None:
            self._decay_arr = torch.tensor(self.decay, dtype=torch.float32, device=self.device)
        wargs = (self._decay_arr,) + tuple(args)
        self._dstate = base._window_dispatch(
            "dupdate", self._dstate, wargs, kwargs, lambda st: window_step(base, "dupdate", st, wargs, kwargs)
        )
        self._update_count += 1
        self._computed = None

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Fold the batch in and return the decayed value after it."""
        self.update(*args, **kwargs)
        return self.compute()

    __call__ = forward

    def compute(self) -> Any:
        if self._update_count == 0 and not self._update_called_warned:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the "
                "``update`` method which may lead to errors, as metric states have not yet been updated.",
                UserWarning,
            )
            self._update_called_warned = True
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        base = self.base_metric
        if self._dstate is None:
            state = base.init_state()
        else:
            state = {k: v for k, v in self._dstate.items() if k != DECAY_WEIGHT_KEY}
        value = base._compute(state)
        if self.compute_with_cache:
            self._computed = value
        return value

    @property
    def decayed_count(self) -> torch.Tensor:
        """The discounted update count ``sum d^k`` (0.0 before the first update), the
        weight "mean" states fold against."""
        if self._dstate is None:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        return self._dstate[DECAY_WEIGHT_KEY]

    def reset(self) -> None:
        self._dstate = None
        self._update_count = 0
        self._computed = None
        self._is_synced = False
        self._cache = None

    def precompile(self, *example_inputs: Any, tags: Any = ("dupdate",), cache_dir: Optional[str] = None,
                   force: bool = False, **example_kwargs: Any) -> Dict[str, Any]:
        """Export and compile the base metric's ``dupdate`` step for the example batch
        into the AOT cache."""
        base = self.base_metric
        plane = base._aot_plane(cache_dir)
        args, kwargs = base._aot_examples(example_inputs, example_kwargs)
        if self._dstate is None:
            self._init_dstate()
        if self._decay_arr is None:
            self._decay_arr = torch.tensor(self.decay, dtype=torch.float32, device=self.device)
        return {
            tag: plane.precompile_program(base, tag, base._aot_program(tag), self._dstate,
                                          (self._decay_arr,) + tuple(args), kwargs, force=force)
            if tag == "dupdate" else {"status": "skipped", "reason": "this transform runs 'dupdate'"}
            for tag in tags
        }

    def merge_state(self, incoming_state: Any) -> None:
        """Decayed state is a property of one update stream: folding two ranks'
        discounted histories has no defined interleaving order."""
        raise TorchMetricsUserError(
            "ExponentialDecay holds a stream-local discounted history; merging across ranks "
            "has no defined update order. Compute per-rank instead."
        )

    def sync(self, dist_sync_fn: Any = None, process_group: Any = None, should_sync: bool = True,
             distributed_available: Any = None) -> None:
        """See :meth:`SlidingWindow.sync`."""
        if not should_sync or not (distributed_available or self.distributed_available_fn)():
            return
        raise _stream_local("ExponentialDecay", "compute per-rank instead.")

    def state_memory(self) -> Dict[str, Any]:
        return _obs_memory.state_memory(dict(self._dstate or {}))

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.base_metric._filter_kwargs(**kwargs)

    def __repr__(self) -> str:
        if self.halflife is not None:
            return f"ExponentialDecay({self.base_metric!r}, halflife={self.halflife})"
        return f"ExponentialDecay({self.base_metric!r}, decay={self.decay})"
