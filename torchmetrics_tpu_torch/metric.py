"""Core ``Metric`` runtime: the PyTorch counterpart of ``torchmetrics_tpu/metric.py``.

As in the JAX package, a metric is a set of pure functions over a dict of states —

    init_state()            -> State
    _batch_state(*inputs)   -> State  (this batch's contribution; REQUIRED)
    _merge(a, b)            -> State  (fold; default driven by per-state reduce tags)
    _compute(State)         -> value  (REQUIRED)

— with a thin stateful shell on top (``update``/``forward``/``compute``/``reset``/
``state_dict``). PyTorch runs eagerly, so ``update`` is a plain call: no jit and no
buffer donation. States are tensors on the metric's ``device``; concat ("cat") states
are Python lists of tensors, concatenated at compute.

Sync runs over ``torch.distributed`` (``parallel/``): ``compute`` syncs the states
across processes when ``sync_on_compute`` holds and more than one process is attached,
``sync``/``unsync`` swap the synced states in and out, ``merge_state`` folds another
metric's states without communication, and ``reduce_state`` reduces a state dict over a
process group. ``load_state_dict`` runs the structural checkpoint guard
(``reliability/guards.py``) before it adopts anything. Metrics compose with the
arithmetic operators into a ``CompositionalMetric``; ``clone``, ``copy.deepcopy`` and
pickling copy the states by value. ``plot`` draws a value with matplotlib
(``utilities/plot.py``), imported only when a figure is drawn.

The reliability plane (``reliability/``) is opt-in through
``reliability=ReliabilityConfig(...)``: a ``RetryPolicy`` retries transient failures of
``update``, ``forward``, ``compute`` and ``sync``, and the guards validate the states at
``sync``, ``merge_state`` and ``load_state_dict``. PyTorch donates no buffer, but an
attempt may change the states (an in-place ``index_add_``, a fold, a cat append), so
under a policy ``update`` and ``forward`` clone every tensor state before the first
attempt and roll the states, the cat lists' lengths and the update count back before a
retry and when the budget runs out. Without a policy nothing is copied and nothing more
is launched.

The observability plane (``observability/``) records at the same boundaries as in the
JAX package when a telemetry session is active: one ``dispatch`` per tensor-path
``update``/``forward`` with its input signature (the first signature of a key counts in
``jit_compiles``, a repeated one in ``jit_cache_hits``: in eager PyTorch a first-seen
and a repeated signature), a host dispatch per ``HostMetric`` update, ``compute``,
``sync`` with its bytes and collectives, the state memory after each fold, and a
``d2h`` at ``state_dict`` and at each ``compute_on_cpu`` append. With no session each
boundary reads ``observability._ACTIVE`` once and opens only the ``torch.profiler``
range the JAX package opens there.

The AOT warm-start plane (``aot/``) hooks the same tensor-path boundary: with a plane
active, ``_dispatch`` looks a first-seen ``(tag, signature)`` up in the on-disk cache
and, on a hit, runs the loaded program (the metric's fold, exported and compiled by
AOTInductor) in place of the eager fold; a miss is remembered and the eager path serves
it. ``precompile`` writes those programs ahead of traffic and ``prefetch_compiled``
loads them into the in-process memo. With no plane the boundary reads ``aot._ACTIVE``
once. The streaming plane's transforms (``streaming/``) dispatch their steps through the
same boundary (:meth:`Metric._window_dispatch`). Not here yet: the serving plane.
``HostMetric`` is the base of the metrics whose batch contribution is built on the host
(detection's ragged per-image inputs).

Trap: ``==`` between metrics builds a ``CompositionalMetric`` (a truthy object), as in
the JAX package, so ``metric in a_list``, ``a_list.remove(metric)``, ``a_list.index``
and dicts or sets keyed by metrics go wrong without an error. Compare metrics by
identity (``is``, ``id()``).
"""

from __future__ import annotations

import contextlib
import inspect
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import aot as _aot
from . import observability as _observability
from .observability import costs as _obs_costs
from .observability import memory as _obs_memory
from .observability import tracing as _tracing
from .parallel import sync as _sync
from .reliability.guards import validate_restored, validate_state
from .reliability.retry import ReliabilityConfig
from .utilities.checks import resolve_device
from .utilities.data import dim_zero_cat
from .utilities.exceptions import TorchMetricsUserError
from .utilities.prints import rank_zero_warn

StateDict = Dict[str, Any]

_ALLOWED_REDUCE = ("sum", "mean", "cat", "min", "max", None)


def _to_device(value: Any, device: torch.device) -> Any:
    """Tensors and numpy arrays go to ``device``; anything else passes through."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, device=device)
    return value


# ---------------------------------------------------------------------------
# Tiered window representation (streaming.SlidingWindow)
#
# As in the JAX package: the per-update bucket ring is exact at per-update granularity
# at O(window) memory; the dual pair and the paned two-stack collapse the window to a
# constant number of accumulators, and the window boundary then advances in hops
# (block or pane), so the value is exactly the metric over the trailing ``covered``
# updates, ``window <= covered < window + hop``. Which form a metric gets follows from
# its reduce tags (``window_tier``). Every step is branch-free: rotation, eviction,
# push and flip are ``where``s over 0-d tensors, so the exported program and the eager
# step are one fold.
# ---------------------------------------------------------------------------

#: reserved leaves of a SlidingWindow ring: the roll cursor (slot = cursor mod window,
#: on the device) and the per-slot fill vector; in the dual and two-stack layouts
#: ``WINDOW_COUNT_KEY`` carries the block or pane counts
WINDOW_CURSOR_KEY = "__window_cursor"
WINDOW_COUNT_KEY = "__window_n"

#: reserved leaf of an ExponentialDecay state: the decayed update weight that "mean"
#: states fold against
DECAY_WEIGHT_KEY = "__decay_n"

#: reserved leaf-name prefixes of the two-stack layout: each state ``k`` gets the front
#: suffix-fold stack, the back pane-fold stack and the running fold of the back stack
WINDOW_FRONT_KEY = "__window_front:"
WINDOW_BACK_KEY = "__window_back:"
WINDOW_BAGG_KEY = "__window_bagg:"

#: window tiers, in preference order
WINDOW_TIERS = ("dual", "two_stack", "ring")

#: fixed two-stack depth: panes per window, whatever the window's length
WINDOW_STACK_DEPTH = 16


def window_tier(metric: "Metric") -> str:
    """The window representation this metric's reduce tags admit: ``"dual"`` (every
    tensor reduction ``sum``/``mean``/``None``), ``"two_stack"`` (adds ``max``/``min``
    and callable semigroup folds) or ``"ring"`` (a custom ``_merge`` or list states)."""
    if metric._has_custom_merge() or metric._list_state_names:
        return "ring"
    tags = set()
    for fx in metric._reductions.values():
        if fx == "cat":
            return "ring"  # a cat tensor state (the wrapper rejects it anyway)
        tags.add("callable" if callable(fx) else fx)
    if tags <= {"sum", "mean", None}:
        return "dual"
    if tags <= {"sum", "mean", "max", "min", None, "callable"}:
        return "two_stack"
    return "ring"


def window_stack_geometry(window: int, pane: Optional[int] = None) -> Tuple[int, int]:
    """``(pane_size, depth)`` of a two-stack window, ``depth * pane_size >= window``;
    ``pane=1`` is exact per-update sliding, the default keeps depth at
    :data:`WINDOW_STACK_DEPTH`."""
    if pane is None:
        pane = max(1, -(-int(window) // WINDOW_STACK_DEPTH))  # ceil division
    pane = int(pane)
    if pane < 1:
        raise ValueError(f"Expected `pane` >= 1, got {pane}")
    depth = max(1, -(-int(window) // pane))
    return pane, depth


def _window_init_leaf(default: torch.Tensor, fx: Any) -> torch.Tensor:
    """The merge-identity start value of one window accumulator: sum and mean leaves
    start at zero (the default is folded back in once, at fold time), the others at
    the metric's default. Integer sum and mean leaves accumulate in int64, exact past
    2**24 (the JAX package promotes them to float32 without x64)."""
    if fx in ("sum", "mean"):
        dtype = torch.int64 if not (default.is_floating_point() or default.is_complex()) else default.dtype
        return torch.zeros(default.shape, dtype=dtype, device=default.device)
    return default.clone()


def window_defaults(metric: "Metric", window: int, tier: str, pane: Optional[int] = None) -> StateDict:
    """The empty windowed state of one stream: the single definition of each tier's
    layout. Dual: one packed ``(2, *shape)`` leaf a state (row 0 the expiring block,
    row 1 the current one) and ``[prev_n, cur_n]``. Two-stack: the current pane, the
    back aggregate, the ``(depth, *shape)`` front and back stacks and ``[front, back,
    current pane]``."""
    defaults_t = metric._tensor_defaults()
    reductions = metric._reductions
    device = metric.device
    st: StateDict = {}
    if tier == "dual":
        for k, v in defaults_t.items():
            init = _window_init_leaf(v, reductions.get(k))
            st[k] = torch.stack([init, init.clone()])
        st[WINDOW_COUNT_KEY] = torch.zeros((2,), dtype=torch.float32, device=device)
    elif tier == "two_stack":
        _, depth = window_stack_geometry(window, pane)
        for k, v in defaults_t.items():
            init = _window_init_leaf(v, reductions.get(k))
            st[k] = init
            st[WINDOW_BAGG_KEY + k] = init.clone()
            st[WINDOW_FRONT_KEY + k] = init[None].repeat((depth,) + (1,) * init.dim())
            st[WINDOW_BACK_KEY + k] = init[None].repeat((depth,) + (1,) * init.dim())
        st[WINDOW_COUNT_KEY] = torch.zeros((3,), dtype=torch.float32, device=device)
    else:
        raise ValueError(f"window_defaults builds 'dual'/'two_stack' layouts, not {tier!r}")
    return st


def _weighted_mean(a: torch.Tensor, b: torch.Tensor, w_a: Any, w_b: Any) -> torch.Tensor:
    """:func:`~.parallel.sync.weighted_mean` without a branch on a tensor (the weights'
    total is one): a total weight of 0 keeps ``a``."""
    total = w_a + w_b
    zero = total == 0
    merged = (w_a * a + w_b * b) / torch.where(zero, torch.ones_like(total), total)
    return torch.where(zero, a.to(merged.dtype), merged)


def _fold_tag(fx: Any, a: torch.Tensor, b: torch.Tensor, w_a: Any, w_b: Any) -> torch.Tensor:
    """Merge two window accumulators of one state in stream order (``a`` older) under
    its reduce tag; ``w_*`` are the update counts each side covers (``"mean"`` only)."""
    if fx == "mean":
        return _weighted_mean(a, b, w_a, w_b)
    if fx == "sum":
        return a + torch.as_tensor(b).to(a.dtype)
    if fx is None:
        return a
    return _sync.pairwise_merge(fx, a, b)


def _dual_step(reductions: Dict[str, Any], defaults_t: StateDict, st: StateDict, window: Any,
               bs_t: StateDict) -> StateDict:
    """One dual-pair window update: fold the batch into the current block; when the
    block reaches ``window`` updates, it becomes the expiring block and a fresh one
    starts. ``window`` is a 0-d tensor, so one program serves every length."""
    counts = st[WINDOW_COUNT_KEY]
    cur_n = counts[1]
    new_n = cur_n + 1.0
    rotate = new_n >= window
    out: StateDict = {}
    for k in defaults_t:
        pair = st[k]
        fx = reductions.get(k)
        b = bs_t.get(k)
        new_cur = pair[1] if b is None or fx is None else _fold_tag(fx, pair[1], b, cur_n, 1.0).to(pair.dtype)
        init = _window_init_leaf(defaults_t[k], fx).to(pair.dtype)
        out[k] = torch.where(rotate, torch.stack([new_cur, init]), torch.stack([pair[0], new_cur]))
    out[WINDOW_COUNT_KEY] = torch.where(
        rotate, torch.stack([new_n, torch.zeros_like(new_n)]), torch.stack([counts[0], new_n])
    )
    return out


def _dual_fold(reductions: Dict[str, Any], defaults_t: StateDict, st: StateDict) -> StateDict:
    """A dual pair collapsed into one compute-ready state: the metric over the trailing
    ``prev_n + cur_n`` updates."""
    counts = st[WINDOW_COUNT_KEY]
    prev_n, cur_n = counts[0], counts[1]
    total = prev_n + cur_n
    out: StateDict = {}
    for k, d in defaults_t.items():
        fx = reductions.get(k)
        pair = st[k]
        if fx == "sum":
            out[k] = d.to(pair.dtype) + pair.sum(0)
        elif fx == "mean":
            merged = _weighted_mean(pair[0], pair[1], prev_n, cur_n)
            out[k] = torch.where(total > 0, merged, d.to(merged.dtype)).to(pair.dtype)
        else:  # None: the local default, as update keeps it
            out[k] = d
    return out


def _stack_flip(fx: Any, back: torch.Tensor, init: torch.Tensor, pane: Any, depth: int) -> torch.Tensor:
    """The suffix folds of a full back stack, oldest first: ``depth`` merges."""
    suffix = init
    rows: List[torch.Tensor] = []
    for i in reversed(range(depth)):
        suffix = _fold_tag(fx, back[i], suffix, pane, (depth - 1 - i) * pane).to(init.dtype)
        rows.append(suffix)
    return torch.stack(rows[::-1])


def _stack_step(reductions: Dict[str, Any], defaults_t: StateDict, depth: int, st: StateDict, pane: Any,
                bs_t: StateDict, flip_now: Optional[bool] = None) -> StateDict:
    """One two-stack (DABA-style) window update: the batch folds into the current pane;
    a completed pane is pushed onto the back stack and folded into the back aggregate;
    once the window is full each push evicts the oldest front pane; when the front
    drains, the flip recomputes the suffix folds of the (then full) back stack.

    Branch-free, as the exported program runs it: the flip's ``depth`` merges are
    evaluated and selected by ``where``, and the push is a one-hot ``where`` over the
    ``depth`` rows (there is no dropped out-of-range write in torch). ``flip_now`` is
    the caller's host-side knowledge of the flip (it follows from the update count,
    the pane and the depth): with it the eager step evaluates the flip's merges only on
    the update that flips, with the same result."""
    counts = st[WINDOW_COUNT_KEY]
    fc, bc, cc = counts[0], counts[1], counts[2]
    cc_next = cc + 1.0
    complete = cc_next >= pane
    d_f = float(depth)
    full = (fc + bc) >= d_f
    flip = complete & full & (fc <= 0.0)
    evict = complete & full
    fc_after = torch.where(flip, d_f - 1.0, torch.where(evict, fc - 1.0, fc))
    bc_base = torch.where(flip, torch.zeros_like(bc), bc)  # panes in the back stack before the push
    bc_after = torch.where(complete, bc_base + 1.0, bc)
    cc_after = torch.where(complete, torch.zeros_like(cc_next), cc_next)
    push = complete & (torch.arange(depth, device=counts.device, dtype=counts.dtype) == bc_base)  # (depth,)
    out: StateDict = {}
    for k in defaults_t:
        fx = reductions.get(k)
        b = bs_t.get(k)
        cur = st[k]
        pane_fold = cur if b is None or fx is None else _fold_tag(fx, cur, b, cc, 1.0).to(cur.dtype)
        init = _window_init_leaf(defaults_t[k], fx).to(cur.dtype)
        front, back, agg = st[WINDOW_FRONT_KEY + k], st[WINDOW_BACK_KEY + k], st[WINDOW_BAGG_KEY + k]
        if flip_now is None:
            out[WINDOW_FRONT_KEY + k] = torch.where(flip, _stack_flip(fx, back, init, pane, depth), front)
        else:
            out[WINDOW_FRONT_KEY + k] = _stack_flip(fx, back, init, pane, depth) if flip_now else front
        rows = push.reshape((depth,) + (1,) * cur.dim())
        out[WINDOW_BACK_KEY + k] = torch.where(rows, pane_fold.to(back.dtype)[None], back)
        agg_base = torch.where(flip, init, agg)
        pushed = _fold_tag(fx, agg_base, pane_fold, bc_base * pane, cc_next).to(cur.dtype)
        out[WINDOW_BAGG_KEY + k] = torch.where(complete, pushed, agg)
        out[k] = torch.where(complete, init, pane_fold)
    out[WINDOW_COUNT_KEY] = torch.stack([fc_after, bc_after, cc_after])
    return out


def _stack_fold(reductions: Dict[str, Any], defaults_t: StateDict, depth: int, st: StateDict,
                pane: Any) -> StateDict:
    """A two-stack window collapsed into one compute-ready state: front suffix fold
    (oldest panes) then back aggregate then the current partial pane, in stream
    order."""
    counts = st[WINDOW_COUNT_KEY]
    fc, bc, cc = counts[0], counts[1], counts[2]
    front_n, back_n = fc * pane, bc * pane
    total = front_n + back_n + cc
    front_pos = (depth - fc).clamp(0, depth - 1).to(torch.int64).reshape(1)
    out: StateDict = {}
    for k, d in defaults_t.items():
        fx = reductions.get(k)
        init = _window_init_leaf(d, fx)
        top = st[WINDOW_FRONT_KEY + k].index_select(0, front_pos)[0]
        acc = torch.where(fc > 0, top, init.to(top.dtype))
        acc = _fold_tag(fx, acc, st[WINDOW_BAGG_KEY + k], front_n, back_n)
        acc = _fold_tag(fx, acc, st[k], front_n + back_n, cc).to(st[k].dtype)
        if fx == "sum":
            out[k] = d.to(acc.dtype) + acc
        elif fx == "mean":
            out[k] = torch.where(total > 0, acc, d.to(acc.dtype))
        elif fx is None:
            out[k] = d
        else:  # max/min/callable: the default is the merge identity
            out[k] = acc
    return out


class Metric:
    """Base class for all metrics (stateful shell over a pure core).

    Subclass contract::

        class MyMetric(Metric):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

            def _batch_state(self, preds, target) -> dict:   # pure
                return {"total": (preds == target).sum()}

            def _compute(self, state):                       # pure
                return state["total"]

    Keyword arguments: ``device`` (default ``None``, which means ``"cuda"``; without
    CUDA pass ``device="cpu"`` explicitly), ``compute_with_cache``, ``compute_on_cpu``
    (list-state appends go to the host, where they do not hold the card's memory), and the sync
    keywords of the JAX package: ``dist_sync_on_step`` (``forward`` returns the value
    synced across processes), ``process_group`` (a ``torch.distributed`` group; the
    default group if None), ``dist_sync_fn`` (``fn(value, group) -> list of values``,
    in place of the real all-gather), ``distributed_available_fn`` (whether to sync;
    default: more than one process in the default group) and ``sync_on_compute``
    (default True), and ``reliability`` (a
    :class:`~torchmetrics_tpu_torch.reliability.ReliabilityConfig`, default ``None``)
    to opt into transient-failure retry at the update, forward, compute and sync
    boundaries and state-integrity guards at sync, merge and restore.

    Where the synced states live follows the group's backend: NCCL keeps them on the
    card; gloo stages each payload through the CPU and the synced states come back to
    the metric's device.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False
    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None
    # False where the JAX package's compute runs on the host (host algorithms, float64
    # edge cases): BootStrapper keeps its replicas stacked only where this holds, as there
    _jittable_compute: bool = True

    def __init__(self, **kwargs: Any) -> None:
        self._device = resolve_device(kwargs.pop("device", None))
        self._dtype = None
        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError(f"Expected keyword argument `dist_sync_on_step` to be a `bool` but got {self.dist_sync_on_step}")
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError(f"Expected keyword argument `dist_sync_fn` to be an callable function but got {self.dist_sync_fn}")
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or _sync.distributed_available
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError(f"Expected keyword argument `sync_on_compute` to be a `bool` but got {self.sync_on_compute}")
        self._reliability = kwargs.pop("reliability", None)
        if self._reliability is not None and not isinstance(self._reliability, ReliabilityConfig):
            raise ValueError(
                f"Expected keyword argument `reliability` to be a `ReliabilityConfig` but got {self._reliability}"
            )
        self._fault_hook = None  # fault-injection seam (reliability/faults.py)
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Any] = {}
        self._persistent: Dict[str, bool] = {}
        self._state: StateDict = {}
        self._update_count = 0
        self._computed: Any = None
        self._is_synced = False
        self._cache: Optional[StateDict] = None
        self._update_called_warned = False

    # ------------------------------------------------------------------ states

    def add_state(
        self,
        name: str,
        default: Any,
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a metric state: a tensor (numpy arrays and scalars are converted)
        or an empty list (concat state)."""
        if isinstance(default, list) and default != []:
            raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        if dist_reduce_fx not in _ALLOWED_REDUCE and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        if isinstance(default, list) and dist_reduce_fx is None:
            dist_reduce_fx = "cat"
        if name in ("_defaults", "_reductions", "_persistent", "_state"):
            raise ValueError(f"The name `{name}` is reserved.")
        if not isinstance(default, list):
            default = torch.as_tensor(default, device=self._device)
        self._defaults[name] = default
        self._reductions[name] = dist_reduce_fx
        self._persistent[name] = persistent
        self._state[name] = [] if isinstance(default, list) else default.clone()
        self._drop_aot_memo()  # the state layout changed: loaded programs are stale

    @property
    def _list_state_names(self) -> Tuple[str, ...]:
        return tuple(n for n, d in self._defaults.items() if isinstance(d, list))

    def __getattr__(self, name: str):
        state = self.__dict__.get("_state")
        if state is not None and name in state:
            return state[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        state = self.__dict__.get("_state")
        if state is not None and name in state:
            state[name] = value
            return
        object.__setattr__(self, name, value)

    @property
    def device(self) -> torch.device:
        return self._device

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move defaults and states to ``device`` (in place); returns ``self``."""
        self._device = resolve_device(device)

        def move(v):
            return [t.to(self._device) for t in v] if isinstance(v, list) else v.to(self._device)

        self._defaults = {k: move(v) for k, v in self._defaults.items()}
        self._state = {k: move(v) for k, v in self._state.items()}
        self._computed = None
        self._drop_aot_memo()  # loaded programs are bound to the old device
        return self

    # ------------------------------------------------------------- pure core

    def init_state(self) -> StateDict:
        """Fresh default state (pure)."""
        return {n: ([] if isinstance(d, list) else d.clone()) for n, d in self._defaults.items()}

    def _batch_state(self, *args: Any, **kwargs: Any) -> StateDict:
        """This batch's state contribution (pure). REQUIRED override."""
        raise NotImplementedError

    def _merge(self, a: StateDict, b: StateDict) -> StateDict:
        """Fold ``b`` into ``a``; the default uses per-state reduce tags (pure)."""
        return _sync.merge_states(a, b, self._reductions)

    def _compute(self, state: StateDict) -> Any:
        """Final value from a state whose concat states are single tensors. REQUIRED."""
        raise NotImplementedError

    def _prepare_inputs(self, *args: Any, **kwargs: Any) -> Tuple[tuple, dict]:
        """Validation/formatting hook run before ``_batch_state``. Default: identity."""
        return args, kwargs

    def _has_custom_merge(self) -> bool:
        return type(self)._merge is not Metric._merge

    def _on_device(self, args: Sequence[Any], kwargs: Dict[str, Any]) -> Tuple[tuple, dict]:
        moved_args = tuple(_to_device(a, self._device) for a in args)
        return moved_args, {k: _to_device(v, self._device) for k, v in kwargs.items()}

    def update_state(self, state: StateDict, *args: Any, **kwargs: Any) -> StateDict:
        """Pure update (tensor-state metrics only)."""
        if self._list_state_names:
            raise TorchMetricsUserError(
                f"{type(self).__name__} holds dynamic-length concat states and cannot run as a pure update; "
                "use the stateful API."
            )
        if not self._has_custom_merge() and any(fx == "mean" for fx in self._reductions.values()):
            # a bare mean state cannot fold statelessly: without an update count the
            # repeated (a+b)/2 fold diverges from the stateful API's exact running mean
            raise TorchMetricsUserError(
                f"{type(self).__name__} has a 'mean'-reduced state, which cannot fold in a pure update "
                "without an update count. Keep sum+weight states instead or override `_merge`."
            )
        args, kwargs = self._on_device(args, kwargs)
        return self._merge(state, self._batch_state(*args, **kwargs))

    def compute_state(self, state: StateDict) -> Any:
        """Pure compute."""
        return self._compute(state)

    def reduce_state(self, state: StateDict, group: Any = None) -> StateDict:
        """Reduce ``state`` across the processes of ``group`` (the default group if None),
        coalesced: one collective per (reduction class × dtype) bucket, not one per leaf."""
        return _sync.reduce_states(state, self._reductions, group)

    # ------------------------------------------------------------- lifecycle

    def _fold(self, batch: StateDict) -> None:
        """Merge one batch state into the live state; tensor states keep their dtype."""
        lists = set(self._list_state_names)
        tensors = {k: v for k, v in batch.items() if k not in lists}
        if self._has_custom_merge():
            merged = self._merge({k: v for k, v in self._state.items() if k not in lists}, tensors)
        else:
            weights = (float(self._update_count), 1.0)
            merged = {k: _sync.pairwise_merge(self._reductions[k], self._state[k], v, weights) for k, v in tensors.items()}
        for k, v in merged.items():
            self._state[k] = v.to(self._state[k].dtype) if k in self._state else v
        for k in lists & batch.keys():
            self._append_list_state(k, batch[k])
        self._update_count += 1
        self._computed = None

    def _append_list_state(self, name: str, value: Any) -> None:
        """Append one batch to a concat state; under ``compute_on_cpu`` on the host. The
        offload is a deliberate device-to-host copy: a telemetry session counts it (after
        the dispatch's own record, as the JAX package orders them)."""
        if not (self.compute_on_cpu and isinstance(value, torch.Tensor)):
            self._state[name].append(value)
            return
        rec = _observability._ACTIVE
        if rec is not None:
            nbytes = value.numel() * value.element_size()
            pending = self.__dict__.get("_d2h_pending")
            if pending is None:
                rec.record_d2h("compute_on_cpu_append", nbytes, metric=self)
            else:
                pending.append(nbytes)
        self._state[name].append(value.cpu())

    # --------------------------------------------------------- reliability seam

    def _attempt(self, tag: str, thunk: Callable[[], Any]) -> Any:
        """One attempt; the fault-injection hook fires where a dispatch failure would
        surface, before the attempt touches the states."""
        hook = self._fault_hook
        if hook is not None:
            hook(tag)
        return thunk()

    def _retrying(self, tag: str, thunk: Callable[[], Any], restore: Optional[Callable] = None) -> Any:
        """Retries transient failures when a ``RetryPolicy`` is configured; otherwise one
        attempt. ``restore(exc, attempt)`` runs before a retry."""
        rel = self._reliability
        if rel is None or rel.retry is None:
            return self._attempt(tag, thunk)
        return rel.retry.call(
            lambda: self._attempt(tag, thunk), on_retry=restore, describe=f"{type(self).__name__}.{tag}"
        )

    def _reliable_call(self, tag: str, thunk: Callable[[], Any], restore: Optional[Callable] = None) -> Any:
        """A boundary under :meth:`_retrying`. Telemetry: ``HostMetric`` routes its
        ``update``/``forward`` contribution through here (the tensor path records in
        :meth:`_dispatch`), so those tags record as host dispatches in a session."""
        rec = _observability._ACTIVE
        if rec is None or tag not in ("update", "forward"):
            return self._retrying(tag, thunk, restore)
        t0 = _tracing.monotonic()
        with _tracing.trace_span(f"{type(self).__name__}.{tag}"):
            out = self._retrying(tag, thunk, restore)
        rec.record_host_dispatch(self, tag, rec.finish(out, t0, self._device))
        return out

    def _fold_batch(self, args: tuple, kwargs: dict) -> StateDict:
        """The eager fold: this batch's state, merged into the live states."""
        batch = self._batch_state(*args, **kwargs)
        self._fold(batch)
        return batch

    def _fold_reliably(self, tag: str, args: tuple, kwargs: dict, fold: Optional[Callable] = None) -> Any:
        """``update``'s and ``forward``'s boundary: this batch's state, folded into the
        live states; returns the batch state (or what ``fold``, the AOT plane's loaded
        program in place of the eager fold, returns). Without a retry policy it runs once
        and nothing is copied. With one, every tensor state is cloned before the first
        attempt; before a retry the states take a fresh copy of the backup, the cat lists
        their old lengths and the update count its old value, and when the budget runs out
        the backup itself goes back into the states before the error re-raises, so the
        metric stays usable at its last good state."""
        fold_batch = fold if fold is not None else (lambda: self._fold_batch(args, kwargs))
        rel = self._reliability
        if rel is None or rel.retry is None:
            return self._attempt(tag, fold_batch)
        backup = {k: v.clone() for k, v in self._state.items() if isinstance(v, torch.Tensor)}
        lengths = {k: len(v) for k, v in self._state.items() if isinstance(v, list)}
        count, computed = self._update_count, self._computed

        def roll_back(copy: bool) -> None:
            for k, v in backup.items():
                self._state[k] = v.clone() if copy else v
            for k, n in lengths.items():
                del self._state[k][n:]
            self._update_count, self._computed = count, computed

        try:
            return self._retrying(tag, fold_batch, restore=lambda exc, attempt: roll_back(copy=True))
        except Exception:
            roll_back(copy=False)
            raise

    def _dispatch(self, tag: str, args: tuple, kwargs: dict, run: Callable[[Optional[Callable]], Any],
                  tensors: Optional[StateDict] = None, eager: Optional[Callable] = None) -> Any:
        """The tensor path's ``update``/``forward`` boundary: ``run(fold)`` inside the
        metric's profiler range, where ``fold`` is None (the eager fold) or the AOT
        plane's loaded program for this signature. In a telemetry session the dispatch is
        recorded with its input signature and duration, a fresh signature's cost is
        harvested around this one call (``observability/costs.py``; a loaded program's
        from its entry), and the state memory is refreshed.

        With the AOT plane active (``aot.enable``), a first-seen signature consults the
        on-disk cache first: a hit runs the loaded program, a miss is remembered so the
        eager path owns that signature for the rest of the process, and a corrupt entry
        is just a miss. Counters keep ``jit_compiles + jit_cache_hits + aot_cache_hits
        == dispatches`` exact. With no plane this reads ``aot._ACTIVE`` once.

        A stream transform's update passes the state its program folds as ``tensors``
        (its window or decayed state, in place of the metric's own) and its eager step
        as ``eager``; ``fold`` is then a function of that state."""
        label = f"{type(self).__name__}.{tag}"
        plane = _aot._ACTIVE
        slot = fold = None
        states = self._tensor_states() if tensors is None else tensors
        if plane is not None:
            slot = plane.lookup_dispatch(self, tag, states, (args, kwargs))
            if slot is not None and slot.compiled is not None:
                fold = (self._loaded_fold(tag, slot, args, kwargs) if tensors is None
                        else self._loaded_step(slot, args, kwargs, eager))
        rec = _observability._ACTIVE
        if rec is None:
            with _tracing.trace_span(label):
                out = run(fold)
            if slot is not None and slot.store_pending:
                plane.store_from_dispatch(self, tag, states, (args, kwargs), slot)
            return out
        inputs = (args, kwargs)
        sig = slot.signature if slot is not None else rec._signature(inputs)
        harvest = None
        if rec.config.cost_accounting and rec._fresh_signature(self, tag, sig):
            # the live dict: the harvest reads the output bytes from it after the call
            harvest = _obs_costs.DispatchHarvest(self._state if tensors is None else tensors, inputs)
        # a loaded program is opaque to FlopCounterMode: its harvest takes the bytes and
        # the entry's flops, and is not entered around the call
        counting = harvest if harvest is not None and fold is None else contextlib.nullcontext()
        object.__setattr__(self, "_d2h_pending", [])
        try:
            t0 = _tracing.monotonic()
            with _tracing.trace_span(label), counting:
                out = run(fold)
            duration = rec.finish(out, t0, self._device)
            # decided AFTER the dispatch: a demotion means the eager path served it
            aot_hit = slot is not None and slot.compiled is not None
            if aot_hit and harvest is not None and fold is not None:
                harvest.extra_flops += slot.flops
            if aot_hit and slot.event_pending:
                slot.event_pending = False  # one aot_load event per cache load
                rec.record_aot_load(self, tag, slot.load_s, slot.nbytes, slot.key, slot.codec)
            if slot is not None and slot.compiled is None and slot.miss_pending:
                slot.miss_pending = False
                rec.record_aot_miss()
            rec.record_dispatch(self, tag, inputs, duration, lower=harvest, aot_loaded=aot_hit, signature=sig)
        finally:
            pending = self.__dict__.pop("_d2h_pending")
        for nbytes in pending:  # compute_on_cpu appends, after the dispatch's own record
            rec.record_d2h("compute_on_cpu_append", nbytes, metric=self)
        rec.record_state_memory(self)
        if slot is not None and slot.store_pending:
            plane.store_from_dispatch(self, tag, states, inputs, slot)
        return out

    def _tensor_states(self) -> StateDict:
        lists = set(self._list_state_names)
        return {k: v for k, v in self._state.items() if k not in lists}

    def _tensor_defaults(self) -> StateDict:
        return {k: v for k, v in self._defaults.items() if not isinstance(v, list)}

    # ------------------------------------------------------ windowed programs

    def _check_windowable(self, tier: str) -> None:
        """Construction-time guards of the constant-memory window tiers, the mirror of
        what :func:`window_tier` derives."""
        if self._list_state_names:
            raise TorchMetricsUserError(
                f"{type(self).__name__} holds dynamic-length concat states; only the "
                "'ring' window tier can hold them (bounded host ring)."
            )
        if self._has_custom_merge():
            raise TorchMetricsUserError(
                f"{type(self).__name__} overrides _merge; an unknown merge cannot be "
                "folded into constant-size window accumulators — use the 'ring' tier."
            )
        allowed = {"sum", "mean", None} if tier == "dual" else {"sum", "mean", "max", "min", None}
        for name, fx in self._reductions.items():
            if callable(fx):
                if tier == "dual":
                    raise TorchMetricsUserError(
                        f"{type(self).__name__}.{name} uses a callable reduction; the dual "
                        "pair folds only sum/mean closed forms — use tier 'two_stack'."
                    )
                continue
            if fx not in allowed:
                raise TorchMetricsUserError(
                    f"{type(self).__name__}.{name} uses reduction {fx!r}, which the "
                    f"{tier!r} window tier cannot fold; use the 'ring' tier."
                )

    def _check_decayable(self) -> None:
        """The guards of the ``dupdate`` program: an unknown fold cannot be discounted."""
        if self._list_state_names:
            raise TorchMetricsUserError(
                f"{type(self).__name__} holds dynamic-length concat states; exponential "
                "decay over an unbounded concatenation is undefined."
            )
        if self._has_custom_merge():
            raise TorchMetricsUserError(
                f"{type(self).__name__} overrides _merge; a decay factor cannot be "
                "folded into an unknown merge safely."
            )

    def _window_dispatch(self, tag: str, wstate: StateDict, wargs: tuple, kwargs: dict,
                         eager: Callable[[StateDict], Any]) -> Any:
        """One update of a stream transform's state ``wstate`` (a SlidingWindow's or an
        ExponentialDecay's) under ``tag`` (``wdual``/``wstack``/``wupdate``/``dupdate``)
        through :meth:`_dispatch`, so the AOT plane, telemetry and the retry plane apply
        as to ``update``: ``wargs`` is the program's positional inputs (the window, pane
        or decay first, as a 0-d tensor, then the batch) and ``eager(state)`` the
        eager step, which returns the new state without touching ``state``. Under a
        retry policy every tensor of ``wstate`` is cloned before the first attempt and
        a retry starts again from a fresh copy of that backup."""

        def run(fold: Optional[Callable]) -> Any:
            step = fold if fold is not None else eager
            current = [wstate]
            rel = self._reliability
            if rel is None or rel.retry is None:
                return self._attempt(tag, lambda: step(current[0]))
            backup = {k: v.clone() for k, v in wstate.items()}

            def restore(exc: BaseException, attempt: int) -> None:
                current[0] = {k: v.clone() for k, v in backup.items()}

            return self._retrying(tag, lambda: step(current[0]), restore)

        return self._dispatch(tag, wargs, kwargs, run, tensors=wstate, eager=eager)

    def _aot_counter(self) -> torch.Tensor:
        """The update count as the program's 0-d float32 ``n``: the tensor the last
        loaded update returned while the count still matches, else a new one."""
        cached = self.__dict__.get("_aot_n")
        if cached is not None and cached[0] == self._update_count:
            return cached[1]
        return torch.tensor(float(self._update_count), dtype=torch.float32, device=self._device)

    def _loaded_fold(self, tag: str, slot: Any, args: tuple, kwargs: dict) -> Callable[[], Tuple[StateDict, Any]]:
        """The fold that runs ``slot``'s loaded program: it adopts the program's states,
        appends and count as :meth:`_fold` would, and returns ``(batch state, batch
        value)`` (the value None where the eager path computes it). A call the program
        refuses before it runs (calling convention, device, dtype) demotes the slot to a
        remembered miss and folds eagerly; any other error propagates."""
        program_args = _aot.program_inputs((args, kwargs), self._device)

        def fold() -> Tuple[StateDict, Any]:
            if slot.compiled is not None:  # None: demoted on an earlier attempt
                try:
                    out = slot.compiled(self._tensor_states(), self._aot_counter(), *program_args)
                except (TypeError, ValueError):
                    slot.demote()
                else:
                    self._state.update(out[0])
                    for k, v in out[1].items():
                        self._append_list_state(k, v)
                    self._update_count += 1
                    self._computed = None
                    if tag == "update":
                        self.__dict__["_aot_n"] = (self._update_count, out[2])
                        return out[1], None
                    return dict(out[3]), out[2]
            return self._fold_batch(args, kwargs), None

        return fold

    def _loaded_step(self, slot: Any, args: tuple, kwargs: dict, eager: Callable[[StateDict], Any]) -> Callable:
        """A stream transform's step that runs ``slot``'s loaded program on the state it
        is given; a call the program refuses demotes the slot and runs ``eager``."""
        program_args = _aot.program_inputs((args, kwargs), self._device)

        def step(state: StateDict) -> Any:
            if slot.compiled is not None:
                try:
                    return slot.compiled(state, self._aot_counter(), *program_args)
                except (TypeError, ValueError):
                    slot.demote()
            return eager(state)

        return step

    def _drop_aot_memo(self) -> None:
        """Forget the loaded programs and the cached counter (a new device, dtype or
        state layout, or a copy: loaded programs are process-local)."""
        self.__dict__.pop("_aot_memo", None)
        self.__dict__.pop("_aot_n", None)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate this batch into the global state."""
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric shouldn't be synced when performing ``update``. "
                "HINT: Did you forget to call ``unsync`` ?"
            )
        args, kwargs = self._on_device(args, kwargs)
        args, kwargs = self._prepare_inputs(*args, **kwargs)
        self._dispatch("update", args, kwargs, lambda fold: self._fold_reliably("update", args, kwargs, fold))

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Batch value AND global accumulation in one pass: the batch state is computed
        once, its value returned, and the same tensors merged into the global state. Under
        ``dist_sync_on_step`` the value is the global state's, synced across processes."""
        if self._is_synced:
            raise TorchMetricsUserError("The Metric shouldn't be synced when performing ``forward``.")
        if self.dist_sync_on_step:
            self.update(*args, **kwargs)
            self._computed = None
            value = self.compute()
            self._computed = None
            return value
        args, kwargs = self._on_device(args, kwargs)
        args, kwargs = self._prepare_inputs(*args, **kwargs)
        return self._dispatch("forward", args, kwargs, lambda fold: self._forward_value(args, kwargs, fold))

    def _forward_value(self, args: tuple, kwargs: dict, fold: Optional[Callable] = None) -> Any:
        out = self._fold_reliably("forward", args, kwargs, fold)
        batch, value = out if fold is not None else (out, None)
        for k, default in self._defaults.items():  # states the batch does not touch
            if k not in batch:
                batch[k] = torch.zeros((0,), device=self._device) if isinstance(default, list) else default
        # the batch's whole state: compute-group members of a collection take their
        # batch value from it
        self._last_batch_state = batch
        return self._compute(batch) if value is None else value

    __call__ = forward

    def _concat_state(self, state: Optional[StateDict] = None) -> StateDict:
        """``state`` (the live state if None) with list states concatenated to single
        tensors."""
        out: StateDict = {}
        for k, v in (self._state if state is None else state).items():
            if isinstance(v, list):
                out[k] = dim_zero_cat(v) if v else torch.zeros((0,), device=self._device)
            else:
                out[k] = v
        return out

    def compute(self) -> Any:
        """Final value from the accumulated state."""
        if self._update_count == 0 and not self._update_called_warned:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the ``update`` method "
                "which may lead to errors, as metric states have not yet been updated.",
                UserWarning,
            )
            self._update_called_warned = True
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        # an already-synced metric (sync_context, or a collection's coalesced pre-sync)
        # computes on the synced state as it is; whoever synced it owns the unsync
        did_sync = False
        if self.sync_on_compute and not self._is_synced and self.distributed_available_fn():
            self.sync()
            did_sync = True
        try:
            state = self._concat_state()
            rec = _observability._ACTIVE
            t0 = _tracing.monotonic() if rec is not None else 0.0
            with _tracing.trace_span(f"{type(self).__name__}.compute"):
                value = self._reliable_call("compute", lambda: self._compute(state))
            if rec is not None:
                rec.record_compute(self, rec.finish(value, t0, self._device))
        finally:
            if did_sync:
                self.unsync()
        if self.compute_with_cache:
            self._computed = value
        return value

    def reset(self) -> None:
        """Restore default states."""
        self._update_count = 0
        self._computed = None
        self._state = self.init_state()
        self._is_synced = False
        self._cache = None

    # ------------------------------------------------------------------ sync

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> None:
        """Replace the local states with the states synced across processes
        (``parallel.process_sync``); ``unsync`` restores the local ones. The synced
        states come back on the metric's device."""
        if self._is_synced and should_sync:
            raise TorchMetricsUserError("The Metric has already been synced.")
        if not should_sync or not (distributed_available or self.distributed_available_fn)():
            return
        rec = _observability._ACTIVE
        t0 = _tracing.monotonic() if rec is not None else 0.0
        bytes0 = rec.counters.value("sync_payload_bytes") if rec is not None else 0
        coll0 = rec.counters.value("sync_collectives") if rec is not None else 0
        coal0 = rec.counters.value("gathers_coalesced") if rec is not None else 0
        with _tracing.trace_span(f"{type(self).__name__}.sync"):
            synced = self._reliable_call(
                "sync",
                lambda: _sync.process_sync(
                    self._state,
                    self._reductions,
                    process_group=process_group or self.process_group,
                    dist_sync_fn=dist_sync_fn or self.dist_sync_fn,
                ),
            )
        if rec is not None:
            # bytes and collectives were counted inside process_sync: the deltas are
            # this sync's
            rec.record_sync(
                self, rec.finish(synced, t0, self._device),
                rec.counters.value("sync_payload_bytes") - bytes0,
                collectives=rec.counters.value("sync_collectives") - coll0,
                coalesced_leaves=rec.counters.value("gathers_coalesced") - coal0,
            )
        rel = self._reliability
        if rel is not None and rel.validate_on_sync:
            # a corrupt contribution from any participant must not silently become this
            # process's state: StateCorruptionError leaves the local state in place
            validate_state(self, synced, context=f"{type(self).__name__}.sync", check_finite=rel.check_finite)
        self._commit_synced(synced)

    def _commit_synced(self, synced: StateDict) -> None:
        self._cache = {k: (list(v) if isinstance(v, list) else v) for k, v in self._state.items()}
        self._state = {
            k: [_to_device(t, self._device) for t in v] if isinstance(v, list) else _to_device(v, self._device)
            for k, v in synced.items()
        }
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the local states that ``sync`` replaced."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise TorchMetricsUserError("The Metric has already been un-synced.")
        self._state = self._cache
        self._cache = None
        self._is_synced = False

    class _SyncContext:
        def __init__(self, metric: "Metric", **kwargs: Any) -> None:
            self.metric = metric
            self.kwargs = kwargs

        def __enter__(self) -> None:
            self.metric.sync(**self.kwargs)

        def __exit__(self, *exc: Any) -> None:
            if self.metric._is_synced:
                self.metric.unsync()

    def sync_context(self, **kwargs: Any) -> "Metric._SyncContext":
        """``with metric.sync_context(...):`` syncs on entry and unsyncs on exit."""
        return Metric._SyncContext(self, **kwargs)

    def merge_state(self, incoming_state: Union[StateDict, "Metric"]) -> None:
        """Fold another metric's states (or a state dict) into this one, without
        communication. ``"mean"`` states are weighted by each side's update count, so
        chained merges stay exact: a bare dict weighs 1, a ``state_dict()`` its saved
        ``_update_count``."""
        if isinstance(incoming_state, Metric):
            if type(incoming_state) is not type(self):
                raise ValueError(f"Expected incoming state to be of type {type(self).__name__}")
            incoming = incoming_state._state
            incoming_count = incoming_state._update_count
        elif isinstance(incoming_state, dict):
            metas = [v for k, v in incoming_state.items() if k.endswith("_update_count")]
            incoming = {
                k: v for k, v in incoming_state.items() if not k.endswith(("_update_count", "_saved_states"))
            }
            unknown = set(incoming) - set(self._state)
            if unknown:
                raise RuntimeError(f"Got unknown state keys {sorted(unknown)}")
            incoming_count = int(metas[0]) if metas else 1
        else:
            raise ValueError("Expected incoming state to be a dict or an instance of Metric")
        if self._is_synced:
            raise TorchMetricsUserError("The Metric shouldn't be synced when performing ``merge_state``.")
        rel = self._reliability
        if rel is not None and rel.validate_on_merge:
            # both sides, separately: a merged dict would let incoming keys shadow the
            # local accumulator's leaves, and a corrupt accumulator would hide behind them
            for side, state in (("local", self._state), ("incoming", incoming)):
                validate_state(self, state, context=f"{type(self).__name__}.merge_state ({side})",
                               check_finite=rel.check_finite)
        incoming = {k: _to_device(v, self._device) if not isinstance(v, list) else v for k, v in incoming.items()}
        if self._has_custom_merge():
            merged = self._merge(dict(self._state), incoming)
        else:
            merged = _sync.merge_states(
                dict(self._state), incoming, self._reductions,
                weights=(float(self._update_count), float(incoming_count)),
            )
        self._state.update(merged)
        self._update_count += incoming_count
        self._computed = None

    # ------------------------------------------------------------ persistence

    def persistent(self, mode: bool = False) -> None:
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        """States flagged persistent, as tensors, plus the update count."""
        destination = {} if destination is None else destination
        saved = [name for name in self._defaults if self._persistent[name]]
        rec = _observability._ACTIVE
        for name in saved:
            current = self._state[name]
            if rec is not None:
                # the checkpoint boundary, where states leave the metric for a writer
                # that reads them back: counted per leaf (bytes from metadata), as in
                # the JAX package, whose state_dict converts them to numpy here
                for leaf in current if isinstance(current, list) else (current,):
                    if isinstance(leaf, torch.Tensor):
                        rec.record_d2h("state_dict", leaf.numel() * leaf.element_size(), metric=self)
            destination[prefix + name] = [t.clone() for t in current] if isinstance(current, list) else current.clone()
        if saved:
            # metadata, not states: the update count restores the updated/fresh
            # distinction exactly, and the count of saved leaves is recorded beside it
            destination[prefix + "_update_count"] = int(self._update_count)
            destination[prefix + "_saved_states"] = len(saved)
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "", validate: bool = True) -> None:
        """Adopt the states of ``state_dict`` under ``prefix``. With ``validate`` (the
        default) the structural guard runs first: a checkpoint that lost keys or holds a
        partially written state raises ``StateCorruptionError`` and nothing is adopted;
        ``validate=False`` forces a partial load. The floating states are scanned for NaN
        and Inf only when the metric's ``ReliabilityConfig`` asks for it
        (``validate_on_restore`` and ``check_finite``): a saved cat state may carry NaN
        by design."""
        if validate:
            rel = self._reliability
            validate_restored(
                self, state_dict, prefix,
                check_finite=rel is not None and rel.validate_on_restore and rel.check_finite,
            )
        loaded = False
        for name in self._defaults:
            key = prefix + name
            if key in state_dict:
                v = state_dict[key]
                self._state[name] = (
                    [torch.as_tensor(x, device=self._device) for x in v]
                    if isinstance(v, list)
                    else torch.as_tensor(v, device=self._device)
                )
                loaded = True
        if loaded:
            self._drop_aot_memo()  # the checkpoint's dtypes may not be the programs'
            meta_key = prefix + "_update_count"
            if meta_key in state_dict:
                self._update_count = int(state_dict[meta_key])
            else:  # older checkpoints: an update happened if any state left its default
                self._update_count = int(any(
                    len(self._state[n]) > 0 if isinstance(self._state[n], list)
                    else not torch.equal(self._state[n], self._defaults[n])
                    for n in self._defaults
                ))
            self._computed = None

    def state_memory(self) -> Dict[str, Any]:
        """Per-state device-memory footprint from tensor metadata, with no device read
        (safe under ``torch.cuda.set_sync_debug_mode("error")`` and in a hot loop).
        Tensor states report shape and dtype; list ("cat") states report element
        counts, the one axis that grows without bound between resets.

        Example:
            >>> import torch
            >>> from torchmetrics_tpu_torch import CatMetric
            >>> metric = CatMetric(device="cpu")
            >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
            >>> metric.state_memory()["total_bytes"]
            12
            >>> metric.state_memory()["states"]["value"]["elements"]
            1
        """
        return _obs_memory.state_memory(self._state)

    # ------------------------------------------------------- warm start (aot/)

    def _aot_program(self, tag: str) -> torch.nn.Module:
        """The program behind one dispatch tag, as the AOT plane exports it: the
        metric's fold for ``update``/``forward`` (:class:`_FoldProgram`), and the stream
        transforms' steps for ``wupdate``/``wdual``/``wstack``/``dupdate``
        (:class:`_WindowProgram`; ``wstack``'s depth is set by the SlidingWindow that
        owns it). Owner-built programs (``"mapeval"``, ``"escore"``) come from the
        metrics that own them."""
        if tag in ("update", "forward"):
            return _FoldProgram(self, tag)
        if tag == "wdual":
            self._check_windowable("dual")
        elif tag == "wstack":
            self._check_windowable("two_stack")
            if self.__dict__.get("_wstack_depth") is None:
                raise TorchMetricsUserError(
                    "the 'wstack' program is parameterized by its window geometry and is "
                    "built by its owner (SlidingWindow) first"
                )
        elif tag == "dupdate":
            self._check_decayable()
        elif tag != "wupdate":
            raise ValueError(
                f"Unknown dispatch tag {tag!r} for {type(self).__name__}; expected 'update', 'forward', "
                "'wupdate', 'wdual', 'wstack' or 'dupdate' (the 'mapeval' and 'escore' programs belong "
                "to DeviceMeanAveragePrecision and BERTScore)"
            )
        return _WindowProgram(self, tag)

    def _aot_plane(self, cache_dir: Optional[str]) -> Any:
        if cache_dir is not None:
            # an explicit cache_dir always wins — a deploy hook populating a bake-time
            # cache must not write into whatever plane the process has active
            return _aot.AotPlane(_aot.AotConfig(cache_dir=cache_dir))
        if _aot._ACTIVE is None:
            raise TorchMetricsUserError(
                "precompile needs an active AOT plane — call "
                "torchmetrics_tpu_torch.aot.enable(cache_dir) first, or pass cache_dir=."
            )
        return _aot._ACTIVE

    def _aot_examples(self, example_inputs: tuple, example_kwargs: Dict[str, Any]) -> Tuple[tuple, dict]:
        """The examples as the dispatch sees them: moved to the device and through
        ``_prepare_inputs``. ``device="meta"`` placeholders carry no values, so value-level
        validation cannot run on them: calls with placeholders skip ``_prepare_inputs``
        and must be given its output shapes (for most metrics prepare is identity or
        validation only)."""
        if _aot.has_placeholder((example_inputs, example_kwargs)):
            return example_inputs, example_kwargs
        args, kwargs = self._on_device(example_inputs, example_kwargs)
        return self._prepare_inputs(*args, **kwargs)

    def precompile(
        self,
        *example_inputs: Any,
        tags: Sequence[str] = ("update",),
        cache_dir: Optional[str] = None,
        force: bool = False,
        **example_kwargs: Any,
    ) -> Dict[str, Any]:
        """Export and compile this metric's dispatch program(s) for the given example
        input shapes AHEAD of traffic and publish them into the AOT cache, so a freshly
        booted process serves its first update from a cache load.

        Example inputs may be tensors, numpy arrays, ``device="meta"`` placeholders or
        Python scalars — only shape/dtype metadata shapes the program and the key.
        Uses the active plane (:func:`torchmetrics_tpu_torch.aot.enable`) or, for
        one-off population, an explicit ``cache_dir``. Returns ``{tag: report_row}``: a
        program whose entry exists reports ``"cached"`` (``force=True`` rewrites), one
        that does not export ``"failed"`` with the exporter's first error line, and a
        metric whose config holds tensors or a weighted module ``"skipped"``
        (uncacheable).
        """
        plane = self._aot_plane(cache_dir)
        args, kwargs = self._aot_examples(example_inputs, example_kwargs)
        tensors = self._tensor_states()
        report: Dict[str, Any] = {}
        for tag in tags:
            try:
                report[tag] = plane.precompile_program(
                    self, tag, self._aot_program(tag), tensors, args, kwargs, force=force
                )
            except _aot.keys.UnfingerprintableConfig as err:
                report[tag] = {"status": "skipped", "reason": f"uncacheable: {err}"}
        return report

    def prefetch_compiled(
        self,
        *example_inputs: Any,
        tags: Sequence[str] = ("update",),
        **example_kwargs: Any,
    ) -> Dict[str, Any]:
        """Load this metric's cached programs for the example signature into the
        in-process dispatch memo WITHOUT compiling on a miss.

        The read-only sibling of :meth:`precompile`: a hit loads the program and primes
        the memo so the first real dispatch is served from memory (no disk probe on the
        traffic path); a miss is remembered exactly like a dispatch-time miss.
        Thread-safe against OTHER metrics prefetching concurrently —
        ``MetricCollection.precompile`` overlaps its members' loads on a thread pool.
        Returns ``{tag: row}``."""
        plane = _aot._ACTIVE
        if plane is None:
            raise TorchMetricsUserError(
                "prefetch_compiled needs an active AOT plane — call "
                "torchmetrics_tpu_torch.aot.enable(cache_dir) first."
            )
        args, kwargs = self._aot_examples(example_inputs, example_kwargs)
        tensors = self._tensor_states()
        report: Dict[str, Any] = {}
        for tag in tags:
            slot = plane.lookup_dispatch(self, tag, tensors, (args, kwargs))
            if slot is not None and slot.compiled is not None:
                report[tag] = {
                    "status": "loaded", "codec": slot.codec,
                    "load_s": round(slot.load_s, 6), "bytes": slot.nbytes,
                }
            else:
                report[tag] = {"status": "miss"}
        return report

    def _program_dispatch(self, tag: str, tensors: StateDict, inputs: tuple, eager: Callable[[], Any]) -> Any:
        """An owner-built program (``"mapeval"``, ``"escore"``) through the AOT plane:
        the loaded program serves a hit, ``eager()`` a miss. In a telemetry session the
        call is recorded as a dispatch with its load or miss, as ``update`` is. With no
        plane this reads ``aot._ACTIVE`` once and calls ``eager()``."""
        plane = _aot._ACTIVE
        if plane is None:
            return eager()
        slot = plane.lookup_dispatch(self, tag, tensors, inputs)
        rec = _observability._ACTIVE
        t0 = _tracing.monotonic()
        out = None
        if slot.compiled is not None:
            try:
                out = slot.compiled(tensors, self._aot_counter(), *_aot.program_inputs(inputs, self._device))
            except (TypeError, ValueError):
                slot.demote()
        if slot.compiled is None:
            out = eager()
        if rec is not None:
            hit = slot.compiled is not None
            duration = rec.finish(out, t0, self._device)
            if hit and slot.event_pending:
                slot.event_pending = False
                rec.record_aot_load(self, tag, slot.load_s, slot.nbytes, slot.key, slot.codec)
            if not hit and slot.miss_pending:
                slot.miss_pending = False
                rec.record_aot_miss()
            rec.record_dispatch(self, tag, inputs, duration, aot_loaded=hit, signature=slot.signature)
        if slot.store_pending:
            plane.store_from_dispatch(self, tag, tensors, inputs, slot)
        return out

    # ------------------------------------------------------------- copies

    def clone(self) -> "Metric":
        """An independent copy: states are copied by value."""
        return deepcopy(self)

    def __deepcopy__(self, memo: dict) -> "Metric":
        # attributes go in through object.__setattr__: __setattr__ and __getattr__
        # look into _state, which the new object does not have yet
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k in ("_aot_memo", "_aot_n"):  # loaded programs are process-local
                continue
            if k in ("_state", "_cache"):
                value = None if v is None else {
                    n: [t.clone() for t in s] if isinstance(s, list) else s.clone() for n, s in v.items()
                }
            elif k in ("_defaults", "_reductions", "_persistent"):
                value = dict(v)
            else:
                try:
                    value = deepcopy(v, memo)
                except TypeError:  # a member that cannot be copied (a process group) is shared
                    value = v
            object.__setattr__(new, k, value)
        return new

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        # callables, caches and injection hooks stay behind
        state.update(_cache=None, _computed=None, dist_sync_fn=None, _fault_hook=None)
        state.pop("_last_batch_state", None)
        state.pop("distributed_available_fn", None)
        state.pop("_aot_memo", None)  # loaded programs are process-local
        state.pop("_aot_n", None)
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.__dict__["distributed_available_fn"] = _sync.distributed_available
        self.__dict__.setdefault("_reliability", None)
        self.__dict__.setdefault("_fault_hook", None)

    # --------------------------------------------------------------- dtype

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast the floating states and defaults to ``dst_type``; integer states keep
        their dtype."""

        def cast(x):
            return x.to(dst_type) if isinstance(x, torch.Tensor) and x.is_floating_point() else x

        def cast_leaf(v):
            return [cast(t) for t in v] if isinstance(v, list) else cast(v)

        self._state.update({k: cast_leaf(v) for k, v in self._state.items()})
        self._defaults = {k: cast_leaf(v) for k, v in self._defaults.items()}
        self._dtype = dst_type
        self._computed = None
        self._drop_aot_memo()  # dtypes changed — loaded programs are stale
        return self

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return self._dtype

    @property
    def update_called(self) -> bool:
        return self._update_count > 0

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def metric_state(self) -> StateDict:
        return {k: list(v) if isinstance(v, list) else v for k, v in self._state.items()}

    # ---------------------------------------------------------------- helpers

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only kwargs that this metric's ``_batch_state`` accepts."""
        params = inspect.signature(self._batch_state).parameters
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            return kwargs
        names = {n for n, p in params.items() if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
        return {k: v for k, v in kwargs.items() if k in names}

    def __hash__(self) -> int:
        """From the ids of the state objects: it changes when an update replaces them."""
        hash_vals = [type(self).__name__]
        for key in self._defaults:
            val = self._state[key]
            if isinstance(val, list):
                hash_vals.extend(id(v) for v in val)
            else:
                hash_vals.append(id(val))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    def __abs__(self): return CompositionalMetric(torch.abs, self, None)
    def __add__(self, other): return CompositionalMetric(torch.add, self, other)
    def __and__(self, other): return CompositionalMetric(torch.bitwise_and, self, other)
    def __eq__(self, other): return CompositionalMetric(torch.eq, self, other)  # type: ignore[override]
    def __floordiv__(self, other): return CompositionalMetric(torch.floor_divide, self, other)
    def __ge__(self, other): return CompositionalMetric(torch.greater_equal, self, other)
    def __gt__(self, other): return CompositionalMetric(torch.greater, self, other)
    def __le__(self, other): return CompositionalMetric(torch.less_equal, self, other)
    def __lt__(self, other): return CompositionalMetric(torch.less, self, other)
    def __matmul__(self, other): return CompositionalMetric(torch.matmul, self, other)
    def __mod__(self, other): return CompositionalMetric(torch.remainder, self, other)
    def __mul__(self, other): return CompositionalMetric(torch.multiply, self, other)
    def __ne__(self, other): return CompositionalMetric(torch.not_equal, self, other)  # type: ignore[override]
    def __neg__(self): return CompositionalMetric(torch.negative, self, None)
    def __or__(self, other): return CompositionalMetric(torch.bitwise_or, self, other)
    def __pos__(self): return CompositionalMetric(torch.abs, self, None)  # abs, as in the JAX package
    def __pow__(self, other): return CompositionalMetric(torch.pow, self, other)
    def __radd__(self, other): return CompositionalMetric(torch.add, other, self)
    def __rand__(self, other): return CompositionalMetric(torch.bitwise_and, other, self)
    def __rfloordiv__(self, other): return CompositionalMetric(torch.floor_divide, other, self)
    def __rmatmul__(self, other): return CompositionalMetric(torch.matmul, other, self)
    def __rmod__(self, other): return CompositionalMetric(torch.remainder, other, self)
    def __rmul__(self, other): return CompositionalMetric(torch.multiply, other, self)
    def __ror__(self, other): return CompositionalMetric(torch.bitwise_or, other, self)
    def __rpow__(self, other): return CompositionalMetric(torch.pow, other, self)
    def __rsub__(self, other): return CompositionalMetric(torch.subtract, other, self)
    def __rtruediv__(self, other): return CompositionalMetric(torch.true_divide, other, self)
    def __rxor__(self, other): return CompositionalMetric(torch.bitwise_xor, other, self)
    def __sub__(self, other): return CompositionalMetric(torch.subtract, self, other)
    def __truediv__(self, other): return CompositionalMetric(torch.true_divide, self, other)
    def __xor__(self, other): return CompositionalMetric(torch.bitwise_xor, self, other)
    def __invert__(self): return CompositionalMetric(torch.bitwise_not, self, None)

    def __getitem__(self, idx) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)

    # ---------------------------------------------------------------- plotting

    def plot(self, *args: Any, **kwargs: Any):
        """A figure of the value (``args[0]``, or ``compute()``): a point for a scalar,
        bars for a vector, lines over steps for a list of values. Needs matplotlib."""
        from .utilities.plot import plot_single_or_multi_val

        val = args[0] if args else self.compute()
        return plot_single_or_multi_val(
            val,
            higher_is_better=self.higher_is_better,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name,
            name=type(self).__name__,
            ax=kwargs.get("ax"),
        )


class _FoldProgram(torch.nn.Module):
    """A metric's pure fold as one module: what the AOT plane exports and compiles.

    ``forward(tensors, n, args, kwargs)`` runs ``_batch_state`` and merges it into the
    tensor states as :meth:`Metric._fold` does (``n``, the update count as a 0-d float32
    tensor, weighs the running-mean fold). ``update`` returns ``(new tensor states,
    cat appends, n + 1)``; ``forward`` returns ``(new tensor states, cat appends, batch
    value, batch state)``, the value None where the metric's compute is not traceable
    (``_jittable_compute``). The metric is held as a plain attribute, not a submodule:
    nothing of it is a parameter of the program.
    """

    def __init__(self, metric: Metric, tag: str) -> None:
        super().__init__()
        self.metric = metric
        self.tag = tag

    def forward(self, tensors: StateDict, n: torch.Tensor, args: tuple, kwargs: dict):
        m = self.metric
        lists = set(m._list_state_names)
        batch = m._batch_state(*args, **kwargs)
        appends = {k: v for k, v in batch.items() if k in lists}
        batch_t = {k: v for k, v in batch.items() if k not in lists}
        if m._has_custom_merge():
            merged = m._merge(dict(tensors), batch_t)
        else:
            merged = {k: _fold_leaf(m._reductions[k], tensors[k], v, n) for k, v in batch_t.items()}
        new = dict(tensors)
        new.update({k: v.to(tensors[k].dtype) if k in tensors else v for k, v in merged.items()})
        if self.tag == "update":
            return new, appends, n + 1.0
        for k, default in m._defaults.items():
            if k not in batch:
                batch[k] = torch.zeros((0,), device=n.device) if isinstance(default, list) else default
        value = m._compute(batch) if m._jittable_compute else None
        return new, appends, value, batch


def _fold_leaf(fx: Any, a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """:func:`~.parallel.sync.pairwise_merge` with the update count as a tensor: the
    ``"mean"`` fold is the eager ``weighted_mean(a, b, count, 1.0)`` (whose total is
    never 0 there) without a branch on a traced value."""
    if fx == "mean":
        return (n * a + b) / (n + 1.0)
    return _sync.pairwise_merge(fx, a, b)


def _batch_tensors(metric: Metric, args: tuple, kwargs: dict) -> Tuple[StateDict, StateDict]:
    """``metric``'s batch state split into (tensor states, cat appends)."""
    lists = set(metric._list_state_names)
    bs = metric._batch_state(*args, **kwargs)
    appends = {k: v for k, v in bs.items() if k in lists}
    return {k: torch.as_tensor(v) for k, v in bs.items() if k not in lists}, appends


def window_step(metric: Metric, tag: str, state: StateDict, args: tuple, kwargs: dict,
                flip_now: Optional[bool] = None) -> Any:
    """One step of a stream transform's program: ``args[0]`` is the window (``wdual``),
    the pane (``wstack``) or the decay (``dupdate``) as a 0-d tensor, the rest the
    batch; ``wupdate`` takes the batch alone. Returns the new state, its keys in the
    order of ``state`` (a loaded program takes its dict in the order it was exported
    with), and for ``wupdate`` also the batch's cat appends. Nothing of ``state`` is
    written."""
    if tag == "wupdate":
        new, appends = _window_step(metric, tag, state, args, kwargs, flip_now)
        return {k: new[k] for k in state}, appends
    new = _window_step(metric, tag, state, args, kwargs, flip_now)
    return {k: new[k] for k in state}


def _window_step(metric: Metric, tag: str, state: StateDict, args: tuple, kwargs: dict,
                 flip_now: Optional[bool]) -> Any:
    reductions = metric._reductions
    defaults_t = metric._tensor_defaults()
    if tag == "wupdate":
        bs_t, appends = _batch_tensors(metric, args, kwargs)
        cursor, counts = state[WINDOW_CURSOR_KEY], state[WINDOW_COUNT_KEY]
        slot = torch.remainder(cursor, counts.shape[0]).to(torch.int64).reshape(1)
        out: StateDict = {}
        for k, v in state.items():
            if k in (WINDOW_CURSOR_KEY, WINDOW_COUNT_KEY):
                continue
            contrib = bs_t.get(k, defaults_t.get(k))
            out[k] = v.index_copy(0, slot, contrib.to(device=v.device, dtype=v.dtype).reshape((1,) + v.shape[1:]))
        out[WINDOW_COUNT_KEY] = counts.index_fill(0, slot, 1.0)
        out[WINDOW_CURSOR_KEY] = cursor + 1
        return out, appends
    param, batch = args[0], args[1:]
    bs_t, _ = _batch_tensors(metric, batch, kwargs)
    if tag == "wdual":
        return _dual_step(reductions, defaults_t, state, param, bs_t)
    if tag == "wstack":
        return _stack_step(reductions, defaults_t, metric.__dict__["_wstack_depth"], state, param, bs_t, flip_now)
    # dupdate: sum leaves scale by the decay before absorbing the batch, mean leaves
    # fold as a weighted mean against the decayed weight, max/min keep their merge
    w = state[DECAY_WEIGHT_KEY]
    out = {}
    for k, v in state.items():
        if k == DECAY_WEIGHT_KEY:
            continue
        fx = reductions.get(k)
        b = bs_t.get(k)
        if fx == "sum":
            scaled = v * param.to(v.dtype)
            out[k] = scaled if b is None else scaled + b.to(v.dtype)
        elif fx == "mean" and b is not None:
            out[k] = _weighted_mean(v, b, w * param, 1.0).to(v.dtype)
        elif fx == "max" and b is not None:
            out[k] = torch.maximum(v, b.to(v.dtype))
        elif fx == "min" and b is not None:
            out[k] = torch.minimum(v, b.to(v.dtype))
        else:  # untouched non-sum leaves and None: kept
            out[k] = v
    out[DECAY_WEIGHT_KEY] = w * param + 1.0
    return out


class _WindowProgram(torch.nn.Module):
    """A stream transform's step as one module (:func:`window_step`, branch-free): what
    the AOT plane exports for ``wupdate``, ``wdual``, ``wstack`` and ``dupdate``.
    ``forward(state, n, args, kwargs)``; ``n`` is the calling convention's placeholder
    (the window's own counts live in its state)."""

    def __init__(self, metric: Metric, tag: str) -> None:
        super().__init__()
        self.metric = metric
        self.tag = tag

    def forward(self, state: StateDict, n: torch.Tensor, args: tuple, kwargs: dict):
        return window_step(self.metric, self.tag, state, args, kwargs)


class HostMetric(Metric):
    """Base for metrics whose batch contribution is built on the host: ragged per-image
    inputs (detection), where ``_host_batch_state(*inputs) -> dict`` returns, per state,
    one tensor to append (list states, already concatenated over the batch's items) or
    a tensor contribution to fold.

    The fold is ``Metric``'s: ``update`` appends the list states and merges the tensor
    ones, and ``forward`` builds the contribution once and computes the value of the
    batch alone from it. A retry policy retries only the contribution (the host work,
    third-party callbacks): the fold is never applied twice, so no backup is taken. List
    states live on the host: a sync brings them back there, not to the metric's device.
    """

    _jittable_compute = False

    def _host_batch_state(self, *args: Any, **kwargs: Any) -> StateDict:
        raise NotImplementedError

    def _batch_state(self, *args: Any, **kwargs: Any) -> StateDict:
        return self._host_batch_state(*args, **kwargs)

    def precompile(self, *example_inputs: Any, tags: Sequence[str] = ("update",), **kwargs: Any) -> Dict[str, Any]:
        """Host metrics dispatch on the host — there is no program to cache. A no-op
        report keeps ``MetricCollection.precompile`` total over heterogeneous
        collections."""
        return {tag: {"status": "skipped", "reason": "host-side metric — no jitted dispatch program"} for tag in tags}

    def prefetch_compiled(self, *example_inputs: Any, tags: Sequence[str] = ("update",), **kwargs: Any) -> Dict[str, Any]:
        """No program — nothing to load (see :meth:`precompile`)."""
        return {tag: {"status": "skipped", "reason": "host-side metric — no jitted dispatch program"} for tag in tags}

    def _fold_reliably(self, tag: str, args: tuple, kwargs: dict, fold: Optional[Callable] = None) -> StateDict:
        batch = self._reliable_call(tag, lambda: self._host_batch_state(*args, **kwargs))
        self._fold(batch)
        return batch

    def _dispatch(self, tag: str, args: tuple, kwargs: dict, run: Callable[[Optional[Callable]], Any]) -> Any:
        """No tensor-path record and no AOT program: the host contribution records as a
        host dispatch in :meth:`_reliable_call`, and the state memory is refreshed after
        the fold."""
        out = run(None)
        rec = _observability._ACTIVE
        if rec is not None:
            rec.record_state_memory(self)
        return out

    def _commit_synced(self, synced: StateDict) -> None:
        super()._commit_synced(synced)
        for k in set(self._list_state_names) & synced.keys():
            self._state[k] = [t.cpu() if isinstance(t, torch.Tensor) else t for t in synced[k]]


class CompositionalMetric(Metric):
    """A lazy operator tree over metrics and constants (the arithmetic operators of
    ``Metric`` build it). ``update`` and ``reset`` reach every metric operand;
    ``compute`` and ``forward`` apply the operator to the operands' values. Constants
    become tensors on the device of the first metric operand.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> acc = MulticlassAccuracy(3, average="micro", device="cpu")
        >>> half = (acc + acc) / 4
        >>> half.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
        >>> round(float(half.compute()), 4)
        0.375
    """

    def __init__(self, operator: Callable, metric_a: Any, metric_b: Any) -> None:
        device = next(m.device for m in (metric_a, metric_b) if isinstance(m, Metric))
        super().__init__(device=device)
        self.op = operator
        self.metric_a = self._operand(metric_a)
        self.metric_b = self._operand(metric_b)
        self._op_b_raw = metric_b

    def _operand(self, value: Any) -> Any:
        if value is None or isinstance(value, Metric):
            return value
        return torch.as_tensor(value, device=self.device)

    def _metrics(self) -> List[Metric]:
        return [m for m in (self.metric_a, self.metric_b) if isinstance(m, Metric)]

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return kwargs

    def precompile(
        self,
        *example_inputs: Any,
        tags: Sequence[str] = ("update",),
        cache_dir: Optional[str] = None,
        force: bool = False,
        **example_kwargs: Any,
    ) -> Dict[str, Any]:
        """Warm both operands — the composition itself has no program. Example kwargs
        route through each operand's kwarg filter, as the composed ``update`` does, so
        the cached signatures match what real traffic dispatches."""
        return {
            side: operand.precompile(*example_inputs, tags=tags, cache_dir=cache_dir, force=force,
                                     **operand._filter_kwargs(**example_kwargs))
            for side, operand in (("metric_a", self.metric_a), ("metric_b", self.metric_b))
            if isinstance(operand, Metric)
        }

    def prefetch_compiled(
        self, *example_inputs: Any, tags: Sequence[str] = ("update",), **example_kwargs: Any
    ) -> Dict[str, Any]:
        """Prefetch both operands' cached programs (the composition has none)."""
        return {
            side: operand.prefetch_compiled(*example_inputs, tags=tags, **operand._filter_kwargs(**example_kwargs))
            for side, operand in (("metric_a", self.metric_a), ("metric_b", self.metric_b))
            if isinstance(operand, Metric)
        }

    def update(self, *args: Any, **kwargs: Any) -> None:
        for metric in self._metrics():
            metric.update(*args, **metric._filter_kwargs(**kwargs))
        self._update_count += 1
        self._computed = None

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        return self.op(val_a) if val_b is None else self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        def value(operand):
            if isinstance(operand, Metric):
                return operand.forward(*args, **operand._filter_kwargs(**kwargs))
            return operand

        val_a, val_b = value(self.metric_a), value(self.metric_b)
        self._update_count += 1
        if val_a is None:
            return None
        if val_b is None:
            return self.op(val_a) if self._op_b_raw is None else None
        return self.op(val_a, val_b)

    __call__ = forward

    def reset(self) -> None:
        for metric in self._metrics():
            metric.reset()
        self._update_count = 0
        self._computed = None

    def persistent(self, mode: bool = False) -> None:
        for metric in self._metrics():
            metric.persistent(mode=mode)

    def __repr__(self) -> str:
        name = getattr(self.op, "__name__", "op")
        return f"{type(self).__name__}(\n  {name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"

    def __hash__(self) -> int:
        return object.__hash__(self)
