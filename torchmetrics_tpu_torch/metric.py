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

Not here yet: sync over ``torch.distributed``, the reliability, telemetry and AOT
hooks, and the serving/streaming plane builders.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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


def pairwise_merge(fx: Any, a: torch.Tensor, b: torch.Tensor, weights: Optional[Tuple[float, float]] = None):
    """Merge two values of one state by its reduction tag. ``weights=(w_a, w_b)``
    are the update counts behind each side, which make a ``"mean"`` fold exact."""
    if fx is None:
        return a  # keep the local value
    if callable(fx):
        return fx(torch.stack([a, b], dim=0))
    if fx == "sum":
        return a + b
    if fx == "mean":
        if weights is None:
            return (a + b) / 2.0
        w_a, w_b = weights
        return a if w_a + w_b == 0 else (w_a * a + w_b * b) / (w_a + w_b)
    if fx == "max":
        return torch.maximum(a, b)
    if fx == "min":
        return torch.minimum(a, b)
    return torch.cat([torch.atleast_1d(a), torch.atleast_1d(b)], dim=0)  # "cat"


def merge_states(a: StateDict, b: StateDict, reductions: Dict[str, Any]) -> StateDict:
    """Fold state dict ``b`` into ``a`` by per-state reductions (pure)."""
    out: StateDict = {}
    for name, va in a.items():
        vb = b[name]
        if isinstance(va, list) or isinstance(vb, list):
            out[name] = (va if isinstance(va, list) else [va]) + (vb if isinstance(vb, list) else [vb])
        else:
            out[name] = pairwise_merge(reductions.get(name), va, vb)
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
    CUDA pass ``device="cpu"`` explicitly) and ``compute_with_cache``.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    def __init__(self, **kwargs: Any) -> None:
        self._device = resolve_device(kwargs.pop("device", None))
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Any] = {}
        self._persistent: Dict[str, bool] = {}
        self._state: StateDict = {}
        self._update_count = 0
        self._computed: Any = None
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
        return merge_states(a, b, self._reductions)

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

    # ------------------------------------------------------------- lifecycle

    def _fold(self, batch: StateDict) -> None:
        """Merge one batch state into the live state; tensor states keep their dtype."""
        lists = set(self._list_state_names)
        tensors = {k: v for k, v in batch.items() if k not in lists}
        if self._has_custom_merge():
            merged = self._merge({k: self._state[k] for k in tensors}, tensors)
        else:
            weights = (float(self._update_count), 1.0)
            merged = {k: pairwise_merge(self._reductions[k], self._state[k], v, weights) for k, v in tensors.items()}
        for k, v in merged.items():
            self._state[k] = v.to(self._state[k].dtype)
        for k in lists & batch.keys():
            self._state[k].append(batch[k])
        self._update_count += 1
        self._computed = None

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate this batch into the global state."""
        args, kwargs = self._on_device(args, kwargs)
        args, kwargs = self._prepare_inputs(*args, **kwargs)
        self._fold(self._batch_state(*args, **kwargs))

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Batch value AND global accumulation in one pass: the batch state is computed
        once, its value returned, and the same tensors merged into the global state."""
        args, kwargs = self._on_device(args, kwargs)
        args, kwargs = self._prepare_inputs(*args, **kwargs)
        batch = self._batch_state(*args, **kwargs)
        self._fold(batch)
        return self._compute(batch)

    __call__ = forward

    def _concat_state(self) -> StateDict:
        """State with list states concatenated to single tensors."""
        out: StateDict = {}
        for k, v in self._state.items():
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
        value = self._compute(self._concat_state())
        if self.compute_with_cache:
            self._computed = value
        return value

    def reset(self) -> None:
        """Restore default states."""
        self._update_count = 0
        self._computed = None
        self._state = self.init_state()

    # ------------------------------------------------------------ persistence

    def persistent(self, mode: bool = False) -> None:
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        """States flagged persistent, as tensors, plus the update count."""
        destination = {} if destination is None else destination
        saved = [name for name in self._defaults if self._persistent[name]]
        for name in saved:
            current = self._state[name]
            destination[prefix + name] = [t.clone() for t in current] if isinstance(current, list) else current.clone()
        if saved:
            # metadata, not states: the update count restores the updated/fresh
            # distinction exactly, and the count of saved leaves is recorded beside it
            destination[prefix + "_update_count"] = int(self._update_count)
            destination[prefix + "_saved_states"] = len(saved)
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:
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

    # ---------------------------------------------------------------- helpers

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only kwargs that this metric's ``_batch_state`` accepts."""
        params = inspect.signature(self._batch_state).parameters
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            return kwargs
        names = {n for n, p in params.items() if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
        return {k: v for k, v in kwargs.items() if k in names}

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"
