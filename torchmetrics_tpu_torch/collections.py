"""``MetricCollection`` and its pure functional view (counterpart of
``torchmetrics_tpu/collections.py``: dict construction, ``update``, ``compute``,
``reset``, the coalesced ``sync``/``unsync`` and ``as_pure`` with
``PureCollection.reduce``; compute groups and ``on_error`` are not ported yet).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from .metric import Metric
from .parallel import coalesce as _coalesce
from .utilities.checks import resolve_device
from .utilities.data import _flatten_dict
from .utilities.exceptions import TorchMetricsUserError


def _flatten_with_naming(res: Dict[str, Any], set_name) -> Dict[str, Any]:
    """Flatten nested dict results; bare sub-keys unless they collide across metrics."""
    _, duplicates = _flatten_dict(res)
    out: Dict[str, Any] = {}
    for k, v in res.items():
        if isinstance(v, dict):
            for sub_k, sub_v in v.items():
                out[set_name(f"{k}_{sub_k}" if duplicates else sub_k)] = sub_v
        else:
            out[set_name(k)] = v
    return out


class MetricCollection:
    """Dict of metrics with one update/compute/reset. Members are moved to the
    collection's ``device`` (``None`` means ``"cuda"``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MetricCollection
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> collection = MetricCollection({"acc": MulticlassAccuracy(num_classes=3, device="cpu"),
        ...                                "f1": MulticlassF1Score(num_classes=3, device="cpu")}, device="cpu")
        >>> collection.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in collection.compute().items()}
        {'acc': 1.0, 'f1': 1.0}
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Mapping[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.device = resolve_device(device)
        self._modules: "OrderedDict[str, Metric]" = OrderedDict()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Mapping[str, Metric]], *additional_metrics: Metric
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics) + [m for m in additional_metrics if isinstance(m, Metric)]
        elif additional_metrics:
            raise ValueError(
                f"You have passed extra arguments {additional_metrics} which are only valid if input is a sequence."
            )
        if isinstance(metrics, Mapping):
            named = [(name, metrics[name]) for name in sorted(metrics.keys())]
        elif isinstance(metrics, Sequence):
            named = [(type(m).__name__, m) for m in metrics]
        else:
            raise ValueError("Unknown input to MetricCollection.")
        for name, metric in named:
            if not isinstance(metric, Metric):
                raise ValueError(f"Value {metric} belonging to key {name} is not an instance of `Metric`")
            if name in self._modules:
                raise ValueError(f"Encountered two metrics both named {name}")
            self._modules[name] = metric.to(self.device)

    def keys(self, keep_base: bool = False) -> Iterable[str]:
        if keep_base:
            return self._modules.keys()
        return [self._set_name(k) for k in self._modules]

    def values(self) -> Iterable[Metric]:
        return self._modules.values()

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:
        if keep_base:
            return self._modules.items()
        return [(self._set_name(k), v) for k, v in self._modules.items()]

    def __getitem__(self, key: str) -> Metric:
        return self._modules[key]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._modules)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in set(self.keys())

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def update(self, *args: Any, **kwargs: Any) -> None:
        for metric in self._modules.values():
            metric.update(*args, **metric._filter_kwargs(**kwargs))

    def compute(self) -> Dict[str, Any]:
        # coalesced pre-sync: every member that would sync inside its own compute()
        # syncs here, through one bucketed collective set instead of one sync per
        # member (members see _is_synced and skip theirs); unsync restores them after
        presynced = self._presync_for_compute()
        try:
            res = {name: m.compute() for name, m in self._modules.items()}
        finally:
            for metric in presynced:
                if metric._is_synced:
                    metric.unsync()
        return _flatten_with_naming(res, self._set_name)

    def _presync_for_compute(self) -> List[Metric]:
        """Coalesce the ``sync_on_compute`` syncs of all members into one bucketed
        sync; where the fast path cannot serve them, members sync themselves inside
        ``compute()`` as before. Returns the members this call synced."""
        members = [
            m
            for m in self._modules.values()
            if m.sync_on_compute
            and not m._is_synced
            and not (m.compute_with_cache and m._computed is not None)
            # replace only the sync that Metric.compute itself would run
            and type(m).compute is Metric.compute
        ]
        if not members or not self._coalesced_sync(members):
            return []
        return [m for m in members if m._is_synced]

    def reset(self) -> None:
        for metric in self._modules.values():
            metric.reset()

    def sync(self, async_: bool = False, **kwargs: Any) -> None:
        """Sync every member across processes. Fast path: all members' states coalesce
        into one bucketed collective set (one metadata all-gather and one padded
        all-gather per dtype, in place of two collectives per leaf). Members that
        disagree on the gather seam (``dist_sync_fn``, ``process_group``, availability)
        or override ``sync`` are synced one by one with ``Metric.sync``. ``kwargs`` are
        ``Metric.sync``'s."""
        if async_:
            raise NotImplementedError(
                "sync(async_=True) belongs to the streaming plane (parallel/async_sync.py), which is not ported yet"
            )
        if self._coalesced_sync(list(self._modules.values()), **kwargs):
            return
        for metric in self._modules.values():
            metric.sync(**kwargs)

    def _coalesced_sync(
        self,
        metrics: List[Metric],
        dist_sync_fn: Optional[Any] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Any] = None,
    ) -> bool:
        """Coalesced multi-metric sync. Returns True when this call handled the sync
        (the no-op where nothing is distributed included) and False when the caller
        must sync member by member. Nothing is committed until every bucket has
        gathered, so a failed gather leaves every member at its last state."""
        if not should_sync or not metrics:
            return True
        fns = {id(dist_sync_fn or m.dist_sync_fn) for m in metrics}
        groups = {id(process_group or m.process_group) for m in metrics}
        if len(fns) > 1 or len(groups) > 1:
            return False  # mixed gather seams: per-member semantics required
        if any(type(m).sync is not Metric.sync for m in metrics):
            return False  # a member customizes sync: honor it per member
        # as in Metric.sync, the already-synced error comes before the availability check
        if any(m._is_synced for m in metrics):
            raise TorchMetricsUserError("The Metric has already been synced.")
        avails = {bool((distributed_available or m.distributed_available_fn)()) for m in metrics}
        if len(avails) > 1:
            return False
        if not avails.pop():
            return True  # nowhere to sync: the same no-op as the per-member path
        try:
            synced = _coalesce.coalesced_process_sync(
                [m._state for m in metrics], [m._reductions for m in metrics],
                process_group=process_group or metrics[0].process_group,
                dist_sync_fn=dist_sync_fn or metrics[0].dist_sync_fn,
            )
        except _coalesce.CoalesceFallback:
            return False  # nothing committed; the per-member path syncs from scratch
        for metric, state in zip(metrics, synced):
            metric._commit_synced(state)
        return True

    def unsync(self, **kwargs: Any) -> None:
        """Restore every member's local states (``Metric.unsync``'s ``kwargs``)."""
        for metric in self._modules.values():
            metric.unsync(**kwargs)

    def as_pure(self) -> "PureCollection":
        """The collection as pure functions over a dict of states:
        ``init() -> states``, ``update(states, *batch) -> states``,
        ``compute(states) -> values`` and ``apply(states, *batch) -> (states, values)``.
        Only tensor-state metrics take part."""
        return PureCollection(self)


class PureCollection:
    """Pure functional view of a :class:`MetricCollection` (see ``as_pure``)."""

    def __init__(self, collection: MetricCollection) -> None:
        self._metrics = OrderedDict(collection.items(keep_base=True))
        self._set_name = collection._set_name

    def init(self) -> Dict[str, Any]:
        """Fresh default states, keyed by metric name."""
        return {name: m.init_state() for name, m in self._metrics.items()}

    def update(self, states: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Fold one batch into every metric's state (pure)."""
        return {
            name: m.update_state(states[name], *args, **m._filter_kwargs(**kwargs))
            for name, m in self._metrics.items()
        }

    def compute(self, states: Dict[str, Any]) -> Dict[str, Any]:
        """Values for every metric from its state (pure)."""
        res = {name: m.compute_state(states[name]) for name, m in self._metrics.items()}
        return _flatten_with_naming(res, self._set_name)

    def apply(self, states: Dict[str, Any], *args: Any, **kwargs: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Fused eval step: update all states AND emit the current values (pure)."""
        new_states = self.update(states, *args, **kwargs)
        return new_states, self.compute(new_states)

    def reduce(self, states: Dict[str, Any], group: Any = None) -> Dict[str, Any]:
        """Reduce every member's state across the processes of ``group`` (the default
        group if None), coalesced over the whole collection: all members' leaves share
        one collective per (reduction class × dtype) bucket. A member that overrides
        ``reduce_state`` keeps its own reduction."""
        own = [name for name, m in self._metrics.items() if type(m).reduce_state is not Metric.reduce_state]
        out = {name: self._metrics[name].reduce_state(states[name], group) for name in own}
        default_names = [name for name in self._metrics if name not in own]
        if default_names:
            reduced = _coalesce.reduce_many(
                [(states[n], self._metrics[n]._reductions) for n in default_names], group
            )
            out.update(zip(default_names, reduced))
        return {name: out[name] for name in self._metrics}
