"""``MetricCollection`` and its pure functional view (counterpart of
``torchmetrics_tpu/collections.py``): dict construction, ``update``, ``forward`` and
``__call__``, ``compute``, ``reset``, compute groups, the ``on_error`` policies, the
coalesced ``sync``/``unsync``, ``merge_state``, checkpoints (``persistent``,
``state_dict``, ``load_state_dict``), ``clone``, ``set_dtype``, ``to``, ``plot`` and
``as_pure`` with ``PureCollection.reduce``. The coalesced sync retries under the first
member's ``RetryPolicy`` and validates every synced dict before it commits any.
``state_memory`` and ``telemetry_summary`` report the members' state bytes and their
dispatches in a telemetry session, with the fused members of a compute group pointing
at their leader; a quarantine or a skip and a coalesced sync are recorded there too.

Compute groups: after the first update, metrics whose states are equal (the same names,
reductions and values) share one state dict, and only each group's leader runs
``update``; the other members read the shared dict. ``Metric.reset``, ``Metric.to`` and
a member's own ``unsync`` assign a new dict, so the collection links the members to
their leader's dict again after each of them.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from . import aot as _aot
from . import observability as _observability
from .metric import Metric
from .observability import memory as _obs_memory
from .observability import tracing as _tracing
from .parallel import coalesce as _coalesce
from .parallel import sync as _par_sync
from .parallel.async_sync import AsyncSyncHandle
from .reliability.guards import validate_state
from .utilities.checks import resolve_device
from .utilities.data import _flatten_dict, allclose
from .utilities.exceptions import TorchMetricsUserError
from .utilities.prints import rank_zero_warn

_ON_ERROR_MODES = ("raise", "skip", "quarantine")


@dataclasses.dataclass(frozen=True)
class QuarantinedMetric:
    """The marker ``compute()`` (and ``forward``) gives for a metric that failed under
    ``on_error="quarantine"``, or that failed its compute under ``on_error="skip"``:
    which metric, at which stage, the last error, and how many updates it had taken."""

    name: str
    status: str  # "quarantined" (until reset) or "skipped" (this call only)
    stage: str  # "update", "forward" or "compute"
    error: str  # repr of the exception
    update_count: int

    def __repr__(self) -> str:
        return (
            f"QuarantinedMetric({self.name!r}, status={self.status!r}, stage={self.stage!r}, "
            f"after {self.update_count} updates: {self.error})"
        )


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
    """Dict of metrics with one update/forward/compute/reset. Members are moved to the
    collection's ``device`` (``None`` means ``"cuda"``).

    ``compute_groups``: ``True`` (default) derives groups of metrics with equal states
    after the first update, a list of lists of names fixes them, ``False`` turns them off.

    ``on_error``: ``"raise"`` (default) lets a member's error propagate. ``"skip"``: the
    failing member misses that batch (with a warning), and a compute failure gives a
    :class:`QuarantinedMetric` for that key only. ``"quarantine"``: the failing member is
    frozen at its last good state, split out of its compute group, left out of further
    updates and reported as a :class:`QuarantinedMetric` by ``compute()``; ``reset()``
    lifts it.

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
        >>> collection.compute_groups
        {0: ['acc', 'f1']}
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Mapping[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        on_error: str = "raise",
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.device = resolve_device(device)
        self._modules: "OrderedDict[str, Metric]" = OrderedDict()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._groups: Dict[int, List[str]] = {}
        if on_error not in _ON_ERROR_MODES:
            raise ValueError(f"Expected `on_error` to be one of {_ON_ERROR_MODES}, got {on_error!r}")
        self.on_error = on_error
        self._quarantined: Dict[str, Tuple[str, BaseException]] = {}  # name -> (stage, exception)
        self._degraded = False  # a failure split a group since the last reset
        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Mapping[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Members by name. A mapping's keys are sorted; a key added again replaces its
        member, and a nested collection's members come in as ``{key}_{name}``. A
        sequence's members are named by their class, a nested collection's by their own
        names, and a name taken twice raises. Extra arguments that are not metrics are
        ignored with a warning. Every member moves to the collection's device."""
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passed extra arguments {additional_metrics} which are only valid if input is a sequence."
            )
        if isinstance(metrics, Mapping):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if isinstance(metric, Metric):
                    self._modules[name] = metric.to(self.device)
                elif isinstance(metric, MetricCollection):
                    for k, v in metric.items():
                        self._modules[f"{name}_{k}"] = v.to(self.device)
                else:
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of `Metric` or `MetricCollection`"
                    )
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if isinstance(metric, Metric):
                    named = [(type(metric).__name__, metric)]
                elif isinstance(metric, MetricCollection):
                    named = list(metric.items())
                else:
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not an instance of `Metric` or `MetricCollection`"
                    )
                for name, member in named:
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self._modules[name] = member.to(self.device)
        else:
            raise ValueError("Unknown input to MetricCollection.")
        self._groups_checked = False

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

    # ------------------------------------------------------------ compute groups

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    def _init_compute_groups(self) -> None:
        """One group per metric, or the explicit lists; quarantined metrics join none."""
        if isinstance(self._enable_compute_groups, list):
            for members in self._enable_compute_groups:
                for name in members:
                    if name not in self._modules:
                        raise ValueError(
                            f"Input {name} in `compute_groups` argument does not match a metric in the collection."
                        )
            kept = ([n for n in members if n not in self._quarantined] for members in self._enable_compute_groups)
            self._groups = dict(enumerate(members for members in kept if members))
        elif self._enable_compute_groups:
            self._groups = dict(enumerate([name] for name in self._modules if name not in self._quarantined))
        else:
            self._groups = {}

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """The same state names, reductions, shapes and values (``allclose``)."""
        if not metric1._defaults or not metric2._defaults:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        if {k: str(v) for k, v in metric1._reductions.items()} != {k: str(v) for k, v in metric2._reductions.items()}:
            return False
        for key in metric1._defaults:
            s1, s2 = metric1._state[key], metric2._state[key]
            if isinstance(s1, list) != isinstance(s2, list):
                return False
            pairs = list(zip(s1, s2)) if isinstance(s1, list) else [(s1, s2)]
            if isinstance(s1, list) and len(s1) != len(s2):
                return False
            if not all(a.shape == b.shape and allclose(a, b) for a, b in pairs):
                return False
        return True

    def _merge_compute_groups(self) -> None:
        """Merge groups pairwise while two leaders have equal states."""
        merged = True
        while merged:
            merged = False
            ids = list(self._groups)
            for i, first in enumerate(ids):
                for second in ids[i + 1:]:
                    leader1 = self._modules[self._groups[first][0]]
                    leader2 = self._modules[self._groups[second][0]]
                    if self._equal_metric_states(leader1, leader2):
                        self._groups[first].extend(self._groups.pop(second))
                        merged = True
                        break
                if merged:
                    break
        self._groups = dict(enumerate(self._groups.values()))

    def _compute_groups_create_state_ref(self) -> None:
        """Members alias their leader's state dict."""
        for members in self._groups.values():
            leader = self._modules[members[0]]
            for name in members[1:]:
                self._modules[name]._state = leader._state

    def _relink_groups(self) -> None:
        if self._groups_checked and self._groups:
            self._compute_groups_create_state_ref()

    def _derive_groups(self) -> None:
        """After the first clean batch: form the groups and alias their states."""
        if self._enable_compute_groups and not self._groups_checked:
            self._init_compute_groups()
            if not isinstance(self._enable_compute_groups, list):
                self._merge_compute_groups()
            self._compute_groups_create_state_ref()
        self._groups_checked = True

    # ----------------------------------------------------------- on_error

    @property
    def quarantined(self) -> Dict[str, BaseException]:
        """The quarantined metrics: name -> last exception (empty when healthy)."""
        return {name: exc for name, (_, exc) in self._quarantined.items()}

    def _status_marker(self, name: str) -> QuarantinedMetric:
        stage, exc = self._quarantined[name]
        return QuarantinedMetric(name, "quarantined", stage, repr(exc), self._modules[name]._update_count)

    def _failure_marker(self, name: str, stage: str, exc: BaseException) -> QuarantinedMetric:
        status = "quarantined" if name in self._quarantined else "skipped"
        return QuarantinedMetric(name, status, stage, repr(exc), self._modules[name]._update_count)

    @staticmethod
    def _state_backup(metric: Metric) -> Dict[str, Any]:
        """Value copies of a metric's tensor states and copies of its lists' containers
        (so a failed batch's appends can be rolled back)."""
        return {k: list(v) if isinstance(v, list) else v.clone() for k, v in metric._state.items()}

    @staticmethod
    def _state_restore(metric: Metric, backup: Dict[str, Any]) -> None:
        """Roll a metric back to a backup in place: group members alias the dict."""
        metric._state.clear()
        metric._state.update(backup)
        metric._computed = None

    def _detach_from_group(self, name: str) -> None:
        """Split ``name`` out of its compute group with a state dict of its own."""
        metric = self._modules[name]
        metric._state = self._state_backup(metric)
        metric._computed = None
        for gid, members in list(self._groups.items()):
            if name in members:
                members.remove(name)
                if not members:
                    del self._groups[gid]
                break

    def _handle_metric_error(self, name: str, exc: BaseException, stage: str) -> None:
        """Degrade by the policy (never called under ``on_error="raise"``)."""
        self._detach_from_group(name)
        self._degraded = True
        rec = _observability._ACTIVE
        if rec is not None:
            # the degradation lands in the telemetry stream when it is decided, not
            # only as a marker in a later compute()
            rec.record_quarantine(
                name, stage, "quarantined" if self.on_error == "quarantine" else "skipped",
                exc, self._modules[name]._update_count,
            )
        if self.on_error == "quarantine":
            self._quarantined[name] = (stage, exc)
            rank_zero_warn(
                f"Metric {name!r} failed during {stage} and was quarantined "
                f"(on_error='quarantine'); the rest of the collection continues: {exc!r}",
                UserWarning,
            )
        else:  # skip: misses this batch only and goes on as a group of its own
            if self._groups_checked and self._enable_compute_groups:
                self._groups[max(self._groups, default=-1) + 1] = [name]
            rank_zero_warn(
                f"Metric {name!r} failed during {stage} and was skipped for this batch (on_error='skip'): {exc!r}",
                UserWarning,
            )

    def _attempt(self, name: str, stage: str, call):
        """``call()`` under the policy: the metric's error propagates under "raise";
        otherwise its state rolls back, the policy degrades it, and this returns
        ``(False, marker)``. Returns ``(True, value)`` on success."""
        if self.on_error == "raise":
            return True, call()
        metric = self._modules[name]
        backup = self._state_backup(metric)
        try:
            return True, call()
        except Exception as exc:  # noqa: BLE001 -- the policy decides
            self._state_restore(metric, backup)
            self._handle_metric_error(name, exc, stage)
            return False, self._failure_marker(name, stage, exc)

    # --------------------------------------------------------------- lifecycle

    def _run_group(self, members: List[str], res: Optional[Dict[str, Any]], args: tuple, kwargs: dict) -> None:
        """One compute group: the leader updates (``res is None``) or forwards; members
        take its count and, in ``forward``, their value from its batch state. When the
        leader fails under a degrading policy, the next member leads this batch."""
        stage = "update" if res is None else "forward"
        while members:
            name = members[0]
            leader = self._modules[name]
            run = leader.update if res is None else leader.forward
            ok, value = self._attempt(name, stage, lambda: run(*args, **leader._filter_kwargs(**kwargs)))
            if res is not None:
                res[name] = value
            if not ok:
                continue
            for mname in list(members[1:]):
                member = self._modules[mname]
                # the shared state already holds this batch: take the count first, or
                # count-weighted ("mean") states would skew after a detach
                member._update_count = leader._update_count
                member._computed = None
                if res is not None:
                    res[mname] = self._attempt(mname, stage, lambda: member._compute(leader._last_batch_state))[1]
            return

    def _run(self, res: Optional[Dict[str, Any]], args: tuple, kwargs: dict) -> None:
        """``update`` (``res is None``) or ``forward`` over the collection."""
        if self._groups_checked and self._groups:
            for members in list(self._groups.values()):
                self._run_group(members, res, args, kwargs)
            return
        failed = False
        stage = "update" if res is None else "forward"
        for name, metric in list(self._modules.items()):
            if name in self._quarantined:
                if res is not None:
                    res[name] = self._status_marker(name)
                continue
            run = metric.update if res is None else metric.forward
            ok, value = self._attempt(name, stage, lambda: run(*args, **metric._filter_kwargs(**kwargs)))
            failed = failed or not ok
            if res is not None:
                res[name] = value
        # a batch with a rolled-back metric must not seed the groups: its default
        # states would look equal to any other metric's
        if not (failed and not self._groups_checked):
            self._derive_groups()

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Fold one batch into every metric (only group leaders run)."""
        self._run(None, args, kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Every metric's value on this batch, with the batch folded into the states."""
        res: Dict[str, Any] = {}
        self._run(res, args, kwargs)
        for name in self._quarantined:
            res.setdefault(name, self._status_marker(name))
        return _flatten_with_naming({name: res[name] for name in self._modules if name in res}, self._set_name)

    __call__ = forward

    def compute(self) -> Dict[str, Any]:
        # coalesced pre-sync: every member that would sync inside its own compute()
        # syncs here, through one bucketed collective set instead of one sync per
        # member (members see _is_synced and skip theirs); unsync restores them after
        presynced = self._presync_for_compute()
        try:
            res: Dict[str, Any] = {}
            for name, metric in self._modules.items():
                if name in self._quarantined:
                    res[name] = self._status_marker(name)
                else:
                    res[name] = self._attempt(name, "compute", metric.compute)[1]
        finally:
            for metric in presynced:
                if metric._is_synced:
                    metric.unsync()
            self._relink_groups()  # a member's own sync and unsync replace its dict
        return _flatten_with_naming(res, self._set_name)

    def _presync_for_compute(self) -> List[Metric]:
        """Coalesce the ``sync_on_compute`` syncs of all members into one bucketed
        sync, under ``on_error="raise"`` only (the degrading policies attribute a failure
        to one member, which a shared collective cannot); where the fast path cannot
        serve them, members sync themselves inside ``compute()``. Returns the members
        this call synced."""
        if self.on_error != "raise":
            return []
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
        if self._quarantined or self._degraded:
            # lift the quarantine and forget the failure-driven splits: the groups
            # derive again on the next update, each metric on a dict of its own
            self._quarantined.clear()
            self._degraded = False
            self._groups = {}
            self._groups_checked = False
        else:
            self._relink_groups()

    # -------------------------------------------------------------------- sync

    def sync(self, async_: bool = False, sync_config: Optional[Any] = None, **kwargs: Any) -> Any:
        """Sync every member across processes. Fast path: the states coalesce into one
        bucketed collective set (one metadata all-gather and one padded all-gather per
        dtype, in place of two collectives per leaf), and the members of a compute group,
        who share one state dict, ship it once. Members that disagree on the gather seam
        (``dist_sync_fn``, ``process_group``, availability) or override ``sync`` are
        synced one by one with ``Metric.sync``. ``kwargs`` are ``Metric.sync``'s.

        ``async_=True`` returns an
        :class:`~torchmetrics_tpu_torch.parallel.AsyncSyncHandle` instead of blocking:
        the bucketed gather of the current states runs in the background while the
        collection keeps updating; ``handle.commit()`` waits, validates and swaps every
        member to the synced state, the live (since updated) state parks in the sync
        cache and ``unsync()`` restores it. A failed gather commits nothing.

        ``sync_config`` (:class:`~torchmetrics_tpu_torch.parallel.SyncConfig`) opts the
        coalesced sync (blocking or async) into the quantized (bf16/int8) buckets; use
        one config instance per collection across repeated syncs so its error-feedback
        residuals fold correctly. The per-member fallback is always exact."""
        if async_:
            return self._async_sync(sync_config=sync_config, **kwargs)
        if self._coalesced_sync(list(self._modules.values()), sync_config=sync_config, **kwargs):
            return None
        for metric in self._modules.values():
            metric.sync(**kwargs)
        return None

    def _async_sync(
        self,
        dist_sync_fn: Optional[Any] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Any] = None,
        rebuffer: bool = True,
        sync_config: Optional[Any] = None,
    ) -> AsyncSyncHandle:
        """Launch the double-buffered background sync (``sync(async_=True)``).

        The freeze is a shallow snapshot of each distinct state dict. Under
        ``rebuffer=True`` (the default) the live entries are replaced by clones, so the
        in-flight gather owns the frozen tensors alone and an update's in-place fold
        cannot race it; a caller that rotates its state itself (``reset()`` right after
        the launch) may pass ``rebuffer=False``. Mixed gather seams or a member that
        overrides ``sync`` raise: a background per-member sync could not keep their
        semantics.

        ``commit()``: wait, validate every member's synced state (nothing installs on a
        corrupt contribution or a failed gather), then swap atomically: each member's
        live state becomes its sync cache, the synced state its ``_state``; compute
        groups keep aliasing through the swap."""
        metrics = list(self._modules.values())
        if any(m._is_synced for m in metrics):
            raise TorchMetricsUserError("The Metric has already been synced.")
        fns = {id(dist_sync_fn or m.dist_sync_fn) for m in metrics}
        groups = {id(process_group or m.process_group) for m in metrics}
        if len(fns) > 1 or len(groups) > 1 or any(type(m).sync is not Metric.sync for m in metrics):
            raise TorchMetricsUserError(
                "sync(async_=True) requires uniform gather seams and the default Metric.sync "
                "across members; use the blocking sync() for mixed collections."
            )
        avails = {bool((distributed_available or m.distributed_available_fn)()) for m in metrics}
        if len(avails) > 1:
            raise TorchMetricsUserError("sync(async_=True) requires members to agree on distributed availability.")
        if not should_sync or not metrics or not avails.pop():
            return AsyncSyncHandle.noop(label="MetricCollection.sync")
        # compute-group members alias one state dict: freeze each distinct dict once
        holders: "OrderedDict[int, List[Metric]]" = OrderedDict()
        for m in metrics:
            holders.setdefault(id(m._state), []).append(m)
        frozen: List[Dict[str, Any]] = []
        for members_of in holders.values():
            live = members_of[0]._state
            fro: Dict[str, Any] = {}
            for name, v in list(live.items()):
                if isinstance(v, list):
                    fro[name] = list(v)  # appends to the live list must not reach the gather
                else:
                    fro[name] = v
                    if rebuffer:
                        live[name] = v.clone()  # the live side re-buffered; the frozen owns the original
            frozen.append(fro)
        retry = next((m._reliability.retry for m in metrics
                      if m._reliability is not None and m._reliability.retry is not None), None)

        def committer(synced: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
            # validate before committing anything, as the blocking coalesced sync does
            for members_of, state in zip(holders.values(), synced):
                validators = [m for m in members_of if m._reliability is not None and m._reliability.validate_on_sync]
                if validators:
                    validate_state(validators[0], state, context=f"{type(validators[0]).__name__}.sync",
                                   check_finite=any(m._reliability.check_finite for m in validators))
            # the current (overlap-updated) state parks in the cache; unsync restores it
            for (holder, *aliased), state in zip(holders.values(), synced):
                holder._commit_synced(state)
                for m in aliased:
                    m._cache, m._state, m._is_synced = holder._cache, holder._state, True
            return synced

        return AsyncSyncHandle(
            frozen, [ms[0]._reductions for ms in holders.values()],
            process_group=process_group or metrics[0].process_group,
            dist_sync_fn=dist_sync_fn or metrics[0].dist_sync_fn,
            retry=retry, committer=committer, label="MetricCollection.sync", sync_config=sync_config,
        )

    def _coalesced_sync(
        self,
        metrics: List[Metric],
        dist_sync_fn: Optional[Any] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Any] = None,
        sync_config: Optional[Any] = None,
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
        # compute-group members alias one state dict: gather each distinct dict once
        # (plain lists keyed by id: Metric.__eq__ builds a CompositionalMetric)
        holders: "OrderedDict[int, List[Metric]]" = OrderedDict()
        for m in metrics:
            holders.setdefault(id(m._state), []).append(m)

        rec = _observability._ACTIVE
        t0 = _tracing.monotonic() if rec is not None else 0.0
        bytes_total = sum(_par_sync._payload_bytes(ms[0]._state) for ms in holders.values())
        coll0 = rec.counters.value("sync_collectives") if rec is not None else 0
        coal0 = rec.counters.value("gathers_coalesced") if rec is not None else 0

        def attempt() -> List[Dict[str, Any]]:
            return _coalesce.coalesced_process_sync(
                [ms[0]._state for ms in holders.values()], [ms[0]._reductions for ms in holders.values()],
                process_group=process_group or metrics[0].process_group,
                dist_sync_fn=dist_sync_fn or metrics[0].dist_sync_fn,
                sync_config=sync_config,
            )

        def count_attempt(exc: BaseException, attempt_no: int) -> None:
            # a failed attempt still entered the sync plane: counted as process_sync counts
            if rec is not None:
                rec.counters.record_sync(bytes_total)

        # the first member's policy that has one retries the whole coalesced sync
        retry = next((m._reliability.retry for m in metrics
                      if m._reliability is not None and m._reliability.retry is not None), None)
        with _tracing.trace_span("MetricCollection.sync"):
            try:
                synced = attempt() if retry is None else retry.call(
                    attempt, on_retry=count_attempt, describe="MetricCollection.sync")
            except _coalesce.CoalesceFallback:
                # nothing committed and nothing recorded: the per-member path records
                # its own syncs
                return False
        if rec is not None:  # the successful attempt is one sync entry
            rec.counters.record_sync(bytes_total)
        # validate every distinct dict before committing any: a corrupt contribution must
        # not become any member's state, and a partial commit must never happen. Fused
        # members share one dict and one validation (fusion requires equal defaults and
        # reductions): each dict is scanned once, with the strictest finiteness setting
        # among its members
        for members_of, state in zip(holders.values(), synced):
            validators = [m for m in members_of if m._reliability is not None and m._reliability.validate_on_sync]
            if validators:
                validate_state(validators[0], state, context=f"{type(validators[0]).__name__}.sync",
                               check_finite=any(m._reliability.check_finite for m in validators))
        # atomic commit, one synced dict and one shared cache per distinct dict: members
        # keep aliasing through sync and unsync
        for (holder, *aliased), state in zip(holders.values(), synced):
            holder._commit_synced(state)
            for m in aliased:
                m._cache, m._state, m._is_synced = holder._cache, holder._state, True
        if rec is not None:
            rec.record_sync(
                self, rec.finish(synced, t0, self.device), bytes_total,
                collectives=rec.counters.value("sync_collectives") - coll0,
                coalesced_leaves=rec.counters.value("gathers_coalesced") - coal0,
            )
        return True

    def unsync(self, **kwargs: Any) -> None:
        """Restore every member's local states (``Metric.unsync``'s ``kwargs``)."""
        for metric in self._modules.values():
            metric.unsync(**kwargs)
        self._relink_groups()

    def merge_state(self, incoming: "MetricCollection") -> None:
        """Fold another collection's states into this one, member by member, without
        communication. Each compute group folds once, through its first member healthy
        on both sides, and its members alias the result; quarantined metrics do not fold."""
        if not isinstance(incoming, MetricCollection):
            raise ValueError(f"Expected a MetricCollection, got {type(incoming).__name__}")
        mine, theirs = dict(self._modules), dict(incoming._modules)
        if set(mine) != set(theirs):
            raise ValueError(f"Cannot merge collections with different metrics: {sorted(set(mine) ^ set(theirs))}")
        frozen = set(self._quarantined) | set(incoming._quarantined)
        if frozen:
            rank_zero_warn(
                f"merge_state skipping quarantined metrics {sorted(frozen)}: their states are "
                "frozen at the last good value and must not fold.",
                UserWarning,
            )
        grouped = set()
        if self._groups_checked and self._groups:
            for members in self._groups.values():
                grouped.update(members)
                live = [n for n in members if n not in frozen]
                if not live:
                    rank_zero_warn(
                        f"merge_state: compute group {members} has no member healthy on "
                        "both sides; the incoming contribution of this group is dropped.",
                        UserWarning,
                    )
                    continue
                leader = mine[live[0]]
                leader.merge_state(theirs[live[0]])
                for name in members:
                    if name != live[0]:
                        mine[name]._state, mine[name]._update_count = leader._state, leader._update_count
                        mine[name]._computed = None
        for name, metric in mine.items():
            if name not in grouped and name not in frozen:
                metric.merge_state(theirs[name])

    # ------------------------------------------------------------ observability

    # ------------------------------------------------------- warm start (aot/)

    def precompile(
        self,
        *example_inputs: Any,
        tags: Sequence[str] = ("update",),
        cache_dir: Optional[str] = None,
        force: bool = False,
        prefetch_workers: int = 8,
        **example_kwargs: Any,
    ) -> Dict[str, Any]:
        """Warm-start the whole collection: export and compile every member's dispatch
        program(s) for the example input shapes and publish them into the AOT cache
        (``torchmetrics_tpu_torch.aot``).

        Every member precompiles individually — on a fresh boot the first real batch
        dispatches each member once before compute groups derive, so per-member entries
        are exactly what that first batch loads. Heterogeneous collections reuse the
        update path's kwarg filtering; quarantined members are skipped. Returns
        ``{member: {tag: row}}``.

        Members whose entries were already cached (status ``"cached"``) are also
        **prefetched**: their programs load NOW, on a ``prefetch_workers``-wide thread
        pool, into each member's dispatch memo. The ``"_prefetch"`` report row carries
        the overlap: ``serial_load_s`` (sum of individual loads) against ``wall_s``
        (what the pool took). ``prefetch_workers=0`` disables it; an explicit
        ``cache_dir`` skips it too (the one-off plane is not the one traffic will
        dispatch against).
        """
        report: Dict[str, Any] = {}
        for name, metric in self._modules.items():
            if name in self._quarantined:
                report[name] = {"status": "skipped", "reason": "quarantined"}
                continue
            report[name] = metric.precompile(
                *example_inputs, tags=tags, cache_dir=cache_dir, force=force,
                **metric._filter_kwargs(**example_kwargs),
            )
        if prefetch_workers and cache_dir is None and _aot._ACTIVE is not None:
            prefetch = self._prefetch_members(report, example_inputs, example_kwargs, tags, prefetch_workers)
            if prefetch is not None:  # only when cached entries actually loaded
                report["_prefetch"] = prefetch
        return report

    def _prefetch_members(
        self,
        report: Dict[str, Any],
        example_inputs: tuple,
        example_kwargs: Dict[str, Any],
        tags: Sequence[str],
        workers: int,
    ) -> Optional[Dict[str, Any]]:
        """Load the members' already-cached entries concurrently (each thread touches
        only its own member's memo; the plane's stats are lock-guarded). Freshly
        ``"written"`` members are already primed by the precompile and skip the pool."""
        import concurrent.futures

        def cached_tags(row: Any) -> List[str]:
            if not isinstance(row, dict):
                return []
            return [tag for tag in tags if isinstance(row.get(tag), dict) and row[tag].get("status") == "cached"]

        todo = [(name, self._modules[name], cached_tags(row)) for name, row in report.items()
                if name in self._modules and cached_tags(row)]
        if not todo:
            return None

        def one(item):
            name, metric, member_tags = item
            try:
                return name, metric.prefetch_compiled(
                    *example_inputs, tags=tuple(member_tags), **metric._filter_kwargs(**example_kwargs),
                )
            except Exception as err:  # noqa: BLE001 — prefetch must never fail a boot
                return name, {"error": f"{type(err).__name__}: {err}"[:200]}

        t0 = _tracing.monotonic()
        with concurrent.futures.ThreadPoolExecutor(max_workers=min(workers, len(todo))) as pool:
            rows = dict(pool.map(one, todo))
        wall = _tracing.monotonic() - t0
        loaded = [r for row in rows.values() if isinstance(row, dict)
                  for r in row.values() if isinstance(r, dict) and r.get("status") == "loaded"]
        serial = sum(r.get("load_s", 0.0) for r in loaded)
        return {
            "workers": min(workers, len(todo)),
            "loaded": len(loaded),
            "wall_s": round(wall, 6),
            "serial_load_s": round(serial, 6),
            "overlap_x": round(serial / wall, 2) if wall > 0 and serial > 0 else None,
            "members": rows,
        }

    def state_memory(self) -> Dict[str, Any]:
        """Per-member state-memory footprint (tensor metadata only, no device read).

        Fused compute-group members alias their leader's state dict, so a per-member sum
        would charge one buffer once per member: aliased members report their bytes but
        carry an ``aliased_to`` pointer, and only the first holder of each distinct
        state dict counts toward ``total_bytes``, the bytes that live on the device.
        """
        members: Dict[str, Any] = {}
        seen: Dict[int, str] = {}
        total = 0
        for name, metric in self._modules.items():
            report = _obs_memory.state_memory(metric._state)
            holder = seen.get(id(metric._state))
            if holder is not None:
                report["aliased_to"] = holder
            else:
                seen[id(metric._state)] = name
                total += report["total_bytes"]
            members[name] = report
        return {"members": members, "total_bytes": total}

    def telemetry_summary(self) -> Dict[str, Any]:
        """Per-member dispatch attribution from the active telemetry session.

        A fused compute group dispatches once, through its leader: the other members
        show no dispatches of their own after the fusion and a ``fused_into`` pointer to
        the leader. Quarantined members carry their status. ``{"enabled": False}`` when
        no session is active.
        """
        rec = _observability.active()
        if rec is None:
            return {"enabled": False}
        groups = {gid: list(m) for gid, m in self._groups.items()} if self._groups_checked else {}
        leader_of = {name: members[0] for members in groups.values() for name in members[1:]}
        mem = self.state_memory()
        members_out: Dict[str, Any] = {}
        for name, metric in self._modules.items():
            info = rec.metric_summary(metric)
            latency = rec.metric_latency(metric)
            if latency:  # per-stage p50/p99 from the session's histograms
                info["latency_us"] = latency
            if name in leader_of:
                info["fused_into"] = leader_of[name]
            if name in self._quarantined:
                stage, _ = self._quarantined[name]
                info["status"] = "quarantined"
                info["quarantine_stage"] = stage
            info["state_bytes"] = mem["members"][name]["total_bytes"]
            members_out[name] = info
        return {
            "enabled": True,
            "members": members_out,
            "compute_groups": groups,
            "counters": rec.counters.snapshot().summary(brief=True),
            "state_memory_bytes": mem["total_bytes"],
        }

    # ------------------------------------------------------ copies and checkpoints

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """An independent copy, optionally with a new prefix or postfix."""
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def __deepcopy__(self, memo: dict) -> "MetricCollection":
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            setattr(new, k, deepcopy(v, memo))
        new._relink_groups()  # members copy their states apart: alias them again in the copy
        return new

    def persistent(self, mode: bool = True) -> None:
        for metric in self._modules.values():
            metric.persistent(mode)

    def state_dict(self) -> Dict[str, Any]:
        """Every member's ``state_dict`` under the prefix ``"<name>."``."""
        out: Dict[str, Any] = {}
        for name, metric in self._modules.items():
            metric.state_dict(out, prefix=f"{name}.")
        return out

    def load_state_dict(self, state_dict: Dict[str, Any], validate: bool = True) -> None:
        """Every member's ``load_state_dict`` from its ``"<name>."`` slice, each slice
        held to the checkpoint guard first under ``validate``."""
        for name, metric in self._modules.items():
            metric.load_state_dict(state_dict, prefix=f"{name}.", validate=validate)

    def set_dtype(self, dst_type: torch.dtype) -> "MetricCollection":
        for metric in self._modules.values():
            metric.set_dtype(dst_type)
        return self

    def to(self, device: Union[str, torch.device]) -> "MetricCollection":
        """Move every member to ``device`` (in place); returns ``self``."""
        self.device = resolve_device(device)
        for metric in self._modules.values():
            metric.to(self.device)
        self._relink_groups()
        return self

    def plot(self, val: Optional[Dict[str, Any]] = None, ax: Any = None, together: bool = False) -> list:
        """One figure per member's value (``val``, or ``compute()``), or one for all of
        them with ``together``. Needs matplotlib."""
        from .utilities.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        if together:
            return [plot_single_or_multi_val(val, ax=ax)]
        return [plot_single_or_multi_val({k: v}, ax=ax) for k, v in val.items()]

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
