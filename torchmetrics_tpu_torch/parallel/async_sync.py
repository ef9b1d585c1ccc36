"""Double-buffered asynchronous state synchronization (counterpart of
``torchmetrics_tpu/parallel/async_sync.py``).

The blocking sync planes are serial with updates: the caller waits for the collective
set before it touches its metrics again. Monitoring traffic has another shape: the
previous window's state is frozen while the current window keeps accumulating, so the
frozen buffers can ship in the background while the update loop runs, and only the
residual wait is paid at the commit barrier.

:class:`AsyncSyncHandle` is that overlap as an object:

- **launch** (construction): a daemon thread runs the same coalesced bucketed gather
  as the blocking planes (``coalesce.coalesced_process_sync``: one metadata
  all-gather and one padded all-gather per dtype bucket), with the per-leaf plane as
  its fallback when the gathered metadata cannot be decoded (``CoalesceFallback``) and
  the caller's ``RetryPolicy`` over transient gather failures;
- **overlap**: the caller keeps updating. The frozen snapshot is a shallow copy of each
  dict; the caller keeps the frozen tensors exclusively owned by the gather (by
  rotating its live state, or by re-buffering the live side as
  ``MetricCollection.sync(async_=True)`` does), since an update that wrote into a
  frozen tensor in place would race the gather;
- **commit** (the barrier): waits for the thread, re-raises its failure with nothing
  installed, runs the caller's ``committer`` (which validates before it installs) and
  records the overlap: the gather's wall time against the time ``commit`` blocked
  (the ``async_sync`` event, ``async_syncs``/``async_sync_wait_us`` counters).

On the card the thread's collectives run on NCCL's stream and its bucket copies on the
device's current stream, beside the caller's updates, which write only the live side.
With a ``sync_config`` the thread also quantizes the frozen buckets, so the codec's cost
overlaps the updates as the gather's latency does.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

from .. import observability as _observability
from ..observability import spans as _obs_spans
from ..utilities.exceptions import TorchMetricsUserError
from . import coalesce as _coalesce
from . import sync as _sync

StateDict = Dict[str, Any]
Reduction = Union[str, Callable, None]


class AsyncSyncHandle:
    """One in-flight background sync of frozen state dicts.

    Args:
        states: the frozen state dicts (each dict is copied shallowly, so the caller
            may keep changing its own containers; the captured tensors must stay
            exclusively owned by the gather, see the module docstring).
        reductions: one reduction mapping per state dict.
        process_group / dist_sync_fn: the usual gather seams.
        retry: an optional :class:`~torchmetrics_tpu_torch.reliability.RetryPolicy`
            over the whole gather attempt (the per-leaf fallback is taken inside each
            attempt, as in the blocking plane).
        committer: called under :meth:`commit` with the synced state list: where
            ``MetricCollection`` validates and installs atomically. Its exceptions
            propagate from ``commit()`` with nothing recorded as committed.
        label: telemetry identity for the ``async_sync`` event.
        noop: build an already-completed empty handle (nothing to sync).
        sync_config: an optional :class:`~torchmetrics_tpu_torch.parallel.SyncConfig`:
            the worker quantizes the frozen buckets in the background. Its residuals
            commit from the worker only after every bucket gathered; a failed or
            per-leaf-fallback attempt leaves them untouched.
    """

    def __init__(
        self,
        states: Sequence[StateDict],
        reductions: Sequence[Mapping[str, Reduction]],
        process_group: Any = None,
        dist_sync_fn: Optional[Callable] = None,
        retry: Any = None,
        committer: Optional[Callable[[List[StateDict]], Any]] = None,
        label: str = "AsyncSyncHandle",
        noop: bool = False,
        sync_config: Optional[Any] = None,
    ) -> None:
        self.label = label
        self._sync_config = sync_config
        self._committer = committer
        self._states = [{k: (list(v) if isinstance(v, list) else v) for k, v in s.items()} for s in states]
        self._reductions = [dict(r) for r in reductions]
        self._process_group = process_group
        self._dist_sync_fn = dist_sync_fn
        self._retry = retry
        self._result: Optional[List[StateDict]] = None
        self._error: Optional[BaseException] = None
        self._gather_s = 0.0
        self._wait_s = 0.0
        self._collectives = 0
        self._fallback = False
        self._dead_ranks: Dict[int, int] = {}
        self._committed = False
        # the span active when the sync was launched: commit() may run much later, and
        # the async_sync event still belongs to the trace that started it
        self._trace = _obs_spans.current() if _observability._ACTIVE is not None else None
        self._done = threading.Event()
        self._payload_bytes = sum(_sync._payload_bytes(s) for s in self._states)
        if noop:
            self._result = []
            self._states = []
            self._done.set()
            self._thread = None
            return
        self._thread = threading.Thread(target=self._work, name=f"tm-async-sync:{label}", daemon=True)
        self._thread.start()

    # ----------------------------------------------------------------- worker

    def _attempt(self) -> List[StateDict]:
        try:
            return _coalesce.coalesced_process_sync(
                self._states, self._reductions, process_group=self._process_group,
                dist_sync_fn=self._dist_sync_fn, sync_config=self._sync_config,
            )
        except _coalesce.CoalesceFallback:
            # every rank decodes the same gathered metadata, so a fleet falls back together
            self._fallback = True
            return [
                _sync._process_sync_per_leaf(s, r, self._process_group, self._dist_sync_fn)
                for s, r in zip(self._states, self._reductions)
            ]

    def _work(self) -> None:
        rec = _observability._ACTIVE
        coll0 = rec.counters.value("sync_collectives") if rec is not None else 0
        t0 = time.perf_counter()
        try:
            if self._retry is None:
                self._result = self._attempt()
            else:
                self._result = self._retry.call(self._attempt, describe=self.label)
            # non-empty: this gather completed over a survivor quorum (degraded)
            self._dead_ranks = _coalesce.dead_ranks()
            if rec is not None:
                rec.counters.record_sync(self._payload_bytes)  # one sync entry, as the blocking planes
                self._collectives = rec.counters.value("sync_collectives") - coll0
        except BaseException as err:  # noqa: BLE001 — re-raised at commit()
            self._error = err
        finally:
            self._gather_s = time.perf_counter() - t0
            self._done.set()

    # ------------------------------------------------------------------- API

    @classmethod
    def noop(cls, label: str = "AsyncSyncHandle") -> "AsyncSyncHandle":
        """An already-completed empty handle (nothing to sync), so call sites stay
        uniform."""
        return cls([], [], label=label, noop=True)

    @property
    def done(self) -> bool:
        """Whether the background gather finished (success or failure)."""
        return self._done.is_set()

    @property
    def committed(self) -> bool:
        return self._committed

    @property
    def overlap_pct(self) -> float:
        """How much of the gather's wall time the overlap hid (after :meth:`commit`):
        100% means commit never blocked."""
        if self._gather_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self._wait_s / self._gather_s) * 100.0

    @property
    def gather_s(self) -> float:
        return self._gather_s

    @property
    def wait_s(self) -> float:
        return self._wait_s

    @property
    def used_fallback(self) -> bool:
        return self._fallback

    @property
    def degraded(self) -> bool:
        """Whether the gather completed over a survivor quorum (dead ranks in the
        ledger when it ran)."""
        return bool(self._dead_ranks)

    @property
    def dead_ranks(self) -> Dict[int, int]:
        """Rank -> consecutive degraded syncs, as the ledger read at gather time."""
        return dict(self._dead_ranks)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the background gather finishes (no install)."""
        return self._done.wait(timeout)

    def result(self) -> List[StateDict]:
        """The synced state dicts (blocks; raises the thread's failure)."""
        self._done.wait()
        if self._error is not None:
            raise self._error
        return self._result

    def commit(self) -> Any:
        """Barrier, validate, atomic install.

        Waits for the gather, re-raises its failure with nothing installed, then runs
        the committer (which validates before installing) and returns its result (the
        synced state list when there is no committer). Telemetry records the overlap on
        success. One-shot on success only: a failed commit leaves the handle
        uncommitted, and a second call re-raises the real error (or runs again a
        committer that rejected the states).
        """
        if self._committed:
            raise TorchMetricsUserError(f"{self.label}: commit() already ran for this handle.")
        t0 = time.perf_counter()
        self._done.wait()
        self._wait_s = time.perf_counter() - t0
        if self._error is not None:
            raise self._error
        out = self._committer(self._result) if self._committer is not None else self._result
        self._committed = True
        rec = _observability._ACTIVE
        if rec is not None and self._states:
            ctx = _obs_spans.enter("commit", self.label, parent=self._trace) if self._trace is not None else None
            try:
                rec.record_async_sync(
                    self.label, self._gather_s, self._wait_s, self._payload_bytes,
                    collectives=self._collectives, fallback=self._fallback,
                )
            finally:
                if ctx is not None:
                    _obs_spans.exit(ctx)
        return out
