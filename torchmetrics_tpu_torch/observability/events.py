"""Structured telemetry events and pluggable sinks.

One event per observable runtime moment — a jitted dispatch, a compute, a
cross-process sync, a retry, a quarantine, a retrace, an instrumented
device→host readback. Timestamps are **monotonic-clock** (``time.monotonic``):
telemetry orders and measures, it does not tell wall-clock time (a trace
consumer that needs an epoch anchor records one itself at session start).

Sinks are deliberately tiny: ``emit(event)`` plus optional ``close()``. The
runtime never constructs an event unless a telemetry session is active, so a
slow sink can only ever tax an opted-in process.

Everything here is stdlib-only; ``tools/trace_report.py`` re-reads the JSONL
output without importing torch.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import socket
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

# the closed set of event kinds the runtime emits
EVENT_KINDS: Tuple[str, ...] = (
    "dispatch",  # a jitted (or HostMetric eager) update/forward dispatch
    "compute",  # Metric.compute
    "sync",  # Metric.sync through process_sync
    "retry",  # a transient failure accepted for retry
    "retry_exhausted",  # retry budget ran out on a transient failure
    "quarantine",  # MetricCollection froze/skipped a failing member
    "retrace",  # a dispatch key saw a NEW shape/dtype signature (recompile)
    "aot_load",  # a serialized executable was loaded from the AOT cache (aot/)
    "d2h",  # an instrumented device→host readback
    "state_growth",  # a list/cat state crossed the unbounded-growth threshold
    "alert",  # an SLO rule breached (or errored) — observability/slo.py
    "hist",  # a latency/size histogram snapshot (flushed at session close)
    "serve",  # a megabatched stacked-state dispatch (serving engine)
    "tenant_spill",  # tenant state spilled to host / readmitted into a stack
    "window_roll",  # a SlidingWindow completed a full window wrap (streaming plane)
    "async_sync",  # a double-buffered background sync committed (overlap accounting)
    "serve_rejected",  # a tenant batch shed by the serving admission rate limit
    "quant",  # a coalesced sync shipped quantized buckets (compression accounting)
    "snapshot",  # a crash-consistent engine snapshot written or restored (durability plane)
    "journal",  # write-ahead journal records replayed into a restored engine
    "degraded_sync",  # a coalesced sync completed over a survivor quorum (dead rank)
    "rank_rejoin",  # a previously dead rank reconciled back into the coalesced sync
    "migration",  # a committed host-to-host tenant migration (fleet plane)
    "failover",  # a dead host's tenants adopted by survivors (fleet plane)
    "flightrec",  # the flight recorder dumped a postmortem artifact
    "history",  # the telemetry history telescoped retained blocks (timeseries plane)
    "burn_alert",  # a multi-window burn-rate rule paged (short AND long window burned)
)


@dataclasses.dataclass(frozen=True)
class TelemetryEvent:
    """One structured telemetry record.

    Args:
        kind: one of :data:`EVENT_KINDS`.
        metric: metric identity — ``ClassName#instance_id`` for runtime events,
            a collection key for quarantine events, a ``describe`` string for
            retry events.
        tag: dispatch tag / stage (``update``/``forward``/``compute``/``sync``,
            or a site name for ``d2h``).
        timestamp: ``time.monotonic()`` at emission.
        duration_s: measured span for dispatch/compute/sync events (honest
            wall-clock only under the blocking-timing mode — async dispatch
            returns before the device finishes).
        signature: the input shape/dtype key for dispatch/retrace events.
        cache_hit: for dispatch events — False on the signature's first sight.
        trace_id / span_id / parent_id: causal trace linkage (deterministic
            sha256-derived ids from ``observability/spans.py``) — stamped by
            the recorder when a span is active, ``None`` otherwise.
        payload: kind-specific extras (attempt numbers, error reprs, byte
            counts, ...).
    """

    kind: str
    metric: str
    tag: str
    timestamp: float
    duration_s: Optional[float] = None
    signature: Optional[str] = None
    cache_hit: Optional[bool] = None
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_id: Optional[str] = None
    payload: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "kind": self.kind,
            "metric": self.metric,
            "tag": self.tag,
            "timestamp": round(self.timestamp, 9),
        }
        if self.duration_s is not None:
            out["duration_s"] = round(self.duration_s, 9)
        if self.signature is not None:
            out["signature"] = self.signature
        if self.cache_hit is not None:
            out["cache_hit"] = self.cache_hit
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.span_id is not None:
            out["span_id"] = self.span_id
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        if self.payload:
            out["payload"] = dict(self.payload)
        return out


class Sink:
    """Sink protocol: receives every event of a session."""

    def emit(self, event: TelemetryEvent) -> None:  # pragma: no cover - protocol
        raise NotImplementedError

    def close(self) -> None:
        """Flush/release resources at session end. Default: nothing."""


class RingBufferSink(Sink):
    """Bounded in-memory event buffer (oldest events evicted first; O(1) emit —
    this sink sits on the instrumented dispatch path)."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: "collections.deque[TelemetryEvent]" = collections.deque(maxlen=capacity)
        self.evicted = 0  # how many events fell off the front
        # server/flusher threads emit alerts while the training thread emits
        # dispatches and readers snapshot — iterating a deque mid-append raises
        self._emit_lock = threading.Lock()

    def emit(self, event: TelemetryEvent) -> None:
        with self._emit_lock:
            if len(self._events) == self.capacity:
                self.evicted += 1  # deque(maxlen) drops the oldest on append
            self._events.append(event)

    @property
    def events(self) -> Tuple[TelemetryEvent, ...]:
        with self._emit_lock:
            return tuple(self._events)

    def of_kind(self, *kinds: str) -> Tuple[TelemetryEvent, ...]:
        return tuple(e for e in self.events if e.kind in kinds)

    def drain(self) -> Tuple[TelemetryEvent, ...]:
        with self._emit_lock:
            out = tuple(self._events)
            self._events.clear()
            return out


class JSONLSink(Sink):
    """Appends one JSON line per event to ``path`` (opened lazily). The format
    is what ``tools/trace_report.py`` renders.

    ``flush_every=1`` (the default) flushes per event so a crashed process
    still leaves a readable trace; raising it batches flushes for hot sessions.
    Either way ``close()`` — and context-manager exit, which routes through it —
    flushes AND fsyncs, so a trace ``scp``'d off a preempted host ends on a
    complete line. A line truncated by a hard kill mid-write is still possible;
    ``trace_report.py``'s skip-bad-line tolerance covers that tail case.

    Every line carries a ``host`` field (``host=`` override, defaulting to
    ``socket.gethostname()``) so JSONL files merged across a fleet attribute
    each event to its emitter — ``trace_report.py`` uses it as the rank label
    when no explicit ``--rank`` mapping is given.
    """

    def __init__(self, path: str, flush_every: int = 1, host: Optional[str] = None) -> None:
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        self.path = str(path)
        self.flush_every = flush_every
        if host is None:
            host = socket.gethostname()
        self.host = str(host)
        self._fh = None
        self._unflushed = 0
        self.written = 0
        # the health plane emits from server/flusher threads too — the lazy
        # open, the write, and the flush counter must not interleave with the
        # training thread's events (a merged line is a silently dropped event)
        self._emit_lock = threading.Lock()

    def emit(self, event: TelemetryEvent) -> None:
        record = event.to_dict()
        record["host"] = self.host
        line = json.dumps(record) + "\n"
        with self._emit_lock:
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(line)
            self.written += 1
            self._unflushed += 1
            if self._unflushed >= self.flush_every:
                self._fh.flush()
                self._unflushed = 0

    def close(self) -> None:
        with self._emit_lock:
            if self._fh is not None:
                self._fh.flush()
                try:
                    os.fsync(self._fh.fileno())
                except OSError:  # non-seekable/pseudo files: flushed is the best we get
                    pass
                self._fh.close()
                self._fh = None
                self._unflushed = 0

    def __enter__(self) -> "JSONLSink":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class CallbackSink(Sink):
    """Routes events to user hooks by kind.

    ``on_update`` fires for dispatch events (tags ``update``/``forward``),
    ``on_compute`` for compute, ``on_sync`` for sync, ``on_retry`` for
    retry/retry_exhausted, ``on_quarantine`` for quarantine. ``on_event``
    fires for *every* event (including retrace/d2h). Hook exceptions propagate
    — a monitoring callback that raises is a bug worth surfacing, not
    swallowing.
    """

    def __init__(
        self,
        on_update: Optional[Callable[[TelemetryEvent], None]] = None,
        on_compute: Optional[Callable[[TelemetryEvent], None]] = None,
        on_sync: Optional[Callable[[TelemetryEvent], None]] = None,
        on_retry: Optional[Callable[[TelemetryEvent], None]] = None,
        on_quarantine: Optional[Callable[[TelemetryEvent], None]] = None,
        on_event: Optional[Callable[[TelemetryEvent], None]] = None,
    ) -> None:
        self.on_update = on_update
        self.on_compute = on_compute
        self.on_sync = on_sync
        self.on_retry = on_retry
        self.on_quarantine = on_quarantine
        self.on_event = on_event

    def emit(self, event: TelemetryEvent) -> None:
        if self.on_event is not None:
            self.on_event(event)
        if event.kind == "dispatch":
            if self.on_update is not None and event.tag in ("update", "forward"):
                self.on_update(event)
        elif event.kind == "compute":
            if self.on_compute is not None:
                self.on_compute(event)
        elif event.kind == "sync":
            if self.on_sync is not None:
                self.on_sync(event)
        elif event.kind in ("retry", "retry_exhausted"):
            if self.on_retry is not None:
                self.on_retry(event)
        elif event.kind == "quarantine":
            if self.on_quarantine is not None:
                self.on_quarantine(event)
