"""Crash flight recorder: a bounded black box with an atomic postmortem dump.

The :class:`FlightRecorder` is a telemetry :class:`~.events.Sink` that keeps
the last ``capacity`` events in a ring (O(1) emit — it can sit on the
instrumented dispatch path for the life of a soak) and, on a terminal
condition, writes one self-contained JSON artifact: the recent-event ring,
the causal trace tree linking those events (``trace_id``/``span_id``/
``parent_id`` from ``observability/spans.py``), a counters snapshot, and the
current fleet seating if a :class:`FleetController` is live.

Dump triggers:

- **automatic** (``auto_dump=True``): any ``failover``, ``quarantine`` or
  ``retry_exhausted`` event the ring sees;
- **explicit** (:meth:`FlightRecorder.dump`): the chaos soak calls it on a
  ``StateCorruptionError`` and on unrecovered faults at close-out; any
  harness may call it with its own reason.

Artifact discipline mirrors the SnapshotStore: written to a temp file,
flushed, fsynced, then :func:`os.replace`'d into place — a crash mid-dump
never leaves a torn artifact. Filenames are deterministic
(``flightrec-<reason>-<seq>.json``).

Determinism contract: the ``causal`` and ``counters`` blocks of the artifact
are pure functions of the event stream — timestamps, durations and
wall-clock-measured counters are stripped into the non-contractual
``runtime`` block — so two same-seed soak runs dump byte-identical
contractual blocks (the fleet-soak test pins this).
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .events import Sink, TelemetryEvent

__all__ = ["DUMP_KINDS", "FlightRecorder"]

# event kinds that auto-trigger a dump (terminal/containment moments)
DUMP_KINDS: Tuple[str, ...] = ("failover", "quarantine", "retry_exhausted")

# counters measured in wall-clock (or derived from wall-clock windows) — kept
# out of the contractual block; everything else is seed-deterministic
NONDETERMINISTIC_COUNTERS = frozenset({
    "sync_time_us",
    "aot_deserialize_us",
    "tenant_spill_us",
    "migration_us",
    "async_sync_wait_us",
    "alerts",
    "burn_alerts",  # SLO evaluation (and thus burn paging) rides the real clock
})

# payload keys whose values depend on wall-clock or on-disk encoding details
# (snapshot byte sizes embed wall-clock stats in their JSON header)
_NONDET_PAYLOAD_KEYS = frozenset({"bytes", "delay_s"})


def _contractual_event(event: TelemetryEvent) -> Dict[str, Any]:
    """The deterministic projection of one event (no clocks, no byte sizes)."""
    out = event.to_dict()
    out.pop("timestamp", None)
    out.pop("duration_s", None)
    payload = out.get("payload")
    if payload:
        payload = {k: v for k, v in payload.items() if k not in _NONDET_PAYLOAD_KEYS}
        if payload:
            out["payload"] = payload
        else:
            del out["payload"]
    return out


def build_causal_tree(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Group span-carrying event dicts into per-trace span trees.

    Returns one entry per ``trace_id`` (sorted), each a list of root span
    nodes ``{"span", "parent", "events", "children"}`` — a span whose parent
    never emitted inside the ring becomes a root, so a truncated ring still
    renders a useful (if shallower) tree.
    """
    by_trace: "collections.OrderedDict[str, collections.OrderedDict]" = collections.OrderedDict()
    for ev in events:
        trace_id = ev.get("trace_id")
        span_id = ev.get("span_id")
        if trace_id is None or span_id is None:
            continue
        spans = by_trace.setdefault(trace_id, collections.OrderedDict())
        node = spans.get(span_id)
        if node is None:
            node = {"span": span_id, "parent": ev.get("parent_id"),
                    "events": [], "children": []}
            spans[span_id] = node
        node["events"].append([ev.get("kind"), ev.get("metric"), ev.get("tag")])
    trees: List[Dict[str, Any]] = []
    for trace_id in sorted(by_trace):
        spans = by_trace[trace_id]
        roots: List[Dict[str, Any]] = []
        for node in spans.values():
            parent = node["parent"]
            if parent is not None and parent in spans and spans[parent] is not node:
                spans[parent]["children"].append(node)
            else:
                roots.append(node)
        trees.append({"trace": trace_id, "spans": roots})
    return trees


class FlightRecorder(Sink):
    """Always-cheap bounded event ring + atomic crash-dump artifact."""

    def __init__(self, dump_dir: Optional[str] = None, capacity: int = 512,
                 auto_dump: bool = True) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.dump_dir = str(dump_dir) if dump_dir is not None else None
        self.capacity = capacity
        self.auto_dump = auto_dump
        self._ring: "collections.deque[TelemetryEvent]" = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.dumps: List[Dict[str, Any]] = []  # the artifacts, in dump order

    def emit(self, event: TelemetryEvent) -> None:
        with self._lock:
            self._ring.append(event)
        if self.auto_dump and event.kind in DUMP_KINDS:
            self.dump(event.kind)

    @property
    def events(self) -> Tuple[TelemetryEvent, ...]:
        with self._lock:
            return tuple(self._ring)

    def dump(self, reason: str, extra: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        """Build (and, with ``dump_dir``, atomically write) one artifact."""
        with self._lock:
            ring = list(self._ring)
            self._seq += 1
            seq = self._seq
        contractual = [_contractual_event(e) for e in ring]
        artifact: Dict[str, Any] = {
            "version": 1,
            "reason": str(reason),
            "seq": seq,
            "causal": {
                "events": contractual,
                "tree": build_causal_tree(contractual),
            },
            "counters": {},
            "history": None,
            "runtime": {},
        }
        if extra is not None:
            artifact["extra"] = dict(extra)

        from .. import observability as _obs  # late: package imports us

        rec = _obs._ACTIVE
        if rec is not None and not rec._closed:
            counts = dict(rec.counters.snapshot().counts)
            artifact["counters"] = {
                k: v for k, v in counts.items() if k not in NONDETERMINISTIC_COUNTERS
            }
            # contractual like ``causal``/``counters``: the retained level
            # boundaries are byte-identical across same-seed virtual-clock runs
            artifact["history"] = rec.history_block()
            artifact["runtime"] = {
                "counters_wall_clock": {
                    k: counts[k] for k in sorted(NONDETERMINISTIC_COUNTERS) if k in counts
                },
                "latency": rec.latency_summary(),
                "slo": rec.slo_snapshot(),
            }
        artifact["seating"] = self._fleet_seating()

        path = None
        if self.dump_dir is not None:
            path = self._write(artifact, reason, seq)
            artifact["runtime"]["path"] = path
        if rec is not None and not rec._closed:
            rec.counters.record_flightrec_dump()
            rec._event(
                "flightrec", "<flightrec>", str(reason),
                payload={"seq": seq, "events": len(ring),
                         **({"path": os.path.basename(path)} if path else {})},
            )
        self.dumps.append(artifact)
        return artifact

    @staticmethod
    def _fleet_seating() -> Optional[Dict[str, Any]]:
        """Per-host tenant rosters from the live controller, if any."""
        try:
            from ..fleet import controller as _fleet  # the fleet plane is not ported yet
        except Exception:
            return None
        fc = _fleet.active_controller()
        if fc is None:
            return None
        seating: Dict[str, Any] = {}
        try:
            for host_id, engine in sorted(fc.engines().items()):
                roster = engine.tenants()
                seating[host_id] = {
                    repr(tid): {"resident": info["resident"],
                                "quarantined": info["quarantined"],
                                "updates": info["update_count"]}
                    for tid, info in sorted(roster.items(), key=lambda kv: repr(kv[0]))
                }
        except Exception:  # a half-torn controller must not block the dump
            return None
        return seating

    def _write(self, artifact: Mapping[str, Any], reason: str, seq: int) -> str:
        os.makedirs(self.dump_dir, exist_ok=True)
        safe = "".join(c if (c.isalnum() or c in "-_") else "-" for c in str(reason))[:48]
        path = os.path.join(self.dump_dir, f"flightrec-{safe}-{seq:04d}.json")
        tmp = f"{path}.tmp-{os.getpid()}"
        data = json.dumps(artifact, indent=2, sort_keys=True, default=str)
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(data + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):  # pragma: no cover - only on a failed write
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return path
