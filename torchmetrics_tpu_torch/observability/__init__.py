"""Observability layer (counterpart of ``torchmetrics_tpu/observability``): dispatch
tracing, retrace/D2H counters, sync timing, profiler integration.

Opt-in and zero-overhead when disabled: the runtime's hot paths read one module
attribute (``_ACTIVE``) and take the plain branch when it is ``None`` — no
event objects, no signature hashing, no clock reads (guarded by a test). With a
session active, every tensor-path dispatch is counted (compile vs cache hit per
dispatch key, by input shape/dtype signature: in eager PyTorch a first-seen and a
repeated signature — the counter names are the JAX package's, kept because the
counter vector rides the sync metadata as a wire format), retrace churn trips a
rank-zero sentinel naming the offending shapes, instrumented device→host
readback sites increment a counter the hot loop must keep at zero, and
``process_sync`` reports invocations plus payload bytes. The reliability
layer's retry/quarantine decisions — previously visible only as warnings —
land in the same event stream.

Typical session::

    from torchmetrics_tpu_torch import observability as obs

    with obs.telemetry_session() as rec:            # in-memory ring buffer
        run_eval()
    print(rec.counters.snapshot().summary(brief=True))
    retries = rec.events_of("retry")

    obs.enable(obs.TelemetryConfig(sinks=(obs.JSONLSink("trace.jsonl"),)))
    run_eval()                                      # then: tools/trace_report.py trace.jsonl
    obs.disable()

Where the port differs by design: a :class:`CostRecord` is harvested on the real
eager dispatch (``costs.py``), ``tracing.graph_scope`` is a no-op and
``tracing.trace_span`` is a ``torch.profiler`` range (``tracing.py``). The event
model, counters, histograms, SLOs, history, flight recorder and export are the JAX
package's (``docs/observability.md``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..utilities.prints import rank_zero_warn
from . import costs as costs_module
from . import events
from . import flightrec as flightrec_module
from . import histograms as histograms_module
from . import memory as memory_module
from . import slo as slo_module
from . import spans
from . import timeseries as timeseries_module
from . import tracing
from .costs import CostRecord, CostRegistry
from .counters import (
    COUNTER_FIELDS,
    Counters,
    CountersSnapshot,
    FleetSnapshot,
    aggregate_counters,
)
from .events import (
    EVENT_KINDS,
    CallbackSink,
    JSONLSink,
    RingBufferSink,
    Sink,
    TelemetryEvent,
)
from .flightrec import FlightRecorder
from .histograms import (
    FLEET_HISTOGRAM_KINDS,
    Histogram,
    HistogramRegistry,
    aggregate_histograms,
)
from .memory import StateMemoryTracker, state_memory
from .slo import SloEngine, SloRule, default_rules
from .timeseries import TelemetryHistory
from . import export  # noqa: E402 — needs histograms imported first
from .export import HealthServer, MetricsFlusher, render_prometheus

__all__ = [
    "COUNTER_FIELDS",
    "EVENT_KINDS",
    "FLEET_HISTOGRAM_KINDS",
    "CallbackSink",
    "CostRecord",
    "CostRegistry",
    "Counters",
    "CountersSnapshot",
    "FleetSnapshot",
    "FlightRecorder",
    "HealthServer",
    "Histogram",
    "HistogramRegistry",
    "JSONLSink",
    "MetricsFlusher",
    "RingBufferSink",
    "Sink",
    "SloEngine",
    "SloRule",
    "StateMemoryTracker",
    "TelemetryConfig",
    "TelemetryEvent",
    "TelemetryHistory",
    "TelemetryRecorder",
    "active",
    "aggregate_counters",
    "aggregate_histograms",
    "cost_snapshot",
    "default_rules",
    "disable",
    "enable",
    "enabled",
    "export",
    "gather_counters",
    "gather_histograms",
    "render_prometheus",
    "spans",
    "state_memory",
    "telemetry_session",
    "tracing",
]


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Knobs for one telemetry session.

    Args:
        sinks: event sinks. Empty (the default) gets one in-memory
            :class:`RingBufferSink` of ``ring_buffer_size`` so a bare
            ``telemetry_session()`` is already inspectable.
        ring_buffer_size: capacity of that default ring buffer.
        block_until_ready: blocking-timing mode — the current CUDA stream of
            the metric's device is synchronized after every dispatch/compute
            (``tracing.block_for_timing``) so ``duration_s`` is honest device
            wall-clock instead of async launch latency. Serializes the
            pipeline; for attribution runs, never for production loops.
        retrace_warn_threshold: the retrace sentinel fires a rank-zero warning
            when a single metric's dispatch key accumulates MORE than this many
            distinct input shape/dtype signatures (shape-instability recompile
            churn). Warned once per key.
        cost_accounting: harvest a cost record for every fresh signature
            (``FlopCounterMode`` around that one real dispatch plus metadata
            byte counts — nothing runs again, zero device traffic). Disable
            for sessions where even that first dispatch's host cost matters.
        track_state_memory: track per-metric state bytes (metadata-only) after
            every instrumented update, keeping peaks and arming the
            unbounded-growth sentinel.
        state_growth_warn_bytes: the growth sentinel rank-zero-warns (once per
            metric/state) when a single list/cat state exceeds this many bytes
            — cat states are the one unbounded growth axis in the runtime and
            the #1 silent OOM cause in long evals.
        slo_rules: declarative health rules (``observability/slo.py``) the
            session evaluates over rolling counter/histogram windows — start
            from :func:`slo.default_rules`. Empty (the default) arms nothing.
        slo_eval_on_sync: evaluate the rules at every recorded sync boundary
            (low-frequency, already collective-shaped — the natural heartbeat
            of a training/eval loop). The export layer's background flusher
            and the health server evaluate on their own cadence regardless.
        history_spans: level spans (seconds) of the session's telemetry
            history (``observability/timeseries.py``) — telescoping retention
            of counter/histogram deltas, fed at the same sync heartbeat the
            SLO window rides, queried via ``history.at(t)`` / ``/historyz``.
            ``None`` disables retention entirely.
        history_keep: per-level closed-block retention caps (defaults to
            tiling the next level + 24 at the top — see
            :class:`~torchmetrics_tpu_torch.streaming.telescope.TelescopingFold`).
        history_clock: the history's time source — the determinism seam.
            Soak/fleet runs inject their virtual clock so same-seed runs
            retain byte-identical history blocks; defaults to the monotonic
            clock the event timestamps already use.
    """

    sinks: Tuple[Sink, ...] = ()
    ring_buffer_size: int = 4096
    block_until_ready: bool = False
    retrace_warn_threshold: int = 8
    cost_accounting: bool = True
    track_state_memory: bool = True
    state_growth_warn_bytes: int = 256 * 2**20
    slo_rules: Tuple[SloRule, ...] = ()
    slo_eval_on_sync: bool = True
    history_spans: Optional[Tuple[float, ...]] = timeseries_module.DEFAULT_SPANS
    history_keep: Optional[Tuple[int, ...]] = None
    history_clock: Optional[Any] = None  # Callable[[], float]; Any keeps the dataclass hashable-friendly


class TelemetryRecorder:
    """The live session object: counters registry + event fan-out.

    Runtime code never talks to sinks directly — it calls the ``record_*``
    methods below, which bump counters and construct exactly one event. All
    inputs are host metadata (shapes, dtypes, monotonic clocks, byte counts
    derived from ``numel()``/``element_size()``): recording never reads device memory,
    so an instrumented hot loop stays D2H-free.
    """

    def __init__(self, config: Optional[TelemetryConfig] = None) -> None:
        self.config = config or TelemetryConfig()
        self.counters = Counters()
        self.costs = CostRegistry()
        self.counters.attach_costs(self.costs)  # cost entries ride along in snapshots
        self.memory = StateMemoryTracker(self.config.state_growth_warn_bytes)
        self.histograms = HistogramRegistry()
        self.slo = SloEngine(self.config.slo_rules)
        self.history: Optional[TelemetryHistory] = (
            TelemetryHistory(
                spans=self.config.history_spans,
                keep=self.config.history_keep,
                clock=self.config.history_clock,
            )
            if self.config.history_spans
            else None
        )
        self.sinks: Tuple[Sink, ...] = self.config.sinks or (
            RingBufferSink(self.config.ring_buffer_size),
        )
        self._epoch = next(_SESSION_EPOCHS)
        self._ids = itertools.count()
        self._retrace_warned: set = set()
        self._drift: Dict[str, float] = {}  # last score per DriftMonitor name
        self._drift_warned: set = set()
        self._quant_norm = 0.0  # latest error-feedback residual L2 (gauge)
        self._closed = False

    # ------------------------------------------------------------- identities

    def _metric_name(self, metric: Any) -> str:
        """Stable per-instance identity ``ClassName#n``, assigned on first sight
        within THIS session. The stamp carries the session epoch so a metric
        that outlives its session (or arrives pickled from another process)
        gets a fresh id instead of colliding with an unrelated metric's
        counters. Clones deepcopy the stamp and merge with their origin —
        documented approximation."""
        stamp = metric.__dict__.get("_telemetry_id")
        if not (isinstance(stamp, tuple) and stamp[0] == self._epoch):
            stamp = (self._epoch, next(self._ids))
            metric._telemetry_id = stamp
        return f"{type(metric).__name__}#{stamp[1]}"

    @staticmethod
    def _signature(inputs: Optional[tuple]) -> str:
        """Shape/dtype key of a dispatch's inputs — metadata only, no device
        access: the JAX package's string for the same inputs
        (``aot.keys.dispatch_signature``)."""
        from ..aot import keys as _aot_keys

        return _aot_keys.dispatch_signature(inputs)

    def _fresh_signature(self, metric: Any, tag: str, sig: str) -> bool:
        """Whether ``metric``'s ``tag`` dispatch has not seen ``sig`` in this
        session — asked before the dispatch, to open a cost harvest around it.
        Assigns no identity: a metric first seen in this session is fresh."""
        stamp = metric.__dict__.get("_telemetry_id")
        if not (isinstance(stamp, tuple) and stamp[0] == self._epoch):
            return True
        return not self.counters.has_signature(f"{type(metric).__name__}#{stamp[1]}.{tag}", sig)

    # ---------------------------------------------------------------- fan-out

    def emit(self, event: TelemetryEvent) -> None:
        for sink in self.sinks:
            sink.emit(event)

    def _event(self, kind: str, metric: str, tag: str, **kw: Any) -> None:
        ctx = spans.current()
        if ctx is not None and "trace_id" not in kw:
            kw["trace_id"] = ctx.trace_id
            kw["span_id"] = ctx.span_id
            kw["parent_id"] = ctx.parent_id
        self.emit(TelemetryEvent(kind=kind, metric=metric, tag=tag, timestamp=tracing.monotonic(), **kw))

    # --------------------------------------------------------- runtime seams

    def finish(self, result: Any, t0: float, device: Any = None) -> float:
        """Duration of a span started at ``t0``; blocking-timing mode waits for
        the work queued on ``device``'s current CUDA stream first (honest
        wall-clock; nothing is waited for on the CPU)."""
        if self.config.block_until_ready:
            tracing.block_for_timing(result, device)
        return tracing.monotonic() - t0

    def record_dispatch(
        self,
        metric: Any,
        tag: str,
        inputs: Optional[tuple],
        duration_s: float,
        lower: Optional[Any] = None,
        aot_loaded: bool = False,
        signature: Optional[str] = None,
    ) -> None:
        """One successful tensor-path dispatch (``update``/``forward``).

        ``lower`` is the cost-accounting hook: in the port, the
        :class:`~.costs.DispatchHarvest` that was open around this dispatch (or
        None). It is read only when the signature is fresh — i.e. exactly when
        the compile counter ticks — so the cost registry reconciles 1:1 with
        ``jit_compiles`` per key.
        ``aot_loaded`` marks a dispatch served by a deserialized executable
        from the AOT cache: a fresh signature then counts as ``aot_cache_hits``
        instead of a compile (the lower thunk for such a dispatch returns the
        loaded executable, so its cost entry still harvests without compiling).
        ``signature`` accepts the plane's precomputed signature so the hot
        path never flattens the same inputs twice.
        """
        name = self._metric_name(metric)
        key = f"{name}.{tag}"
        sig = signature if signature is not None else self._signature(inputs)
        if self.config.cost_accounting and not self.counters.has_signature(key, sig):
            # harvest BEFORE the compile counter ticks: a concurrent snapshot
            # must never see a counted compile without its cost entry
            self.costs.harvest(key, sig, lower)
        is_new, n_compiles = self.counters.record_dispatch(key, sig, aot_loaded=aot_loaded)
        self.histograms.record_duration(tag, name, duration_s)
        self._event(
            "dispatch", name, tag, duration_s=duration_s, signature=sig, cache_hit=not is_new,
            payload={"aot": True} if aot_loaded else {},
        )
        # retrace events/sentinel track actual RECOMPILES (the key's compiles
        # beyond its first), mirroring the retraces counter exactly — an
        # AOT-served fresh signature recompiled nothing, and a service that
        # deliberately precompiled many shapes is warm, not churning
        if is_new and not aot_loaded and n_compiles > 1:
            self._event("retrace", name, tag, signature=sig, payload={"n_compiles": n_compiles})
        if is_new and not aot_loaded and n_compiles > self.config.retrace_warn_threshold and key not in self._retrace_warned:
            self._retrace_warned.add(key)
            shapes = self.counters.signatures(key)
            rank_zero_warn(
                f"Retrace sentinel: {key} has compiled for {n_compiles} distinct input "
                f"shape/dtype signatures (> {self.config.retrace_warn_threshold}) — every new "
                f"signature is a fresh XLA trace+compile. Pad or bucket inputs to a stable "
                f"shape. Signatures seen: {shapes}.",
                UserWarning,
            )

    def record_aot_load(
        self, metric: Any, tag: str, duration_s: float, nbytes: int, key: str, codec: str
    ) -> None:
        """One serialized executable loaded from the AOT compile cache for
        this metric's ``tag`` program (``aot/``): deserialize wall-clock into
        the ``aot_deserialize_us`` counter and the ``aot_load`` histogram
        kind, plus one ``aot_load`` event carrying entry size, codec, and the
        cache entry's content address."""
        import hashlib

        name = self._metric_name(metric)
        self.counters.record_aot_deserialize(duration_s)
        self.histograms.record_duration("aot_load", name, duration_s)
        self._event(
            "aot_load", name, tag, duration_s=duration_s,
            # the entry field is the cache file's content address (prefix),
            # not the raw key — keys are long and carry config reprs
            payload={"nbytes": int(nbytes), "codec": codec,
                     "entry": hashlib.sha256(key.encode("utf-8")).hexdigest()[:16]},
        )

    def record_aot_miss(self) -> None:
        """The AOT plane probed the disk for a first-seen signature and found
        nothing usable — the dispatch fell back to a fresh compile."""
        self.counters.record_aot_miss()

    def record_host_dispatch(self, metric: Any, tag: str, duration_s: float) -> None:
        """A HostMetric eager dispatch (never jitted — no compile/hit split)."""
        name = self._metric_name(metric)
        self.counters.record_host_dispatch()
        self.histograms.record_duration(tag, name, duration_s)
        self._event("dispatch", name, tag, duration_s=duration_s, payload={"jitted": False})

    def record_compute(self, metric: Any, duration_s: float) -> None:
        name = self._metric_name(metric)
        self.counters.record_compute()
        self.histograms.record_duration("compute", name, duration_s)
        self._event("compute", name, "compute", duration_s=duration_s)

    def record_sync(
        self,
        metric: Any,
        duration_s: float,
        payload_bytes: int,
        collectives: int = 0,
        coalesced_leaves: int = 0,
    ) -> None:
        """One ``Metric.sync``/``MetricCollection.sync`` through the sync
        planes (gather/bucket counts and byte totals land in the counters from
        ``parallel/sync.py``; the duration feeds the fleet rollup's straggler
        attribution). ``collectives`` is how many collectives this sync
        launched and ``coalesced_leaves`` how many state leaves rode a
        coalesced bucket — the per-sync view of the K·L → buckets reduction."""
        name = self._metric_name(metric)
        self.counters.record_sync_time(duration_s)
        self.histograms.record_duration("sync", name, duration_s)
        self.histograms.record("sync_payload", name, int(payload_bytes))
        self._event(
            "sync", name, "sync", duration_s=duration_s,
            payload={
                "payload_bytes": int(payload_bytes),
                "collectives": int(collectives),
                "coalesced_leaves": int(coalesced_leaves),
            },
        )
        # sync boundaries are the loop's natural low-frequency heartbeat — the
        # place a rolling SLO window gets fed without touching the update path
        if self.config.slo_eval_on_sync and self.slo.rules:
            self.slo.observe_and_evaluate(self)
        # ... and the telemetry history telescopes the same heartbeat into its
        # multi-resolution retention levels — gated on a new finest block
        # having started, so the vector snapshots are built at most once per
        # block span and the per-sync cost stays a clock compare
        if self.history is not None and self.history.due():
            self.observe_history()

    def record_gather_payload(self, plane: str, nbytes: int) -> None:
        """Size of one sync-plane collective payload (``plane`` is
        ``"coalesced"`` or ``"per_leaf"``) — the distribution that shows
        whether bucketing is actually producing few-large instead of
        many-small collectives. Metadata-derived bytes, never a device read."""
        self.histograms.record("gather_bytes", plane, int(nbytes))

    def record_state_memory(self, metric: Any) -> None:
        """Refresh a metric's state-memory footprint after an update (metadata
        only — shape×itemsize, never a device read). Fires the unbounded-growth
        sentinel the first time a list/cat state crosses the configured
        threshold: one rank-zero warning + one ``state_growth`` event per
        (metric, state)."""
        if not self.config.track_state_memory:
            return
        name = self._metric_name(metric)
        for sname, info in self.memory.observe(name, metric._state):
            self.counters.record_state_growth()
            self._event(
                "state_growth", name, sname,
                payload={"nbytes": info["nbytes"], "elements": info["elements"],
                         "threshold_bytes": self.config.state_growth_warn_bytes},
            )
            rank_zero_warn(
                f"State growth sentinel: {name}.{sname} is a list ('cat') state holding "
                f"{info['nbytes']} bytes across {info['elements']} appended batches "
                f"(> {self.config.state_growth_warn_bytes}). Cat states grow without bound "
                f"until compute() — consider a binned/sufficient-statistic variant, "
                f"compute_on_cpu=True to keep growth off HBM, or periodic compute+reset.",
                UserWarning,
            )

    def record_serve_dispatch(
        self, metric: Any, rows: int, padded: int = 0,
        links: Optional[List[str]] = None,
    ) -> None:
        """One megabatched serving dispatch (``torchmetrics_tpu/serving``):
        ``rows`` real tenant rows updated by a single vmapped program (plus
        ``padded`` scratch rows keeping the dispatch signature fixed). The
        dispatch latency itself was already recorded by :meth:`record_dispatch`
        under the ``vupdate`` tag — this adds the tenant-amortization view the
        derived ``tenants_per_dispatch`` headline reports. ``links`` carries
        the (bounded) trace ids of the seated rows' admission spans — a
        megabatch folds many requests, so the serve event fans IN."""
        name = self._metric_name(metric)
        self.counters.record_serve_dispatch(rows, padded)
        payload: Dict[str, Any] = {"tenant_rows": int(rows), "padded_rows": int(padded)}
        if links:
            payload["links"] = list(links)
        self._event("serve", name, "vupdate", payload=payload)

    def record_tenant_spill(
        self, metric: Any, duration_s: float, nbytes: int, readmit: bool = False
    ) -> None:
        """One LRU spill of a cold tenant's state rows to host memory (or,
        ``readmit=True``, the upload back into a stack slot). Wall-clock lands
        in ``tenant_spill_us`` and the ``tenant_spill`` histogram kind; bytes
        come from array metadata (the spill itself is the D2H — accounted
        separately via :meth:`record_d2h` at the call site)."""
        name = self._metric_name(metric)
        self.counters.record_tenant_spill(duration_s, readmit=readmit)
        self.histograms.record_duration("tenant_spill", name, duration_s)
        self._event(
            "tenant_spill", name, "readmit" if readmit else "spill",
            duration_s=duration_s, payload={"nbytes": int(nbytes)},
        )

    def record_window_roll(self, metric: Any, window: int, filled: int, wrapped: bool,
                           tier: str = "ring", rotated: bool = False) -> None:
        """One SlidingWindow update (streaming plane). The ``window_rolls``
        counter ticks on every update and ``window_rotations`` on every dual
        block rotation / two-stack pane completion (``rotated``); the
        ``window_roll`` EVENT fires only when the window wrapped (a full
        window of updates completed) so the stream stays low-rate — the
        per-update dispatch latency already rides the ``wupdate``/``wdual``/
        ``wstack`` dispatch events/histograms."""
        name = self._metric_name(metric)
        self.counters.record_window_roll(rotated=rotated)
        if wrapped:
            self._event(
                "window_roll", name,
                {"ring": "wupdate", "dual": "wdual", "two_stack": "wstack"}.get(tier, "wupdate"),
                payload={"window": int(window), "filled": int(filled), "tier": tier},
            )

    def record_async_sync(
        self,
        label: str,
        gather_s: float,
        wait_s: float,
        payload_bytes: int,
        collectives: int = 0,
        fallback: bool = False,
    ) -> None:
        """One committed double-buffered background sync
        (``parallel.AsyncSyncHandle``). ``gather_s`` is the gather's full
        wall-clock (what a blocking sync would have cost the caller — it
        feeds ``sync_time_us`` and the ``sync`` histogram like any sync);
        ``wait_s`` is how long ``commit()`` actually blocked. The difference,
        reported as ``overlap_pct``, is the sync latency the overlap hid —
        the direct observable of the double-buffered plane."""
        self.counters.record_async_sync(wait_s)
        self.counters.record_sync_time(gather_s)
        self.histograms.record_duration("sync", label, gather_s)
        overlap = max(0.0, 1.0 - (wait_s / gather_s)) * 100.0 if gather_s > 0 else 0.0
        self._event(
            "async_sync", label, "sync", duration_s=gather_s,
            payload={
                "wait_s": round(wait_s, 6),
                "overlap_pct": round(overlap, 2),
                "payload_bytes": int(payload_bytes),
                "collectives": int(collectives),
                "fallback": bool(fallback),
            },
        )

    def record_drift(
        self,
        name: str,
        score: float,
        breached: bool,
        threshold: float,
        severity: str = "warning",
    ) -> None:
        """One DriftMonitor evaluation. The latest score lands in the SLO
        expression namespace as ``drift(name)``; a breach additionally rides
        the ``alert`` event kind (plus the ``alerts`` counter and a once-per-
        name rank-zero warning), exactly like an SLO rule breach — drift IS a
        health signal, so it shares the alerting channel."""
        self.counters.record_drift(breached)
        self._drift[name] = float(score)
        if not breached:
            return
        self.counters.record_alert()
        self._event(
            "alert", name, "drift",
            payload={
                "kind": "drift",
                "severity": severity,
                "score": round(float(score), 6),
                "threshold": float(threshold),
            },
        )
        if name not in self._drift_warned:
            self._drift_warned.add(name)
            rank_zero_warn(
                f"Drift breach [{severity}] {name}: score {float(score):.6g} over threshold "
                f"{float(threshold):.6g} (test window vs reference window diverged).",
                UserWarning,
            )

    def drift_score(self, name: str) -> float:
        """Latest score a DriftMonitor recorded under ``name`` (0.0 when none
        ran) — the value the SLO namespace's ``drift(name)`` reads."""
        return self._drift.get(name, 0.0)

    def drift_scores(self) -> Dict[str, float]:
        return dict(self._drift)

    def record_quant(
        self,
        label: str,
        codec: str,
        buckets: int,
        leaves: int,
        raw_bytes: int,
        shipped_bytes: int,
        feedback_norm: float = 0.0,
    ) -> None:
        """One coalesced sync that shipped quantized buckets
        (``parallel/quantize.py``). ``raw_bytes`` is what the exact plane
        would have put on the wire for those buckets, ``shipped_bytes`` what
        the codec actually shipped (scale metadata included); the difference
        feeds the ``sync_bytes_saved`` counter and the per-event compression
        ratio ``tools/trace_report.py`` renders. ``feedback_norm`` is the
        residual store's L2 after the sync — the ``quant_error_feedback_norm``
        gauge (``quant_feedback_norm`` in the SLO namespace): a norm that
        climbs sync over sync means the codec is too coarse for the data."""
        self.counters.record_quant(buckets, raw_bytes - shipped_bytes)
        self._quant_norm = float(feedback_norm)
        ratio = (raw_bytes / shipped_bytes) if shipped_bytes > 0 else 0.0
        self._event(
            "quant", label, codec,
            payload={
                "buckets": int(buckets),
                "leaves": int(leaves),
                "raw_bytes": int(raw_bytes),
                "shipped_bytes": int(shipped_bytes),
                "bytes_saved": int(raw_bytes - shipped_bytes),
                "compression_x": round(ratio, 3),
                "feedback_norm": round(float(feedback_norm), 9),
            },
        )

    def quant_feedback_norm(self) -> float:
        """Latest ``quant_error_feedback_norm`` gauge value (0.0 before any
        quantized sync) — the SLO namespace exposes it by the same name."""
        return self._quant_norm

    def record_serve_rejected(self, metric: Any, tenant_id: Any) -> None:
        """One tenant batch shed by the serving admission rate limit — the
        overload signal an autoscaler watches instead of LRU-spill churn."""
        name = self._metric_name(metric)
        self.counters.record_serve_rejected()
        self._event(
            "serve_rejected", name, "admission",
            payload={"tenant": repr(tenant_id)[:80]},
        )

    def record_snapshot(
        self, metric: Any, op: str, duration_s: float, nbytes: int, generation: int
    ) -> None:
        """One durability-plane snapshot ``op`` (``"write"`` or
        ``"restore"``) of a serving engine: the whole-fleet state landed in
        (or loaded from) one content-addressed generation."""
        name = self._metric_name(metric)
        self.counters.record_snapshot(restore=(op == "restore"))
        self._event(
            "snapshot", name, op,
            duration_s=duration_s,
            payload={"bytes": int(nbytes), "generation": int(generation)},
        )

    def record_journal_replay(self, metric: Any, records: int, duration_s: float) -> None:
        """``records`` write-ahead journal entries rolled forward into a
        restored engine (the failover tail between the snapshot point and the
        crash)."""
        name = self._metric_name(metric)
        self.counters.record_journal_replay(records)
        self._event(
            "journal", name, "replay",
            duration_s=duration_s,
            payload={"records": int(records)},
        )

    def record_degraded_sync(self, label: str, dead: Any, world: int) -> None:
        """One coalesced sync that completed over a survivor quorum: the
        ranks in ``dead`` presented tombstone metadata rows, the fold covered
        the survivors, and the sync is marked degraded instead of hanging."""
        self.counters.record_degraded_sync()
        self._event(
            "degraded_sync", label, "quorum",
            payload={"dead": [int(r) for r in dead], "world": int(world)},
        )

    def record_rank_rejoin(self, label: str, rank: int, epoch: int) -> None:
        """A previously dead rank presented a live metadata row again — its
        accumulated contribution folds back in on this sync (full-state
        gather: reconciliation without double counting)."""
        self.counters.record_rank_rejoin()
        self._event(
            "rank_rejoin", label, "rejoin",
            payload={"rank": int(rank), "epoch": int(epoch)},
        )

    def record_fleet_heartbeat(self, host: str) -> None:
        """One member-host lease renewal (fleet plane). Counter-only — a
        heartbeat per host per step would swamp the event stream."""
        self.counters.record_fleet_heartbeat()

    def record_lease_expiry(self, host: str) -> None:
        """One host lease past ``dead_after`` — the suspect → dead transition
        the failover path keys off."""
        self.counters.record_lease_expiry()

    def record_migration(
        self, label: str, src: str, dst: str, tenants: int, duration_s: float
    ) -> None:
        """One COMMITTED migration: ``tenants`` drained on ``src``,
        snapshot-sliced, transferred, restored on ``dst`` and cut over."""
        self.counters.record_migration(tenants, int(duration_s * 1e6))
        self._event(
            "migration", label, "commit",
            duration_s=duration_s,
            payload={"src": str(src), "dst": str(dst), "tenants": int(tenants)},
        )

    def record_host_failover(
        self, label: str, host: str, tenants: int, replayed: int, rpo_records: int,
        roster: Optional[List[str]] = None,
    ) -> None:
        """One dead host's roster adopted by survivors: restored from its
        latest snapshot generation plus ``replayed`` journal-tail records,
        with ``rpo_records`` admissions unrecoverable (the fsync window).
        ``roster`` names the adopted tenants (bounded repr list) so a flight-
        recorder dump identifies the dead host's in-flight sessions."""
        self.counters.record_host_failover()
        payload: Dict[str, Any] = {
            "host": str(host), "tenants": int(tenants),
            "replayed": int(replayed), "rpo_records": int(rpo_records),
        }
        if roster:
            payload["roster"] = [str(t)[:80] for t in roster[:32]]
        self._event("failover", label, "adopt", payload=payload)

    def record_d2h(self, site: str, nbytes: int, metric: Any = None) -> None:
        """An instrumented device→host readback (``state_dict``,
        ``compute_on_cpu`` appends, finiteness guards). The hot loop's
        contract is that this counter stays at zero."""
        self.counters.record_d2h(nbytes)
        name = self._metric_name(metric) if metric is not None else ""
        self._event("d2h", name, site, payload={"nbytes": int(nbytes)})

    def record_retry(
        self, describe: str, attempt: int, exc: BaseException, delay_s: float = 0.0
    ) -> None:
        self.counters.record_retry()
        self.histograms.record_duration("retry_backoff", describe, delay_s)
        self._event(
            "retry", describe, "retry",
            payload={"attempt": attempt, "error": repr(exc)[:240], "delay_s": round(delay_s, 6)},
        )

    def record_retry_exhausted(self, describe: str, attempts: int, exc: BaseException) -> None:
        self.counters.record_retry_exhausted()
        self._event(
            "retry_exhausted", describe, "retry",
            payload={"attempts": attempts, "error": repr(exc)[:240]},
        )

    def record_quarantine(self, name: str, stage: str, status: str, exc: BaseException, update_count: int) -> None:
        self.counters.record_quarantine(status)
        self._event(
            "quarantine", name, stage,
            payload={"status": status, "error": repr(exc)[:240], "update_count": update_count},
        )

    # -------------------------------------------------------------- inspection

    def metric_summary(self, metric: Any) -> Dict[str, Any]:
        """Per-tag dispatch accounting for one metric instance."""
        stamp = metric.__dict__.get("_telemetry_id")
        if not (isinstance(stamp, tuple) and stamp[0] == self._epoch):
            return {"dispatches": 0, "tags": {}}
        prefix = f"{type(metric).__name__}#{stamp[1]}."
        tags: Dict[str, Any] = {}
        total = 0
        for key, rec in self.counters.keys_for(prefix).items():
            tag = key[len(prefix):]
            aot_hits = rec.get("aot_hits", 0)
            n = rec["compiles"] + rec["cache_hits"] + aot_hits
            total += n
            tags[tag] = {
                "dispatches": n,
                "compiles": rec["compiles"],
                "cache_hits": rec["cache_hits"],
                "aot_hits": aot_hits,
                "retraces": max(0, rec["compiles"] - 1),
                "signatures": rec["signatures"],
            }
        return {"dispatches": total, "tags": tags}

    def cost_snapshot(self) -> Dict[str, Any]:
        """Per-dispatch-key costs: ``{key: {signature: record}}``.
        Reconciles with the compile counters — every key counted as a compile
        has an entry (placeholders mark unavailable analysis)."""
        return self.costs.snapshot()

    def cost_summary(self) -> Dict[str, Any]:
        """Dispatch-weighted run cost totals (``run_flops`` etc.) — the flat
        block bench configs embed next to the brief counters."""
        return self.counters.snapshot().cost_totals()

    def memory_snapshot(self) -> Dict[str, Any]:
        """Per-metric state-memory report: current and peak bytes, per-state
        breakdown, per-state peaks."""
        return self.memory.snapshot()

    def histogram_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-(kind, key) latency/size distributions as flat report blocks:
        ``{kind: {key: {count, sum, mean, p50, p95, p99, p999, buckets}}}``.
        Latency kinds are microseconds; size kinds
        (:data:`histograms.SIZE_KINDS`) are bytes."""
        return {
            kind: {key: hist.summary() for key, hist in keys.items()}
            for kind, keys in self.histograms.snapshot().items()
        }

    def latency_summary(self) -> Dict[str, Any]:
        """Per-kind percentile headline merged across all keys — the block the
        full ``summary()`` and the bench columns embed (``*_us`` for latency
        kinds, ``*_bytes`` for size kinds)."""
        out: Dict[str, Any] = {}
        for kind, hist in self.histograms.kind_totals().items():
            unit = "bytes" if kind in histograms_module.SIZE_KINDS else "us"
            block: Dict[str, Any] = {"count": hist.count}
            for name, est in hist.percentiles().items():
                block[f"{name}_{unit}"] = round(est, 1) if est is not None else None
            out[kind] = block
        return out

    def metric_latency(self, metric: Any) -> Dict[str, Any]:
        """One metric's per-stage latency percentiles (``update``/``forward``/
        ``compute``/``sync`` — whichever this session recorded), for
        ``MetricCollection.telemetry_summary()``'s per-member attribution."""
        stamp = metric.__dict__.get("_telemetry_id")
        if not (isinstance(stamp, tuple) and stamp[0] == self._epoch):
            return {}
        name = f"{type(metric).__name__}#{stamp[1]}"
        out: Dict[str, Any] = {}
        for kind in ("update", "forward", "compute", "sync", "aot_load", "wupdate",
                     "wdual", "wstack", "dupdate", "vupdate", "vwupdate"):
            hist = self.histograms.get(kind, name)
            if hist is None or not hist.count:
                continue
            pct = hist.percentiles()
            out[kind] = {
                "count": hist.count,
                "p50_us": round(pct["p50"], 1) if pct["p50"] is not None else None,
                "p99_us": round(pct["p99"], 1) if pct["p99"] is not None else None,
            }
        return out

    def observe_history(self, now: float = None) -> int:
        """Feed one counter/histogram snapshot into the session's telescoping
        telemetry history (no-op when ``history_spans`` disabled retention).
        Returns the number of blocks the feed closed; each closure bumps the
        ``history_folds`` counter and emits one ``history`` event so the fold
        cadence itself is observable."""
        if self.history is None:
            return 0
        folds = self.history.observe(
            self.counters.counts_vector(),
            self.histograms.fleet_vector(),
            now=now,
        )
        if folds:
            self.counters.record_history_folds(folds)
            self._event(
                "history",
                "telemetry",
                "fold",
                payload={"folds": folds, "blocks": self.history.block_count()},
            )
        return folds

    def history_block(self, last_n: int = 8) -> Optional[Dict[str, Any]]:
        """The deterministic history export: last ``last_n`` retained block
        boundaries per level, wall-clock-tainted counters dropped — the block
        a flight-recorder dump and a ``SoakReport`` carry contractually
        (byte-identical across same-seed virtual-clock runs)."""
        if self.history is None:
            return None
        return self.history.export_block(
            last_n=last_n, drop=flightrec_module.NONDETERMINISTIC_COUNTERS
        )

    def evaluate_slos(self, now: float = None) -> list:
        """Evaluate the session's SLO rules right now (the health server and
        the export flusher call this on their own cadence; sync boundaries do
        it automatically under ``slo_eval_on_sync``). Returns alerts emitted
        by this evaluation."""
        return self.slo.observe_and_evaluate(self, now=now)

    def slo_snapshot(self) -> Dict[str, Any]:
        return self.slo.snapshot()

    def summary(
        self,
        brief: bool = False,
        fleet: bool = False,
        process_group: Any = None,
        dist_sync_fn: Any = None,
    ) -> Dict[str, Any]:
        """Session summary. ``fleet=True`` gathers every rank's counters
        through the metadata gather plane and returns pod-wide totals plus
        straggler attribution; the local summary rides along under
        ``"local"``. Local-only otherwise."""
        snap = self.counters.snapshot()
        if not fleet:
            out = snap.summary(brief=brief)
            if not brief:
                out["latency"] = self.latency_summary()
            return out
        fleet_snap = gather_counters(snap, process_group=process_group, dist_sync_fn=dist_sync_fn)
        out = fleet_snap.summary(brief=brief)
        out["local"] = snap.summary(brief=True)
        return out

    @property
    def events(self) -> Tuple[TelemetryEvent, ...]:
        """Events from the session's first ring-buffer sink (empty tuple when
        only external sinks are configured)."""
        for sink in self.sinks:
            if isinstance(sink, RingBufferSink):
                return sink.events
        return ()

    def events_of(self, *kinds: str) -> Tuple[TelemetryEvent, ...]:
        return tuple(e for e in self.events if e.kind in kinds)

    def close(self) -> None:
        if self._closed:  # idempotent: a replaced-then-disabled session must
            return        # not flush its histograms into the sinks twice
        self._closed = True
        # fold the session's final counter state into the history so the last
        # partial block is retained before the sinks stop listening
        if self.history is not None:
            self.observe_history()
        # flush the final histogram state into the event stream before the
        # sinks close: one ``hist`` event per (kind, key), so a JSONL trace
        # carries the latency distributions ``tools/trace_report.py`` renders
        # as percentile columns (bucket counts ride sparse — mostly zeros)
        for kind, keys in self.histograms.snapshot().items():
            for key, hist in keys.items():
                if hist.count:
                    self._event("hist", key, kind, payload=hist.summary())
        for sink in self.sinks:
            sink.close()


# Session epochs make metric identity stamps self-invalidating across sessions
# (a stale stamp from a dead session or an unpickled metric never collides).
_SESSION_EPOCHS = itertools.count()

# The one module attribute the hot paths read. ``None`` == disabled: the
# dispatch path takes a single pointer-compare branch and does nothing else.
_ACTIVE: Optional[TelemetryRecorder] = None


def active() -> Optional[TelemetryRecorder]:
    """The currently active recorder, or ``None`` when telemetry is disabled."""
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def enable(config: Optional[TelemetryConfig] = None) -> TelemetryRecorder:
    """Start a process-wide telemetry session (replaces any active one)."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.close()
    _ACTIVE = TelemetryRecorder(config)
    return _ACTIVE


def disable() -> Optional[TelemetryRecorder]:
    """End the session; returns the (closed) recorder for post-hoc inspection."""
    global _ACTIVE
    rec, _ACTIVE = _ACTIVE, None
    if rec is not None:
        rec.close()
    return rec


def cost_snapshot() -> Dict[str, Any]:
    """The active session's per-key costs (empty when disabled)."""
    return _ACTIVE.cost_snapshot() if _ACTIVE is not None else {}


def gather_counters(
    snapshot: Optional[CountersSnapshot] = None,
    process_group: Any = None,
    dist_sync_fn: Any = None,
    prefer_sync_rows: bool = True,
) -> FleetSnapshot:
    """Gather this process's counters across all ranks and merge them.

    The payload is metadata-sized — one int64 vector of :data:`COUNTER_FIELDS`
    per rank — and rides the coalesced gather plane. When a coalesced sync
    already ran under the active session, its metadata collective carried
    every rank's counter vector, so this rollup reuses those rows and launches
    **zero extra collectives** (the local row is refreshed from ``snapshot``;
    remote rows are as of each rank's last sync — pass
    ``prefer_sync_rows=False`` to force a fresh collective). Otherwise one
    ``gather_metadata_vector`` collective runs (``dist_sync_fn`` is the usual
    injection seam and always bypasses the cached rows). With one process (or
    no snapshot source) this degrades to a single-rank fleet view. Remote
    ranks contribute counts only; per-key dispatch records stay local (strings
    don't ride the array gather), so the merged ``per_key`` covers this rank
    alone.
    """
    if snapshot is None:
        if _ACTIVE is None:
            raise RuntimeError("gather_counters needs an active telemetry session or an explicit snapshot")
        snapshot = _ACTIVE.counters.snapshot()
    from ..parallel import coalesce as _coalesce  # lazy: parallel imports this module
    from ..parallel import sync as _sync

    rows: Any = None
    my_rank: Optional[int] = None
    # cached rows describe the LAST sync's whole-world metadata collective: an
    # explicit process_group (a different scope) or injected gather always
    # forces a fresh collective
    if prefer_sync_rows and dist_sync_fn is None and process_group is None:
        cached = _coalesce.fleet_counter_rows()
        if cached is not None:
            rows, my_rank = cached
    if rows is None:
        rows = _sync.gather_metadata_vector(
            snapshot.counts_vector(), process_group=process_group, dist_sync_fn=dist_sync_fn
        )
        for i, row in enumerate(rows):  # re-attach local per-key records to our own row
            if row == snapshot.counts_vector() and my_rank is None:
                my_rank = i
    ranks: list = list(rows)
    if my_rank is not None and 0 <= my_rank < len(ranks):
        ranks[my_rank] = snapshot
    return aggregate_counters(ranks)


def gather_histograms(
    vector: Optional[list] = None,
    process_group: Any = None,
    dist_sync_fn: Any = None,
    prefer_sync_rows: bool = True,
) -> Dict[str, Histogram]:
    """Merge every rank's per-kind latency/size histograms into fleet
    distributions (``{kind: Histogram}`` — p99 across the POD, not per host).

    Same transport contract as :func:`gather_counters`: the payload is one int
    vector of :data:`histograms.FLEET_VECTOR_LEN` entries per rank (fieldwise
    sum IS the exact merge), and a coalesced sync under the active session
    already shipped every rank's vector inside its metadata collective — this
    rollup reuses those rows and launches **zero extra collectives** (local
    row refreshed live; remote rows as of each rank's last sync; pass
    ``prefer_sync_rows=False`` to force a fresh ``gather_metadata_vector``
    collective). Per-key histograms stay local, like per-key dispatch records.
    """
    if vector is None:
        if _ACTIVE is None:
            raise RuntimeError("gather_histograms needs an active telemetry session or an explicit vector")
        vector = _ACTIVE.histograms.fleet_vector()
    from ..parallel import coalesce as _coalesce  # lazy: parallel imports this module
    from ..parallel import sync as _sync

    rows: Any = None
    my_rank: Optional[int] = None
    if prefer_sync_rows and dist_sync_fn is None and process_group is None:
        cached = _coalesce.fleet_histogram_rows()
        if cached is not None:
            rows, my_rank = cached
    if rows is None:
        rows = _sync.gather_metadata_vector(
            vector, process_group=process_group, dist_sync_fn=dist_sync_fn
        )
    else:
        rows = list(rows)
        if my_rank is not None and 0 <= my_rank < len(rows):
            rows[my_rank] = vector  # local row refreshed from the live registry
    return aggregate_histograms(rows)


@contextlib.contextmanager
def telemetry_session(config: Optional[TelemetryConfig] = None) -> Iterator[TelemetryRecorder]:
    """``with telemetry_session() as rec: ...`` — enable for the block, always
    disable after (the recorder stays readable)."""
    rec = enable(config)
    try:
        yield rec
    finally:
        if _ACTIVE is rec:
            disable()
        else:  # a nested enable() replaced us — don't kill the newer session
            rec.close()
