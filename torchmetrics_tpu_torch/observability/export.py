"""Prometheus-style export: text rendering, background flusher, health server.

Three pieces, all fed from **snapshots** so the hot path is never touched:

- :func:`render_prometheus` — the active session's counters, cost totals,
  state-memory footprints, histograms, and SLO states as Prometheus text
  exposition format (``# HELP``/``# TYPE`` + samples; histograms as the
  standard cumulative ``_bucket{le=…}`` / ``_sum`` / ``_count`` triplet, with
  latency buckets converted to seconds per Prometheus convention).
- :class:`MetricsFlusher` — a daemon thread that periodically snapshots the
  recorder, renders, and atomically replaces a file on disk (write-new +
  ``os.replace``, so a scraping sidecar never reads a torn file). The flusher
  also feeds/evaluates the SLO engine on its own cadence, which keeps rules
  live even in loops that never sync.
- :class:`HealthServer` — a stdlib ``ThreadingHTTPServer`` serving
  ``/healthz`` (liveness + SLO verdict; 503 while a *critical* rule is
  breached), ``/metricsz`` (the Prometheus text), ``/costz`` (compiled-cost
  accounting as JSON), ``/sloz`` (rule states + recent alerts as JSON),
  ``/fleetz`` (the live fleet controller's rollup), and ``/historyz`` (the
  telemetry history's retained levels; ``?at=``/``?level=`` time-travel
  queries) — each request takes fresh snapshots, so what a scraper sees is
  live. The full endpoint table lives in ``docs/observability.md``.

The prefix, the sample names and the help text are the JAX package's, byte for
byte (its ``jit_*`` help included), so one scraper reads both packages alike.
``/fleetz`` serves the live ``fleet.FleetController``'s ``telemetry()`` rollup, and
``{"fleet": false}`` while no controller is live.

Everything degrades gracefully with no active session: the renderer emits the
``telemetry_enabled 0`` gauge and whatever a passed-in recorder holds; the
server answers 200/ok with ``"telemetry": false``.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from . import histograms as _histograms

# every exported sample name carries this prefix (Prometheus namespacing)
PREFIX = "tpu_metrics"

_COUNTER_HELP = {
    "dispatches": "jitted donated dispatches (update/forward tensor path)",
    "jit_compiles": "first-seen (key, signature) pairs — one XLA trace each",
    "jit_cache_hits": "repeat signatures served from jit's cache",
    "retraces": "compiles beyond a key's first (shape/dtype churn)",
    "d2h_readbacks": "instrumented device-to-host transfers",
    "sync_calls": "process_sync invocations",
    "sync_collectives": "collectives launched by the sync planes",
    "retries": "transient failures accepted for retry",
    "retries_exhausted": "retry budgets exhausted on a transient failure",
    "quarantines": "metrics frozen by on_error='quarantine'",
    "state_growths": "cat states past the unbounded-growth sentinel",
    "alerts": "SLO alerts emitted",
    "flightrec_dumps": "postmortem artifacts dumped by the flight recorder",
}


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _sanitize_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _fmt(value: Any) -> str:
    if value is None:
        return "NaN"
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Lines:
    """Accumulates exposition lines with one HELP/TYPE header per family."""

    def __init__(self) -> None:
        self.lines: List[str] = []
        self._seen: set = set()

    def header(self, name: str, kind: str, help_text: str) -> None:
        if name in self._seen:
            return
        self._seen.add(name)
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {kind}")

    def sample(self, name: str, labels: Dict[str, str], value: Any) -> None:
        if labels:
            inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in labels.items())
            self.lines.append(f"{name}{{{inner}}} {_fmt(value)}")
        else:
            self.lines.append(f"{name} {_fmt(value)}")

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def _render_histogram(out: _Lines, family: str, help_text: str, unit_div: float,
                      labels: Dict[str, str], hist: "_histograms.Histogram") -> None:
    """One histogram in the standard cumulative form. ``unit_div`` converts
    the bucket bounds out of the recording unit (1e6 for us→seconds, 1 for
    bytes)."""
    out.header(family, "histogram", help_text)
    cum = 0
    # the top bucket is open-ended (bucket_index clamps overflows into it), so
    # it gets NO finite le line — claiming its observations are <= 2^32 units
    # would break cumulative semantics; +Inf is its honest upper bound
    for b, count in enumerate(hist.counts[: _histograms.N_BUCKETS - 1]):
        cum += count
        if count == 0 and b > 0:
            continue  # sparse: always emit the first bound, skip empty middles
        le = _histograms.bucket_bounds(b)[1] / unit_div
        out.sample(f"{family}_bucket", {**labels, "le": repr(float(le))}, cum)
    out.sample(f"{family}_bucket", {**labels, "le": "+Inf"}, hist.count)
    out.sample(f"{family}_sum", labels, hist.total / unit_div)
    out.sample(f"{family}_count", labels, hist.count)


def render_prometheus(recorder: Any = None) -> str:
    """Render a recorder's full state (counters, costs, memory, histograms,
    SLOs) as Prometheus text exposition format. ``recorder=None`` uses the
    active session (and renders a minimal liveness document when telemetry is
    disabled)."""
    from . import active as _active

    rec = recorder if recorder is not None else _active()
    out = _Lines()
    out.header(f"{PREFIX}_telemetry_enabled", "gauge", "1 while a telemetry session is active")
    out.sample(f"{PREFIX}_telemetry_enabled", {}, 0 if rec is None else 1)
    if rec is None:
        return out.render()

    snap = rec.counters.snapshot()
    for field, value in snap.counts.items():
        name = f"{PREFIX}_{_sanitize_name(field)}_total"
        out.header(name, "counter", _COUNTER_HELP.get(field, f"session counter {field}"))
        out.sample(name, {}, value)
    syncs = snap.counts.get("sync_calls", 0)
    name = f"{PREFIX}_collectives_per_sync"
    out.header(name, "gauge", "collectives launched per sync (coalescing headline)")
    out.sample(name, {}, (snap.counts.get("sync_collectives", 0) / syncs) if syncs else 0.0)

    totals = snap.cost_totals() if snap.costs else {}
    for field, value in totals.items():
        name = f"{PREFIX}_cost_{_sanitize_name(field)}"
        out.header(name, "gauge", f"dispatch-weighted compiled-cost total: {field}")
        out.sample(name, {}, value)

    mem = rec.memory_snapshot()
    if mem:
        cur = f"{PREFIX}_state_bytes"
        peak = f"{PREFIX}_state_peak_bytes"
        out.header(cur, "gauge", "current metric state footprint (metadata-derived bytes)")
        out.header(peak, "gauge", "peak metric state footprint this session")
        for metric_name, report in mem.items():
            out.sample(cur, {"metric": metric_name}, report.get("current_bytes", 0))
            out.sample(peak, {"metric": metric_name}, report.get("peak_bytes", 0))

    lat_family = f"{PREFIX}_latency_seconds"
    size_family = f"{PREFIX}_size_bytes"
    for kind, keys in sorted(rec.histograms.snapshot().items()):
        is_size = kind in _histograms.SIZE_KINDS
        for key, hist in sorted(keys.items()):
            _render_histogram(
                out,
                size_family if is_size else lat_family,
                "sync-plane payload size distribution" if is_size
                else "dispatch-boundary latency distribution (log2 buckets)",
                1.0 if is_size else 1e6,
                {"kind": kind, "key": key},
                hist,
            )

    slo = rec.slo.snapshot()
    if slo["rules"]:
        breached = f"{PREFIX}_slo_breached"
        trips = f"{PREFIX}_slo_breaches_total"
        alerts = f"{PREFIX}_slo_alerts_total"
        out.header(breached, "gauge", "1 while the rule's expression currently evaluates true")
        out.header(trips, "counter", "evaluations that found the rule breached")
        out.header(alerts, "counter", "alerts actually emitted (cooldown-gated)")
        for rule_name, state in slo["rules"].items():
            labels = {"rule": rule_name, "severity": state["severity"]}
            out.sample(breached, labels, 1 if state["breached"] else 0)
            out.sample(trips, labels, state["breaches"])
            out.sample(alerts, labels, state["alerts"])
    return out.render()


# ---------------------------------------------------------------------------
# background flusher
# ---------------------------------------------------------------------------


class MetricsFlusher:
    """Periodically render the active session to ``path`` from a daemon
    thread — the scrape file a node-exporter-style sidecar tails, produced
    without ever touching the dispatch hot path.

    Each tick: snapshot → render → write ``path + ".tmp"`` → ``os.replace``
    (atomic on POSIX, so readers never see a torn document), then feed and
    evaluate the SLO engine (keeping rules live for loops that never sync).
    ``interval_s`` is wall-clock between ticks; ``flush_now()`` forces one
    synchronously (also what ``stop()`` does on the way out, so the file's
    final state covers the whole session).
    """

    def __init__(self, path: str, interval_s: float = 5.0) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.path = str(path)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._flush_lock = threading.Lock()  # worker tick vs stop()'s final flush
        self.flushes = 0

    def flush_now(self) -> str:
        """One synchronous snapshot→render→atomic-replace; returns the text.
        Serialized against the worker thread, and each write uses its own tmp
        name — two flushes can never interleave bytes into one tmp file, so
        ``os.replace`` always publishes a complete document."""
        from . import active as _active

        rec = _active()
        if rec is not None and rec.slo.rules:
            rec.evaluate_slos()
        text = render_prometheus(rec)
        with self._flush_lock:
            tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.write(text)
                os.replace(tmp, self.path)
            finally:
                if os.path.exists(tmp):  # a failed replace must not leave droppings
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
            self.flushes += 1
        return text

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.flush_now()
            except Exception:  # noqa: BLE001 — a flush hiccup must not kill the thread
                continue

    def start(self) -> "MetricsFlusher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="tpu-metrics-flusher", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)
            self._thread = None
        try:
            self.flush_now()  # final state on disk covers the whole session
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self) -> "MetricsFlusher":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# health endpoint (stdlib http.server)
# ---------------------------------------------------------------------------


def _healthz_doc() -> Tuple[int, Dict[str, Any]]:
    from . import active as _active

    rec = _active()
    if rec is None:
        return 200, {"status": "ok", "telemetry": False}
    rec.evaluate_slos()  # the liveness answer reflects the rules RIGHT NOW
    critical = rec.slo.breached(min_severity="critical")
    breached = rec.slo.breached()
    doc = {
        "status": "critical" if critical else ("degraded" if breached else "ok"),
        "telemetry": True,
        "breached_rules": breached,
        "counters": rec.counters.snapshot().summary(brief=True),
    }
    return (503 if critical else 200), doc


def _costz_doc() -> Tuple[int, Dict[str, Any]]:
    from . import active as _active

    rec = _active()
    if rec is None:
        return 200, {"telemetry": False}
    return 200, {
        "telemetry": True,
        "cost_totals": rec.cost_summary(),
        "per_key": rec.cost_snapshot(),
        "state_memory": rec.memory_snapshot(),
    }


def _sloz_doc() -> Tuple[int, Dict[str, Any]]:
    from . import active as _active

    rec = _active()
    if rec is None:
        return 200, {"telemetry": False}
    rec.evaluate_slos()
    return 200, {"telemetry": True, **rec.slo_snapshot()}


def _fleetz_doc() -> Tuple[int, Dict[str, Any]]:
    """The fleet control tower: the live controller's rollup, if one exists.

    The controller registers itself weakly at construction (cleared on
    ``close()``); the lazy import keeps the health plane importable without
    the fleet/serving stack."""
    try:
        from ..fleet import controller as _fleet_controller
    except Exception:  # noqa: BLE001 — health must answer even if fleet can't import
        return 200, {"fleet": False}
    fc = _fleet_controller.active_controller()
    if fc is None:
        return 200, {"fleet": False}
    return 200, {"fleet": True, **fc.telemetry()}


def _historyz_doc(query: str) -> Tuple[int, Dict[str, Any]]:
    """The telemetry-history time machine over HTTP.

    No params: every retained level with its block boundaries
    (``history.levels()``). ``?at=T``: the finest retained block covering
    instant ``T`` — byte-for-byte what ``history.at(T)`` answers in-process.
    ``?level=i``: that level's blocks only. Degrades to
    ``{"telemetry": false}`` with no active session (or history disabled)."""
    from . import active as _active

    rec = _active()
    if rec is None or rec.history is None:
        return 200, {"telemetry": False}
    params = urllib.parse.parse_qs(query)
    if "at" in params:
        try:
            t = float(params["at"][0])
        except (ValueError, IndexError):
            return 400, {"telemetry": True, "error": "?at= expects a float timestamp"}
        return 200, {"telemetry": True, "at": t, "block": rec.history.at(t)}
    if "level" in params:
        try:
            level = int(params["level"][0])
            blocks = rec.history.range(float("-inf"), float("inf"), level=level)
        except (ValueError, IndexError):
            return 400, {"telemetry": True, "error": "?level= expects a valid level index"}
        return 200, {"telemetry": True, "level": level, "blocks": blocks}
    return 200, {"telemetry": True, "history": rec.history.levels()}


class _HealthHandler(BaseHTTPRequestHandler):
    server_version = "tpu-metrics-health/1"

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0].rstrip("/") or "/healthz"
        try:
            if path == "/healthz":
                status, doc = _healthz_doc()
                self._reply(status, json.dumps(doc, default=str), "application/json")
            elif path == "/metricsz":
                self._reply(200, render_prometheus(), "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/costz":
                status, doc = _costz_doc()
                self._reply(status, json.dumps(doc, default=str), "application/json")
            elif path == "/sloz":
                status, doc = _sloz_doc()
                self._reply(status, json.dumps(doc, default=str), "application/json")
            elif path == "/fleetz":
                status, doc = _fleetz_doc()
                self._reply(status, json.dumps(doc, default=str), "application/json")
            elif path == "/historyz":
                query = self.path.split("?", 1)[1] if "?" in self.path else ""
                status, doc = _historyz_doc(query)
                self._reply(status, json.dumps(doc, default=str), "application/json")
            else:
                self._reply(
                    404,
                    json.dumps({"error": f"unknown path {path}",
                                "endpoints": ["/healthz", "/metricsz", "/costz",
                                              "/sloz", "/fleetz", "/historyz"]}),
                    "application/json",
                )
        except Exception as err:  # noqa: BLE001 — a render bug must answer 500, not hang
            self._reply(500, json.dumps({"error": f"{type(err).__name__}: {err}"[:500]}),
                        "application/json")

    def _reply(self, status: int, body: str, content_type: str) -> None:
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt: str, *args: Any) -> None:  # silence per-request stderr
        pass


class HealthServer:
    """The live health endpoint: ``ThreadingHTTPServer`` on a daemon thread,
    answering from fresh snapshots of whatever telemetry session is active at
    request time (it holds no recorder reference — sessions can come and go
    under a long-lived server).

    ``port=0`` binds an ephemeral port (tests); :attr:`port` is the bound one.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        self._httpd = ThreadingHTTPServer((host, port), _HealthHandler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "HealthServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="tpu-metrics-health", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "HealthServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
