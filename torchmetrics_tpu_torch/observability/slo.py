"""Declarative SLO rules and the alert engine.

An operable metric service needs its "is it healthy" question answered by the
runtime, not by a human reading counters. A :class:`SloRule` is one declarative
statement of health — a boolean expression over **windowed counter deltas and
histogram percentiles** — plus the operational envelope around it: how much
history the expression sees (``window``), how loud a breach is (``severity``),
and how often it may page (``cooldown``). The engine evaluates rules against a
rolling ring of samples the recorder feeds it; a breach emits an ``alert``
:class:`~torchmetrics_tpu_torch.observability.events.TelemetryEvent`, a rank-zero
warning, and — optionally — a degradation callback (the seam for "quarantine
the collection when the retry rate stays breached").

Expression namespace (everything is computed over the rule's window):

- every counter field by name (``retries``, ``dispatches``, ``sync_calls``,
  ``retraces``, ``state_growths``, ...) — the **delta** over the window;
- ``total(name)`` — the absolute counter value at evaluation time;
- ``p50(kind)`` / ``p95(kind)`` / ``p99(kind)`` / ``p999(kind)`` — percentile
  estimate of the window's histogram delta for a
  :data:`~torchmetrics_tpu_torch.observability.histograms.FLEET_HISTOGRAM_KINDS`
  kind, in the kind's unit (microseconds for latencies, bytes for sizes);
  ``0.0`` when the window recorded nothing of that kind (a no-data window
  never breaches a ``>`` threshold);
- ``collectives_per_sync`` — the derived coalescing headline over the window;
- ``drift(name)`` — the latest score a
  :class:`~torchmetrics_tpu_torch.streaming.DriftMonitor` recorded under ``name``
  (``0.0`` when none ran) — lets an SLO rule page on sustained drift, e.g.
  ``drift('accuracy') > 0.1 and drift_evals > 3``;
- ``window`` — the seconds of history actually covered (shorter than the
  configured window early in a session);
- ``max`` / ``min`` / ``abs`` — the only builtins exposed.

Expressions are evaluated with ``eval`` under an empty ``__builtins__`` — they
are operator-authored configuration, not untrusted input (the same trust level
as a ``dist_sync_fn``). A rule whose expression raises is reported once as a
``rule_error`` alert and then disabled for the session — a typo must not
silently disable monitoring OR crash the loop being monitored.

Evaluation is **pull-based and off the hot path**: the recorder feeds a sample
and evaluates at sync boundaries (low-frequency, already collective-shaped),
and the export layer's background flusher / health server evaluate on their own
cadence. With telemetry disabled nothing here runs at all (guarded by the
zero-overhead test).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Sequence, Tuple

from ..utilities.prints import rank_zero_warn
from . import histograms as _histograms
from .counters import COUNTER_FIELDS

SEVERITIES = ("info", "warning", "critical")


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One declarative health rule.

    Args:
        name: stable identifier (alert events and ``/sloz`` key on it).
        expr: boolean expression over the windowed namespace (module docs).
            ``True`` == breached.
        window: seconds of history the expression's deltas/percentiles cover.
        severity: ``"info"`` / ``"warning"`` / ``"critical"`` — ``critical``
            breaches flip the health endpoint to 503.
        cooldown: seconds after an alert during which the rule stays silent
            (it keeps *evaluating* — ``breached`` state stays live — but emits
            no new alert/callback; alert storms page nobody usefully).
        description: human text carried on the alert.
        on_breach: optional degradation callback ``fn(alert_dict)`` — e.g.
            quarantine a collection on a sustained retry-rate breach. Runs
            after the alert event/warning; exceptions are caught and attached
            to the alert (a broken remediation must not take down the sync
            path that triggered evaluation).
    """

    name: str
    expr: str
    window: float = 60.0
    severity: str = "warning"
    cooldown: float = 300.0
    description: str = ""
    on_breach: Optional[Callable[[Dict[str, Any]], None]] = None

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, got {self.severity!r}")
        if self.window <= 0:
            raise ValueError(f"window must be > 0, got {self.window}")
        if self.cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {self.cooldown}")
        compile(self.expr, f"<SloRule {self.name}>", "eval")  # syntax errors fail at construction


def default_rules(
    collectives_per_sync_max: float = 8.0,
    retrace_window_max: int = 8,
    update_p99_us_max: float = 200_000.0,
    retry_rate_max: float = 0.10,
) -> Tuple[SloRule, ...]:
    """The shipped rule pack — the five failure modes this runtime has actually
    hit, thresholded loosely enough to stay quiet on a healthy run:

    - ``collectives_per_sync``: the coalesced plane regressing toward per-leaf
      collectives (the `collection_sync_16metrics` bench gates the same drift);
    - ``retrace_storm``: shape-unstable inputs recompiling per batch;
    - ``update_p99_latency``: dispatch tail blowing past the envelope;
    - ``retry_rate``: sustained transient-failure churn (the degradation-
      callback candidate: quarantine before the budget exhausts mid-eval);
    - ``state_growth``: a cat state crossing the unbounded-growth sentinel.
    """
    return (
        SloRule(
            name="collectives_per_sync",
            expr=f"sync_calls > 0 and sync_collectives / sync_calls > {collectives_per_sync_max}",
            window=120.0,
            severity="warning",
            description="sync plane drifting from coalesced buckets back toward per-leaf collectives",
        ),
        SloRule(
            name="retrace_storm",
            expr=f"retraces > {retrace_window_max}",
            window=120.0,
            severity="warning",
            description="recompile churn: many new input shape/dtype signatures in the window",
        ),
        SloRule(
            name="update_p99_latency",
            expr=f"p99('update') > {update_p99_us_max}",
            window=60.0,
            severity="warning",
            description="update dispatch p99 latency over budget (us)",
        ),
        SloRule(
            name="retry_rate",
            expr=(
                "retries >= 3 and "
                f"retries / max(dispatches + host_dispatches + sync_calls, 1) > {retry_rate_max}"
            ),
            window=120.0,
            severity="critical",
            description="sustained transient-failure retry churn",
        ),
        SloRule(
            name="state_growth",
            expr="state_growths > 0",
            window=3600.0,
            severity="critical",
            description="a list/cat state crossed the unbounded-growth threshold",
        ),
    )


@dataclasses.dataclass
class _RuleState:
    breached: bool = False
    breaches: int = 0  # evaluations that found the expression true
    alerts: int = 0  # alerts actually emitted (cooldown-gated)
    last_alert_at: Optional[float] = None
    last_value_at: Optional[float] = None
    error: Optional[str] = None  # expression error — rule disabled for the session


# sample-ring bounds: enough resolution for any window, never unbounded growth
# on a high-frequency sync loop (each sample is a counters dict + fleet vector)
_MAX_SAMPLES = 512


class SloEngine:
    """Rolling-window evaluator over (counter snapshot, histogram vector)
    samples. One engine per telemetry session; the recorder owns it.

    Thread-safe: the training thread (sync boundaries), the export flusher,
    and health-server request threads all evaluate concurrently — one reentrant
    lock covers the sample ring, the cooldown bookkeeping (so an alert and its
    degradation callback fire exactly once per cooldown window), and the
    snapshots the endpoints render."""

    def __init__(self, rules: Sequence[SloRule] = ()) -> None:
        self.rules: Tuple[SloRule, ...] = tuple(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SloRule names: {sorted(names)}")
        # reentrant: an on_breach callback may legitimately read snapshot()
        self._lock = threading.RLock()
        self._states: Dict[str, _RuleState] = {r.name: _RuleState() for r in self.rules}
        # ring of (monotonic_t, counts_dict, fleet_hist_vector); pruned to the
        # longest rule window on every append
        self._samples: Deque[Tuple[float, Dict[str, int], List[int]]] = collections.deque()
        self._max_window = max((r.window for r in self.rules), default=0.0)
        self._alerts: Deque[Dict[str, Any]] = collections.deque(maxlen=256)
        # the implicit session-start sample: all-zero counters/histograms. A
        # young session (or one that never observes) deltas against THIS, so
        # the first evaluation after a breach already sees it instead of
        # comparing the current state against itself.
        self._genesis: Optional[Tuple[float, Dict[str, int], List[int]]] = None
        # burn(expr, ...) sub-expressions, compiled once per distinct string
        self._burn_codes: Dict[str, Any] = {}

    # ------------------------------------------------------------- sampling

    def _sample(self, recorder: Any, now: float) -> Tuple[float, Dict[str, int], List[int]]:
        counts = dict(zip(COUNTER_FIELDS, recorder.counters.counts_vector()))
        return (now, counts, recorder.histograms.fleet_vector())

    def _ensure_genesis(self, t: float) -> None:
        if self._genesis is None:
            self._genesis = (
                t,
                {f: 0 for f in COUNTER_FIELDS},
                [0] * _histograms.FLEET_VECTOR_LEN,
            )

    def observe(
        self,
        recorder: Any,
        now: Optional[float] = None,
        sample: Optional[Tuple[float, Dict[str, int], List[int]]] = None,
    ) -> None:
        """Append one sample (and prune history past the longest window)."""
        if not self.rules:
            return
        from . import tracing

        t = tracing.monotonic() if now is None else now
        if sample is None:
            sample = self._sample(recorder, t)
        with self._lock:
            self._ensure_genesis(t)
            # thin by spacing so a per-batch sync loop cannot grow the ring
            # unboundedly: ~_MAX_SAMPLES samples cover the longest window with
            # plenty of baseline resolution (genesis covers young sessions)
            spacing = self._max_window / (_MAX_SAMPLES / 2)
            if self._samples and t - self._samples[-1][0] < spacing:
                return
            self._samples.append(sample)
            # keep one sample OLDER than the window so a full window always has
            # a baseline (delta against the sample just before the window edge)
            while len(self._samples) > 2 and self._samples[1][0] <= t - self._max_window:
                self._samples.popleft()
            while len(self._samples) > _MAX_SAMPLES:  # hard backstop
                self._samples.popleft()

    # ------------------------------------------------------------ evaluation

    @staticmethod
    def _namespace(
        current: Tuple[float, Dict[str, int], List[int]],
        baseline: Tuple[float, Dict[str, int], List[int]],
    ) -> Dict[str, Any]:
        t1, counts1, hist1 = current
        t0, counts0, hist0 = baseline
        delta = {f: counts1[f] - counts0.get(f, 0) for f in COUNTER_FIELDS}
        hist_delta = [a - b for a, b in zip(hist1, hist0)]
        kinds = _histograms.decode_fleet_vector(hist_delta)

        def pct(q: float) -> Callable[[str], float]:
            def f(kind: str) -> float:
                hist = kinds.get(kind)
                if hist is None:
                    raise NameError(
                        f"unknown histogram kind {kind!r}; known: {_histograms.FLEET_HISTOGRAM_KINDS}"
                    )
                est = hist.percentile(q)
                return 0.0 if est is None else est

            return f

        syncs = delta.get("sync_calls", 0)
        ns: Dict[str, Any] = dict(delta)
        ns.update(
            total=lambda name: counts1[name],
            p50=pct(0.50), p95=pct(0.95), p99=pct(0.99), p999=pct(0.999),
            collectives_per_sync=(delta.get("sync_collectives", 0) / syncs) if syncs else 0.0,
            # floored at 1s: a session's first evaluation shares the genesis
            # timestamp, and a rate rule dividing by `window` must neither
            # ZeroDivisionError (killing the rule for the session) nor see a
            # microscopic window that inflates any delta into a breach
            window=max(t1 - t0, 1.0),
            max=max, min=min, abs=abs,
        )
        return ns

    def _baseline_at(self, now: float, window: float) -> Tuple[float, Dict[str, int], List[int]]:
        """Newest sample at or older than ``now - window`` (so the delta
        covers at least the window); a session younger than the window deltas
        against the zero genesis sample (= everything since session start)."""
        edge = now - window
        chosen = self._genesis
        for sample in self._samples:
            if sample[0] <= edge:
                chosen = sample
            else:
                break
        return chosen

    def _baseline_for(self, rule: SloRule, now: float) -> Tuple[float, Dict[str, int], List[int]]:
        return self._baseline_at(now, rule.window)

    def observe_and_evaluate(self, recorder: Any, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Feed the window and evaluate in one step, building the (counters +
        histograms) sample ONCE — the per-sync heartbeat path, where walking
        both registries twice back-to-back would be pure waste."""
        if not self.rules:
            return []
        from . import tracing

        t = tracing.monotonic() if now is None else now
        sample = self._sample(recorder, t)
        self.observe(recorder, now=t, sample=sample)
        return self.evaluate(recorder, now=t, sample=sample)

    def evaluate(
        self,
        recorder: Any,
        now: Optional[float] = None,
        sample: Optional[Tuple[float, Dict[str, int], List[int]]] = None,
    ) -> List[Dict[str, Any]]:
        """Evaluate every rule against the current state (or an explicit
        ``sample``); returns the alerts emitted by THIS evaluation (already
        recorded/emitted via the recorder). Safe to call from any thread;
        cheap when no rules are configured."""
        if not self.rules:
            return []
        from . import tracing

        t = tracing.monotonic() if now is None else now
        current = sample if sample is not None else self._sample(recorder, t)
        fired: List[Dict[str, Any]] = []
        callbacks: List[Tuple[SloRule, Dict[str, Any]]] = []
        with self._lock:
            self._ensure_genesis(t)
            for rule in self.rules:
                state = self._states[rule.name]
                if state.error is not None:
                    continue
                ns = self._namespace(current, self._baseline_for(rule, t))
                self._inject_gauges(ns, recorder)
                burn_state = self._inject_timetravel(ns, recorder, current, t, rule)
                try:
                    breached = bool(eval(rule.expr, {"__builtins__": {}}, ns))  # noqa: S307 — operator config
                except Exception as err:
                    state.error = f"{type(err).__name__}: {err}"[:240]
                    state.breached = False
                    alert = self._emit(recorder, rule, t, kind="rule_error", error=state.error)
                    fired.append(alert)
                    continue
                state.breached = breached
                state.last_value_at = t
                if not breached:
                    continue
                state.breaches += 1
                if state.last_alert_at is not None and t - state.last_alert_at < rule.cooldown:
                    continue  # cooling down: stay breached, page nobody
                state.last_alert_at = t
                state.alerts += 1
                alert = self._emit(recorder, rule, t, kind="breach", window=ns["window"])
                if burn_state["burned"]:
                    # a multi-window burn page rides the SAME cooldown as the
                    # alert above — exactly once per cooldown, never flapping
                    alert["burn"] = {"short": burn_state["short"], "long": burn_state["long"]}
                    self._emit_burn(recorder, rule, t, burn_state)
                if rule.on_breach is not None:
                    callbacks.append((rule, alert))
                fired.append(alert)
        # degradation callbacks run OUTSIDE the lock: a slow remediation (a
        # pager call, a quarantine sweep) fired from a server/flusher thread
        # must not block the training thread's sync-boundary evaluation
        for rule, alert in callbacks:
            try:
                rule.on_breach(alert)
            except Exception as err:  # noqa: BLE001 — remediation must not kill the sync path
                alert["callback_error"] = f"{type(err).__name__}: {err}"[:240]
        return fired

    @staticmethod
    def _inject_gauges(ns: Dict[str, Any], recorder: Any) -> None:
        # drift scores are recorder-local gauges (not window deltas): the
        # namespace exposes the latest value a DriftMonitor recorded under
        # each name
        drift_fn = getattr(recorder, "drift_score", None)
        if drift_fn is not None:
            ns["drift"] = drift_fn
        # the quantized sync plane's error-feedback residual norm is a
        # SCALAR gauge (unlike drift's per-name lookup), so expose the
        # value itself — rules write `quant_feedback_norm > 1e-3`
        quant_fn = getattr(recorder, "quant_feedback_norm", None)
        if quant_fn is not None:
            ns["quant_feedback_norm"] = quant_fn()

    def _inject_timetravel(
        self,
        ns: Dict[str, Any],
        recorder: Any,
        current: Tuple[float, Dict[str, int], List[int]],
        t: float,
        rule: SloRule,
    ) -> Dict[str, Any]:
        """``rate()``/``delta()``/``burn()`` — the telemetry-history plane's
        SLO face: windowed counter lookups at ARBITRARY windows over the
        sample ring (a plain name is always the delta over the rule's own
        window; these reach past it). Returns the burn bookkeeping cell the
        breach path reads to decide whether this alert is also a burn page."""
        _, counts1, _ = current
        burn_state: Dict[str, Any] = {"burned": False, "short": None, "long": None}

        def _delta(name: str, window: float) -> int:
            if name not in counts1:
                raise NameError(f"unknown counter {name!r}; known: {COUNTER_FIELDS}")
            _, counts0, _ = self._baseline_at(t, window)
            return counts1[name] - counts0.get(name, 0)

        def _rate(name: str, window: Optional[float] = None) -> float:
            """Per-second rate of a counter over ``window`` (default: the
            rule's own window), with the same 1s elapsed floor as ``window``."""
            if name not in counts1:
                raise NameError(f"unknown counter {name!r}; known: {COUNTER_FIELDS}")
            t0, counts0, _ = self._baseline_at(t, rule.window if window is None else window)
            return (counts1[name] - counts0.get(name, 0)) / max(t - t0, 1.0)

        def _burn(expr: str, short: float, long: float) -> bool:
            """Google-SRE multi-window burn rate: ``expr`` must hold over BOTH
            the short and the long window — a short spike alone never pages
            (the long window is clean), a slow burn alone never pages at the
            tail (the short window has recovered); both burning is the page."""
            code = self._burn_codes.get(expr)
            if code is None:
                code = self._burn_codes[expr] = compile(expr, f"<burn:{expr}>", "eval")
            burned = True
            for w in (short, long):
                wns = self._namespace(current, self._baseline_at(t, w))
                self._inject_gauges(wns, recorder)
                wns["rate"], wns["delta"] = _rate, _delta
                burned = bool(eval(code, {"__builtins__": {}}, wns)) and burned  # noqa: S307 — operator config
            if burned:
                burn_state.update(burned=True, short=short, long=long)
            return burned

        ns["rate"], ns["delta"], ns["burn"] = _rate, _delta, _burn
        return burn_state

    def _emit_burn(self, recorder: Any, rule: SloRule, t: float, burn_state: Dict[str, Any]) -> None:
        """The burn page itself, alongside the regular alert: its own event
        kind + counter so pager routing can treat a multi-window burn as the
        high-confidence page it is."""
        recorder.counters.record_burn_alert()
        recorder._event(
            "burn_alert", rule.name, rule.severity,
            payload={
                "kind": "burn",
                "short_window": burn_state["short"],
                "long_window": burn_state["long"],
                "at": t,
            },
        )

    def _emit(self, recorder: Any, rule: SloRule, t: float, kind: str, **extra: Any) -> Dict[str, Any]:
        alert: Dict[str, Any] = {
            "rule": rule.name,
            "severity": rule.severity,
            "kind": kind,
            "expr": rule.expr,
            "description": rule.description,
            "at": t,
            **extra,
        }
        self._alerts.append(alert)
        recorder.counters.record_alert()
        recorder._event(
            "alert", rule.name, rule.severity,
            payload={k: v for k, v in alert.items() if k not in ("rule",)},
        )
        if kind == "rule_error":
            rank_zero_warn(
                f"SLO rule {rule.name!r} raised while evaluating ({extra.get('error')}); "
                f"the rule is disabled for this session. Expression: {rule.expr!r}.",
                UserWarning,
            )
        else:
            rank_zero_warn(
                f"SLO breach [{rule.severity}] {rule.name}: {rule.description or rule.expr} "
                f"(window {rule.window:.0f}s, cooldown {rule.cooldown:.0f}s).",
                UserWarning,
            )
        return alert

    # -------------------------------------------------------------- reports

    def snapshot(self) -> Dict[str, Any]:
        """``/sloz``'s document: per-rule config + live state + recent alerts."""
        with self._lock:
            rules_out: Dict[str, Any] = {}
            for rule in self.rules:
                state = self._states[rule.name]
                rules_out[rule.name] = {
                    "expr": rule.expr,
                    "window": rule.window,
                    "severity": rule.severity,
                    "cooldown": rule.cooldown,
                    "description": rule.description,
                    "breached": state.breached,
                    "breaches": state.breaches,
                    "alerts": state.alerts,
                    "error": state.error,
                }
            return {
                "rules": rules_out,
                "recent_alerts": [dict(a) for a in self._alerts],
                "samples": len(self._samples),
            }

    def breached(self, min_severity: str = "info") -> List[str]:
        """Names of currently-breached rules at or above ``min_severity``."""
        floor = SEVERITIES.index(min_severity)
        with self._lock:
            return [
                r.name
                for r in self.rules
                if self._states[r.name].breached and SEVERITIES.index(r.severity) >= floor
            ]
