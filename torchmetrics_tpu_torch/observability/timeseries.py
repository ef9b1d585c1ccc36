"""Telemetry history plane: telescoping retention + time-travel queries.

Every other observability surface answers "what is true NOW"; a breach that
resolved before anyone looked, a slow leak, or a p99 degrading over an hour
is invisible to a point-in-time scrape. :class:`TelemetryHistory` retains the
session's own telemetry — counter DELTAS and per-kind histogram vector
deltas per retained block — in a telescoping level hierarchy
(:class:`~torchmetrics_tpu_torch.streaming.telescope.TelescopingFold`, default
1s → 10s → 1m → 1h): recent time at fine resolution, old time folded coarse,
total memory O(levels) instead of O(sum of windows). Both payloads are plain
mergeable integer vectors (the DrJAX-style reduction contract the fleet
rollup rides), so the fold IS exact elementwise addition and a retained
block is the exact telemetry delta over its time range.

The recorder feeds it at its sample choke points (every ``record_sync``
heartbeat — the same cadence the SLO engine samples on — plus session
close); ``history.at(t)`` / ``history.range(t0, t1, level=)`` answer
point-in-time queries over the retained boundaries, ``/historyz`` serves the
same answers over HTTP, and :meth:`TelemetryHistory.export_block` emits the
deterministic last-N-boundaries block that rides ``SoakReport.history`` and
flight-recorder artifacts (virtual-clock keyed in soaks, wall-clock counters
stripped — same byte-identical same-seed contract as the causal block).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

from .counters import COUNTER_FIELDS
from .histograms import _KIND_VEC_LEN, FLEET_HISTOGRAM_KINDS, FLEET_VECTOR_LEN, Histogram

# level spans the recorder retains by default: ten 1s blocks, six 10s blocks,
# sixty 1m blocks, twenty-four 1h blocks — ~100 blocks covering a full day,
# vs 86_400 for a naive 1s ring over the same span
DEFAULT_SPANS: Tuple[float, ...] = (1.0, 10.0, 60.0, 3600.0)

# one retained sample: (counter delta vector, fleet histogram delta vector)
_Sample = Tuple[List[int], List[int]]


def _merge_sample(a: _Sample, b: _Sample) -> _Sample:
    return (
        [x + y for x, y in zip(a[0], b[0])],
        [x + y for x, y in zip(a[1], b[1])],
    )


class TelemetryHistory:
    """Multi-resolution retention of one session's telemetry deltas.

    ``clock`` is the determinism seam: soak/fleet runs inject their virtual
    clock so block boundaries (and therefore the whole retained history) are
    a pure function of the seeded run; outside a soak it defaults to the
    monotonic clock every event timestamp already uses. Thread-safe — the
    training thread feeds while health-server request threads query.
    """

    def __init__(
        self,
        spans: Sequence[float] = DEFAULT_SPANS,
        keep: Optional[Sequence[int]] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        from ..streaming.telescope import TelescopingFold  # runtime import: the
        # streaming plane is imported only where a history is built, and observability
        # must stay importable mid-package-init (metric.py imports it first)

        self._lock = threading.Lock()
        self._fold = TelescopingFold(spans=spans, keep=keep, merge=_merge_sample)
        self._clock = clock
        self._last: Optional[Tuple[List[int], List[int]]] = None
        self._last_t: Optional[float] = None
        self.samples = 0

    @property
    def spans(self) -> Tuple[float, ...]:
        return self._fold.spans

    @property
    def folds(self) -> int:
        return self._fold.folds

    def _now(self) -> float:
        if self._clock is not None:
            return float(self._clock())
        from . import tracing

        return tracing.monotonic()

    # ------------------------------------------------------------------ feed

    def due(self, now: Optional[float] = None) -> bool:
        """Whether a NEW finest-span block has started since the last
        observation — the recorder's per-``record_sync`` heartbeat gates on
        this so the expensive vector snapshot is built at most once per
        finest block (deltas are cumulative: activity inside a skipped
        interval rides the next boundary observation, nothing is lost)."""
        t = self._now() if now is None else float(now)
        span = self.spans[0]
        with self._lock:
            return self._last_t is None or (t // span) != (self._last_t // span)

    def observe(
        self,
        counter_vec: Sequence[int],
        hist_vec: Sequence[int],
        now: Optional[float] = None,
    ) -> int:
        """Feed one ABSOLUTE sample (the live ``counts_vector()`` +
        ``fleet_vector()``); the history retains the delta since the previous
        observation, so a block's vectors are exactly the activity inside its
        time range. Returns how many blocks the feed closed (folds)."""
        cvec = [int(v) for v in counter_vec]
        hvec = [int(v) for v in hist_vec]
        if len(cvec) != len(COUNTER_FIELDS) or len(hvec) != FLEET_VECTOR_LEN:
            raise ValueError(
                f"history sample has {len(cvec)}/{len(hvec)} entries, expected "
                f"{len(COUNTER_FIELDS)}/{FLEET_VECTOR_LEN}"
            )
        t = self._now() if now is None else float(now)
        with self._lock:
            if self._last is None:
                delta = (cvec, hvec)  # first observation: delta vs session zero
            else:
                delta = (
                    [a - b for a, b in zip(cvec, self._last[0])],
                    [a - b for a, b in zip(hvec, self._last[1])],
                )
            self._last = (cvec, hvec)
            self._last_t = t
            self.samples += 1
            return self._fold.feed(t, delta)

    # --------------------------------------------------------------- queries

    @staticmethod
    def _block_doc(level: int, span: float, start: float, end: float, value: _Sample) -> Dict[str, Any]:
        cvec, hvec = value
        counters = {f: int(v) for f, v in zip(COUNTER_FIELDS, cvec) if v}
        hists: Dict[str, Any] = {}
        for i, kind in enumerate(FLEET_HISTOGRAM_KINDS):
            section = hvec[i * _KIND_VEC_LEN : (i + 1) * _KIND_VEC_LEN]
            if section[0]:
                hists[kind] = Histogram.from_vector(section).summary()
        return {
            "level": level,
            "span": span,
            "start": round(start, 6),
            "end": round(end, 6),
            "counters": counters,
            "histograms": hists,
        }

    def at(self, t: float) -> Optional[Dict[str, Any]]:
        """The finest retained block covering time ``t`` (counter deltas +
        histogram summaries over that block's range), or ``None`` when the
        history has telescoped past ``t`` or ``t`` is in the future."""
        with self._lock:
            hit = self._fold.at(float(t))
            if hit is None:
                return None
            level, start, end, value = hit
            return self._block_doc(level, self.spans[level], start, end, value)

    def range(self, t0: float, t1: float, level: int = 0) -> List[Dict[str, Any]]:
        """Blocks of one level overlapping ``[t0, t1)``, time-ordered."""
        with self._lock:
            span = self.spans[level]
            return [
                self._block_doc(level, span, s, e, v)
                for s, e, v in self._fold.range(float(t0), float(t1), level=level)
            ]

    def levels(self) -> Dict[str, Any]:
        """The whole retained hierarchy as one JSON document — ``/historyz``'s
        default body. Bounded by construction (O(levels) blocks), so serving
        it whole is cheap."""
        with self._lock:
            out_levels = []
            for i, span in enumerate(self.spans):
                blocks = [
                    self._block_doc(i, span, s, e, v) for s, e, v in self._fold.blocks(i)
                ]
                out_levels.append({"level": i, "span": span, "keep": self._fold.keep[i], "blocks": blocks})
            return {
                "spans": list(self.spans),
                "samples": self.samples,
                "folds": self._fold.folds,
                "blocks": self._fold.block_count(),
                "levels": out_levels,
            }

    def block_count(self) -> int:
        """Total retained blocks — the O(levels) memory pin."""
        with self._lock:
            return self._fold.block_count()

    # ------------------------------------------------------------ contractual

    def export_block(
        self, last_n: int = 8, drop: Iterable[str] = ()
    ) -> Dict[str, Any]:
        """The DETERMINISTIC history block for ``SoakReport.history`` and
        flight-recorder artifacts: per level, the last ``last_n`` retained
        boundaries with their counter deltas (minus the wall-clock fields in
        ``drop`` — ``flightrec.NONDETERMINISTIC_COUNTERS``) and per-kind
        EVENT COUNTS only (histogram totals/buckets hold wall-clock latency
        values; the counts are seed-deterministic). Under an injected virtual
        clock this block is a pure function of (config, seed) — two same-seed
        runs serialize byte-identically, same contract as ``causal``."""
        dropset: FrozenSet[str] = frozenset(drop)
        with self._lock:
            levels_out = []
            for i, span in enumerate(self.spans):
                blocks = []
                for start, end, value in self._fold.blocks(i)[-max(0, int(last_n)):]:
                    cvec, hvec = value
                    counters = {
                        f: int(v)
                        for f, v in zip(COUNTER_FIELDS, cvec)
                        if v and f not in dropset
                    }
                    events = {
                        kind: int(hvec[j * _KIND_VEC_LEN])
                        for j, kind in enumerate(FLEET_HISTOGRAM_KINDS)
                        if hvec[j * _KIND_VEC_LEN]
                    }
                    blocks.append({
                        "start": round(start, 6),
                        "end": round(end, 6),
                        "counters": counters,
                        "events": events,
                    })
                levels_out.append({"span": span, "blocks": blocks})
            return {
                "spans": list(self.spans),
                "samples": self.samples,
                "folds": self._fold.folds,
                "levels": levels_out,
            }
