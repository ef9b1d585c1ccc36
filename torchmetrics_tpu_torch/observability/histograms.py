"""Mergeable log2-bucketed latency/size histograms.

Counters say *how often*; costs say *what it should cost*; histograms say *how
long it actually took* — as a distribution, because at fleet scale the tail IS
the story (straggler and tail-latency effects dominate pjit/TPUv4-scale runs;
a mean hides the one rank holding the barrier). The design constraints:

- **O(1) record, no allocation growth.** A histogram is a fixed vector of
  :data:`N_BUCKETS` integer counts; bucket ``b`` spans ``[2^b, 2^(b+1))`` in
  the histogram's unit (microseconds for latencies, bytes for sizes). Values
  are host-side metadata (monotonic-clock spans, ``size×itemsize`` bytes) —
  recording never touches device memory, exactly like the counters.
- **Merge == fieldwise integer sum.** Bucket counts, total count, and value
  sum are all plain integers, so a fleet rollup is the exact elementwise sum
  of per-rank vectors — the DrJAX-style integer-vector reduction, and the same
  contract the counter rollup already rides (:func:`merge_vectors`). No
  sketch, no approximation in the merge itself; only the bucket resolution is
  approximate (a quantile estimate is exact to within its bucket, i.e. a
  factor of 2 — tight enough to see a p99 move from 2 ms to 200 ms, which is
  the operational question).
- **Fixed fleet layout.** Per-key histograms stay local (string keys don't
  ride int collectives — same rule as per-key dispatch records); the fleet
  plane ships one int vector of the per-kind totals in
  :data:`FLEET_HISTOGRAM_KINDS` order, small enough to piggyback on the
  coalesced sync's metadata collective (``parallel/coalesce.py``).

Stdlib-only (no torch import). The bucket table and the quantile walk live in
``quantile.py`` (re-exported here): the ONE canonical estimator, which
``tools/trace_report.py`` and the benchmark load by file path instead of
mirroring the math by hand.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .quantile import N_BUCKETS, bucket_bounds, bucket_index, percentile_from_buckets

# The kinds whose per-kind totals ride the fleet plane, in vector order. The
# first nine are latency histograms (microseconds); the last two are size
# histograms (bytes). Fixed across ranks by construction — the fleet vector
# needs no key exchange. (Growing this tuple changes the piggyback layout:
# bump parallel/coalesce._VERSION — the streaming "wupdate" addition rode the
# v5 bump, the tiered-window "wdual"/"wstack" additions the v6 bump, each
# together with the counter-vector growth.)
FLEET_HISTOGRAM_KINDS: Tuple[str, ...] = (
    "update",        # jitted/host update dispatch latency
    "forward",       # forward dispatch latency
    "compute",       # Metric.compute latency
    "sync",          # Metric.sync / MetricCollection.sync wall-clock
    "retry_backoff", # backoff delay accepted before a transient retry
    "aot_load",      # serialized-executable load latency (aot compile cache)
    "wupdate",       # SlidingWindow ring-roll dispatch latency (streaming plane)
    "wdual",         # dual-pair window dispatch latency (tiered windows)
    "wstack",        # two-stack window dispatch latency (tiered windows)
    "sync_payload",  # bytes a process contributed to one sync
    "gather_bytes",  # bytes of one sync-plane collective payload
)

# kinds measured in bytes (everything else is microseconds)
SIZE_KINDS: Tuple[str, ...] = ("sync_payload", "gather_bytes")

# per-kind section: [count, value_sum, bucket_0 .. bucket_{N-1}]
_KIND_VEC_LEN = 2 + N_BUCKETS
# the whole fleet payload: one section per kind in FLEET_HISTOGRAM_KINDS order
FLEET_VECTOR_LEN = len(FLEET_HISTOGRAM_KINDS) * _KIND_VEC_LEN

# estimation quantiles the reports surface, in reporting order
PERCENTILES: Tuple[Tuple[str, float], ...] = (
    ("p50", 0.50),
    ("p95", 0.95),
    ("p99", 0.99),
    ("p999", 0.999),
)


class Histogram:
    """One mergeable log2 histogram (fixed buckets + count + value sum).

    ``lo``/``hi`` track the exact observed extrema locally — they sharpen
    percentile estimates but do NOT ride the fleet vector (min/max cannot
    merge by summation; a merged histogram estimates from buckets alone).
    """

    __slots__ = ("counts", "count", "total", "lo", "hi")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.total = 0
        self.lo: Optional[int] = None
        self.hi: Optional[int] = None

    def record(self, value: int) -> None:
        v = int(value)
        if v < 0:
            v = 0
        self.counts[bucket_index(v)] += 1
        self.count += 1
        self.total += v
        if self.lo is None or v < self.lo:
            self.lo = v
        if self.hi is None or v > self.hi:
            self.hi = v

    # ------------------------------------------------------------------ math

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (``0 < q <= 1``) via the shared
        log2-bucket walk (:func:`~torchmetrics_tpu_torch.observability.quantile.
        percentile_from_buckets`). Exact to within the bucket's width;
        clamped to the observed ``[lo, hi]`` when the exact extrema are
        known (local histograms)."""
        return percentile_from_buckets(self.counts, self.count, q, lo=self.lo, hi=self.hi)

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {name: self.percentile(q) for name, q in PERCENTILES}

    def mean(self) -> Optional[float]:
        return (self.total / self.count) if self.count else None

    # ----------------------------------------------------------------- merge

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into ``self`` (fieldwise integer sum) and return
        ``self``. Exact: merged bucket counts are the sum of the inputs'."""
        for b in range(N_BUCKETS):
            self.counts[b] += other.counts[b]
        self.count += other.count
        self.total += other.total
        for attr in ("lo", "hi"):
            mine, theirs = getattr(self, attr), getattr(other, attr)
            if theirs is not None and (mine is None or (theirs < mine) == (attr == "lo")):
                setattr(self, attr, theirs)
        return self

    def copy(self) -> "Histogram":
        out = Histogram()
        out.counts = list(self.counts)
        out.count, out.total, out.lo, out.hi = self.count, self.total, self.lo, self.hi
        return out

    # --------------------------------------------------------------- vectors

    def to_vector(self) -> List[int]:
        """``[count, value_sum, buckets...]`` — the mergeable int section."""
        return [self.count, self.total, *self.counts]

    @classmethod
    def from_vector(cls, vec: Sequence[int]) -> "Histogram":
        vals = [int(v) for v in vec]
        if len(vals) != _KIND_VEC_LEN:
            raise ValueError(f"histogram vector has {len(vals)} entries, expected {_KIND_VEC_LEN}")
        out = cls()
        out.count, out.total = vals[0], vals[1]
        out.counts = vals[2:]
        return out

    def summary(self) -> Dict[str, Any]:
        """Flat report block: count, sum, mean, the estimation quantiles, and
        the non-empty buckets (sparse — most of the table is zero)."""
        out: Dict[str, Any] = {"count": self.count, "sum": self.total}
        mean = self.mean()
        out["mean"] = round(mean, 3) if mean is not None else None
        for name, est in self.percentiles().items():
            out[name] = round(est, 3) if est is not None else None
        out["buckets"] = {str(b): c for b, c in enumerate(self.counts) if c}
        return out


class HistogramRegistry:
    """Per-session store of histograms keyed by ``(kind, key)`` (thread-safe).

    ``kind`` is the event kind / dispatch stage (``update``/``sync``/...);
    ``key`` is the metric identity (``ClassName#n``) or a site label. Recording
    happens only behind the ``_ACTIVE`` guard — a disabled process never calls
    into this module from a dispatch path (guarded by the zero-overhead test).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, str], Histogram] = {}

    def record(self, kind: str, key: str, value: int) -> None:
        with self._lock:
            hist = self._hists.get((kind, key))
            if hist is None:
                hist = self._hists[(kind, key)] = Histogram()
            hist.record(value)

    def record_duration(self, kind: str, key: str, duration_s: float) -> None:
        """Record a span in microseconds (the latency unit everywhere here)."""
        self.record(kind, key, max(0, int(duration_s * 1e6)))

    # -------------------------------------------------------------- querying

    def get(self, kind: str, key: str) -> Optional[Histogram]:
        with self._lock:
            hist = self._hists.get((kind, key))
            return hist.copy() if hist is not None else None

    def snapshot(self) -> Dict[str, Dict[str, Histogram]]:
        """``{kind: {key: histogram-copy}}`` as of now."""
        with self._lock:
            out: Dict[str, Dict[str, Histogram]] = {}
            for (kind, key), hist in self._hists.items():
                out.setdefault(kind, {})[key] = hist.copy()
            return out

    def kind_totals(self) -> Dict[str, Histogram]:
        """Per-kind merge across all keys — what the fleet vector ships."""
        with self._lock:
            out: Dict[str, Histogram] = {}
            for (kind, _), hist in self._hists.items():
                out.setdefault(kind, Histogram()).merge(hist)
            return out

    def keys_for(self, kind: str, prefix: str = "") -> Dict[str, Histogram]:
        with self._lock:
            return {
                key: hist.copy()
                for (k, key), hist in self._hists.items()
                if k == kind and key.startswith(prefix)
            }

    def fleet_vector(self) -> List[int]:
        """The per-kind totals as one flat int vector in
        :data:`FLEET_HISTOGRAM_KINDS` order — the payload the fleet gather
        plane (and the coalesced sync's metadata piggyback) ships per rank."""
        totals = self.kind_totals()
        vec: List[int] = []
        for kind in FLEET_HISTOGRAM_KINDS:
            hist = totals.get(kind)
            vec.extend(hist.to_vector() if hist is not None else [0] * _KIND_VEC_LEN)
        return vec

    def reset(self) -> None:
        with self._lock:
            self._hists = {}


# ---------------------------------------------------------------------------
# fleet merge (pure; the gather plane lives in parallel/sync.py)
# ---------------------------------------------------------------------------


def empty_fleet_vector() -> List[int]:
    return [0] * FLEET_VECTOR_LEN


def merge_vectors(rows: Iterable[Sequence[int]]) -> List[int]:
    """Exact fieldwise sum of per-rank fleet vectors — the merge IS integer
    addition, which is why histogram rollups ride the same int-vector plane
    as the counters."""
    out = empty_fleet_vector()
    n = 0
    for row in rows:
        vals = [int(v) for v in row]
        if len(vals) != FLEET_VECTOR_LEN:
            raise ValueError(
                f"fleet histogram vector has {len(vals)} entries, expected {FLEET_VECTOR_LEN}"
            )
        for i, v in enumerate(vals):
            out[i] += v
        n += 1
    if n == 0:
        raise ValueError("merge_vectors needs at least one rank vector")
    return out


def decode_fleet_vector(vec: Sequence[int]) -> Dict[str, Histogram]:
    """Split one (possibly merged) fleet vector back into per-kind histograms."""
    vals = [int(v) for v in vec]
    if len(vals) != FLEET_VECTOR_LEN:
        raise ValueError(
            f"fleet histogram vector has {len(vals)} entries, expected {FLEET_VECTOR_LEN}"
        )
    out: Dict[str, Histogram] = {}
    for i, kind in enumerate(FLEET_HISTOGRAM_KINDS):
        out[kind] = Histogram.from_vector(vals[i * _KIND_VEC_LEN : (i + 1) * _KIND_VEC_LEN])
    return out


def aggregate_histograms(
    rows: Sequence[Sequence[int]],
) -> Dict[str, Histogram]:
    """Merge per-rank fleet vectors into per-kind fleet histograms. The merged
    bucket counts equal the exact fieldwise sum over ranks — the invariant the
    acceptance test pins."""
    return decode_fleet_vector(merge_vectors(rows))
