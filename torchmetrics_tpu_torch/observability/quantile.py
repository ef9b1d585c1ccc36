"""Canonical log2-bucket quantile estimation — the ONE copy of the walk (the
JAX package's ``observability/quantile.py``, kept as it is).

``histograms.py`` (the runtime estimator), ``tools/trace_report.py`` (the
offline trace renderer) and ``bench.py`` (the benchmark's probe columns) all
need the same bucket→percentile math; before this module each tool mirrored
it by hand, and the mirrors drifted exactly the way mirrors do. This module
is deliberately free of package-relative imports and anything beyond the
stdlib, so the tools load it by file path
(``importlib.util.spec_from_file_location``) without importing the
package — which would initialize torch — while ``histograms.py``
imports it relatively and re-exports the names its callers already use.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

# Bucket b counts values v with 2^b <= v < 2^(b+1) (bucket 0 also absorbs 0).
# 32 buckets cover 1 us .. ~71 minutes for latencies and 1 byte .. 4 GiB for
# per-sync payloads — beyond either end the exact magnitude stops mattering.
N_BUCKETS = 32


def bucket_index(value: int) -> int:
    """Bucket for a non-negative integer value: ``floor(log2(value))`` clamped
    to the table (0 and 1 land in bucket 0; the top bucket is open-ended)."""
    if value < 2:
        return 0
    return min(value.bit_length() - 1, N_BUCKETS - 1)


def bucket_bounds(index: int) -> Tuple[int, int]:
    """``[lower, upper)`` of bucket ``index`` (lower of bucket 0 is 0)."""
    return (0 if index == 0 else 1 << index), 1 << (index + 1)


def percentile_from_buckets(
    buckets: Union[Mapping[int, int], Sequence[int]],
    count: int,
    q: float,
    lo: Optional[int] = None,
    hi: Optional[int] = None,
) -> Optional[float]:
    """Estimate the ``q``-quantile (``0 < q <= 1``) of a log2-bucketed
    distribution by walking the bucket cumulative and interpolating linearly
    inside the target bucket — exact to within the bucket's width (a factor
    of 2, the resolution that distinguishes "p99 moved from 2 ms to 200 ms"
    from noise).

    ``buckets`` is either the dense per-bucket count list a
    :class:`~torchmetrics_tpu_torch.observability.histograms.Histogram` holds or
    the sparse ``{bucket_index: count}`` mapping JSONL ``hist`` payloads
    carry; ``count`` is the total observation count. ``lo``/``hi`` clamp the
    estimate to exactly-observed extrema when the caller knows them (local
    histograms; merged/vector histograms don't, and pass ``None``)."""
    if count <= 0:
        return None
    if isinstance(buckets, Mapping):
        items = sorted((int(b), int(c)) for b, c in buckets.items() if c)
    else:
        items = [(b, int(c)) for b, c in enumerate(buckets) if c]
    if not items:
        return None
    target = q * count
    cum = 0
    est: Optional[float] = None
    for b, c in items:
        if cum + c >= target:
            lower, upper = bucket_bounds(b)
            est = lower + (upper - lower) * (target - cum) / c
            break
        cum += c
    if est is None:  # float rounding pushed target past the last count
        est = float(bucket_bounds(items[-1][0])[1])
    if lo is not None:
        est = max(est, float(lo))
    if hi is not None:
        est = min(est, float(hi))
    return est
