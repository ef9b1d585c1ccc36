"""Telescoping multi-resolution fold over a mergeable stream.

The dual-form sliding-window algebra (``window.py``) answers "the metric over
the last W updates" in O(1) memory *per window*; retaining MANY windows — the
last 10 seconds at 1s resolution, the last minute at 10s, the last hour at
1m, the last day at 1h — naively costs O(sum of window lengths) blocks. The
telescoping fold keeps it at O(levels): each level holds a bounded ring of
closed blocks at its own span, and every block that falls off a level has
already been folded into the (coarser) level above, so old history loses
resolution instead of existing twice or vanishing.

The only requirement on the folded value is a commutative, associative
``merge`` — the integer-vector addition contract the telemetry counter and
histogram rollups already ride (the default merge is exact elementwise sum
of equal-length sequences). That makes this module the retention structure
for the telemetry history plane (``observability/timeseries.py``) today and
for per-tenant metric states (ROADMAP "telescoping multi-resolution
windows") later.

Determinism: the fold is a pure function of the fed ``(t, value)`` sequence —
no wall clock, no randomness — so soak runs driving it from the injected
virtual clock produce byte-identical retained blocks run-to-run.

Stdlib-only (no torch import): loadable by file path from tools and the
benchmark without initializing a runtime.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def sum_merge(a: Sequence[Any], b: Sequence[Any]) -> Any:
    """Default merge: exact elementwise sum of two equal-length vectors (or
    plain ``a + b`` for scalars) — never mutates its inputs."""
    if isinstance(a, (int, float)):
        return a + b
    if len(a) != len(b):
        raise ValueError(f"cannot merge vectors of length {len(a)} and {len(b)}")
    return type(a)(x + y for x, y in zip(a, b))


class _Level:
    __slots__ = ("span", "keep", "blocks", "open_start", "open_value")

    def __init__(self, span: float, keep: int) -> None:
        self.span = float(span)
        self.keep = int(keep)
        self.blocks: List[Tuple[float, Any]] = []  # closed, time-ordered
        self.open_start: Optional[float] = None
        self.open_value: Any = None


class TelescopingFold:
    """Bounded multi-resolution retention of a mergeable value stream.

    ``spans`` are the per-level block widths in seconds, strictly increasing
    (default 1s → 10s → 1m → 1h). ``keep[i]`` bounds how many CLOSED blocks
    level ``i`` retains; the default keeps exactly enough fine blocks to tile
    one block of the next level (so the finest view always covers the span
    the next level summarizes) and 24 blocks at the top. When a level-``i``
    block closes it is folded into level ``i+1``'s open block AND appended to
    level ``i``'s ring — recent time stays fine-grained, old time stays
    queryable at coarser resolution, total memory stays
    ``O(sum(keep))`` = O(levels) for constant per-level ``keep``.
    """

    def __init__(
        self,
        spans: Sequence[float] = (1.0, 10.0, 60.0, 3600.0),
        keep: Optional[Sequence[int]] = None,
        merge: Callable[[Any, Any], Any] = sum_merge,
    ) -> None:
        spans = tuple(float(s) for s in spans)
        if not spans:
            raise ValueError("TelescopingFold needs at least one level span")
        if any(b <= a for a, b in zip(spans, spans[1:])):
            raise ValueError(f"level spans must be strictly increasing, got {spans}")
        if keep is None:
            keep = tuple(
                max(2, int(round(spans[i + 1] / spans[i]))) for i in range(len(spans) - 1)
            ) + (24,)
        keep = tuple(int(k) for k in keep)
        if len(keep) != len(spans):
            raise ValueError(f"keep has {len(keep)} entries for {len(spans)} levels")
        if any(k < 1 for k in keep):
            raise ValueError(f"every level must keep at least one block, got {keep}")
        self.spans: Tuple[float, ...] = spans
        self.keep: Tuple[int, ...] = keep
        self._merge = merge
        self._levels: List[_Level] = [_Level(s, k) for s, k in zip(spans, keep)]
        self.folds = 0  # closed-block folds, across all levels, since construction

    # ------------------------------------------------------------------ feed

    def feed(self, t: float, value: Any) -> int:
        """Fold one sample at time ``t`` into the hierarchy; returns how many
        blocks this feed CLOSED (0 on the common in-block path). ``t`` must be
        non-decreasing for the block boundaries to mean anything; a late
        sample is folded into the current open block rather than dropped."""
        before = self.folds
        self._feed(0, float(t), value)
        return self.folds - before

    def _feed(self, i: int, t: float, value: Any) -> None:
        lvl = self._levels[i]
        start = math.floor(t / lvl.span) * lvl.span
        if lvl.open_start is None or start == lvl.open_start:
            if lvl.open_start is None:
                lvl.open_start, lvl.open_value = start, value
            else:
                lvl.open_value = self._merge(lvl.open_value, value)
            return
        if start < lvl.open_start:  # out-of-order sample: keep it, coarsely
            lvl.open_value = self._merge(lvl.open_value, value)
            return
        # the open block closes: retain it here, fold it one level up
        closed_start, closed_value = lvl.open_start, lvl.open_value
        lvl.blocks.append((closed_start, closed_value))
        self.folds += 1
        if i + 1 < len(self._levels):
            self._feed(i + 1, closed_start, closed_value)
        if len(lvl.blocks) > lvl.keep:
            del lvl.blocks[: len(lvl.blocks) - lvl.keep]
        lvl.open_start, lvl.open_value = start, value

    # --------------------------------------------------------------- queries

    def _level_blocks(self, i: int) -> List[Tuple[float, float, Any]]:
        lvl = self._levels[i]
        out = [(s, s + lvl.span, v) for s, v in lvl.blocks]
        if lvl.open_start is not None:
            out.append((lvl.open_start, lvl.open_start + lvl.span, lvl.open_value))
        return out

    def blocks(self, level: int = 0) -> List[Tuple[float, float, Any]]:
        """Retained ``(start, end, value)`` blocks of one level, time-ordered;
        the still-open block rides last."""
        if not 0 <= level < len(self._levels):
            raise IndexError(f"level {level} out of range (have {len(self._levels)})")
        return self._level_blocks(level)

    def at(self, t: float) -> Optional[Tuple[int, float, float, Any]]:
        """The FINEST retained block covering time ``t`` as
        ``(level, start, end, value)``, or ``None`` when ``t`` predates every
        retained boundary (history telescoped past it) or postdates the open
        blocks."""
        for i in range(len(self._levels)):
            for start, end, value in reversed(self._level_blocks(i)):
                if start <= t < end:
                    return (i, start, end, value)
                if end <= t:
                    break  # blocks are time-ordered: nothing earlier covers t
        return None

    def range(self, t0: float, t1: float, level: int = 0) -> List[Tuple[float, float, Any]]:
        """Blocks of ``level`` overlapping ``[t0, t1)``, time-ordered."""
        return [(s, e, v) for s, e, v in self.blocks(level) if s < t1 and e > t0]

    def block_count(self) -> int:
        """Total retained blocks (closed + open) — the O(levels) memory pin:
        bounded by ``sum(keep) + len(spans)`` regardless of how much time has
        been fed through."""
        return sum(len(lvl.blocks) + (lvl.open_start is not None) for lvl in self._levels)

    def summary(self) -> Dict[str, Any]:
        return {
            "spans": list(self.spans),
            "keep": list(self.keep),
            "folds": self.folds,
            "blocks": self.block_count(),
        }
