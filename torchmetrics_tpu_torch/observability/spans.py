"""Request-scoped causal trace contexts (the span plane).

A *span* is a lightweight ``(trace_id, span_id, parent_id)`` triple carried
on a thread-local stack and stamped onto every :class:`TelemetryEvent`
emitted while it is active (``TelemetryRecorder._event`` reads
:func:`current`).  Ids are **deterministic**: sha256 digests of the caller's
identifying parts, truncated to 16 hex chars — no wall clock, no PRNG — so
a seeded soak produces byte-identical trace trees across runs and a
postmortem artifact can be diffed against a replay.

Zero-overhead contract: spans are only *created* inside a
``rec is not None`` branch at the call site.  With telemetry disabled no
:class:`SpanContext` is constructed and no digest is computed — the guard
test in ``tests/test_torch_observability.py`` monkeypatches both with poison to
prove it.  :func:`current` itself is a bare thread-local read and is only
invoked from the recorder (which implies telemetry is on).

Typical shapes::

    with spans.scope("serve", tenant, seq):          # root: derives a trace
        engine.update(tenant, preds, target)         # events inherit the span

    ctx = spans.enter("failover", host, parent=kill_ctx)   # cross-stack link
    try: ...adopt...
    finally: spans.exit(ctx)

Callers are responsible for making the ``parts`` unique where uniqueness
matters (e.g. include a sequence number when the same logical operation
repeats inside one trace).
"""

from __future__ import annotations

import hashlib
import threading
from contextlib import contextmanager
from typing import Iterator, Optional

__all__ = [
    "SpanContext",
    "current",
    "derive_span_id",
    "derive_trace_id",
    "enter",
    "exit",
    "scope",
]

_TLS = threading.local()


def _digest(*parts: object) -> str:
    """Deterministic 16-hex-char id from the stringified parts."""
    joined = "|".join(str(p) for p in parts)
    return hashlib.sha256(joined.encode("utf-8")).hexdigest()[:16]


def derive_trace_id(*parts: object) -> str:
    """A trace id from stable identifying parts (seed, step, tenant, ...)."""
    return _digest("trace", *parts)


def derive_span_id(trace_id: str, parent_id: Optional[str], *parts: object) -> str:
    """A span id scoped under ``trace_id``/``parent_id`` from stable parts."""
    return _digest("span", trace_id, parent_id or "", *parts)


class SpanContext:
    """One active span: immutable id triple linking an event into a trace."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str] = None) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SpanContext(trace_id={self.trace_id!r}, span_id={self.span_id!r}, "
                f"parent_id={self.parent_id!r})")


def current() -> Optional[SpanContext]:
    """The innermost active span on this thread, or ``None``."""
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return None
    return stack[-1]


def enter(*parts: object, trace: Optional[str] = None,
          parent: Optional[SpanContext] = None) -> SpanContext:
    """Push a new span and return it (pair with :func:`exit` in a finally).

    Parent resolution, in order: an explicit ``parent`` context (cross-stack
    linking, e.g. a failover chaining off the kill site), else the current
    thread-local span, else none (a fresh root).  ``trace`` pins the trace
    id explicitly (e.g. a fault-ledger trace); otherwise the parent's trace
    is inherited or a new one derived from ``parts``.
    """
    if parent is None:
        parent = current()
    if trace is not None:
        trace_id = trace
    elif parent is not None:
        trace_id = parent.trace_id
    else:
        trace_id = derive_trace_id(*parts)
    parent_id = parent.span_id if parent is not None else None
    ctx = SpanContext(trace_id, derive_span_id(trace_id, parent_id, *parts), parent_id)
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = []
        _TLS.stack = stack
    stack.append(ctx)
    return ctx


def exit(ctx: SpanContext) -> None:  # noqa: A001 - deliberate pairing with enter()
    """Pop ``ctx`` (and anything leaked above it) off this thread's stack."""
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return
    while stack:
        top = stack.pop()
        if top is ctx:
            break


@contextmanager
def scope(*parts: object, trace: Optional[str] = None,
          parent: Optional[SpanContext] = None) -> Iterator[SpanContext]:
    """Context-manager form of :func:`enter`/:func:`exit`."""
    ctx = enter(*parts, trace=trace, parent=parent)
    try:
        yield ctx
    finally:
        exit(ctx)
