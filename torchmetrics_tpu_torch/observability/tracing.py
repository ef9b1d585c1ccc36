"""Profiler integration: ``torch.profiler`` ranges and honest dispatch timing
(counterpart of ``torchmetrics_tpu/observability/tracing.py``).

- :func:`trace_span` — ``torch.profiler.record_function(label)``: a named range on
  the host timeline of a ``torch.profiler`` trace. The kernels a metric launches
  inside it are attributed to it (their launches fall inside the range). Opened at
  the same boundaries as the JAX package's ``TraceAnnotation``; without a running
  profiler it costs one small object.
- :func:`graph_scope` — a no-op context. ``jax.named_scope`` names the HLO ops a
  jitted body traces; eager PyTorch traces nothing, so there is nothing to name, and
  the kernels are attributed by :func:`trace_span` instead.

Timing: a CUDA launch returns once the kernel is queued, so a bare ``monotonic()``
pair measures launch latency, not device time. The blocking-timing mode
(``TelemetryConfig(block_until_ready=True)``) calls :func:`block_for_timing` after
each dispatch for honest per-call wall-clock, at the price of serializing host and
card, which is why it is opt-in per session and never the default.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Optional


def trace_span(label: str):
    """Host-side profiler range (``torch.profiler``'s ``record_function``)."""
    import torch

    return torch.profiler.record_function(label)


def graph_scope(label: str):
    """A no-op context: eager PyTorch has no trace time whose ops it could name."""
    return contextlib.nullcontext()


def monotonic() -> float:
    """The telemetry clock (monotonic; never wall time)."""
    return time.monotonic()


def block_for_timing(value: Any = None, device: Optional[Any] = None) -> Any:
    """Wait for the work queued on the current CUDA stream of ``device`` (a
    ``torch.device``, or the current CUDA device when None) so that the surrounding
    monotonic pair measures device wall-clock, not launch latency. The port's
    ``update`` returns nothing and changes its states in place, so there is no result
    to wait on: the stream is synchronized, which copies nothing to the host. On the
    CPU (and without CUDA) it does nothing. Returns ``value``."""
    import torch

    if device is not None and getattr(device, "type", None) != "cuda":
        return value
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream(device).synchronize()
    return value
