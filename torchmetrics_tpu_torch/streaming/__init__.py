"""Streaming plane: windowed and decayed metrics over infinite streams (counterpart of
``torchmetrics_tpu/streaming``).

- :class:`SlidingWindow`: the metric over the last ``window`` updates, in the tier its
  reduce tags admit (:func:`window_tier`): a constant-memory dual pair (sum/mean), a
  paned two-stack (max/min/callable semigroups) or the exact per-update bucket ring
  (custom merges, cat states), one step per update in every tier;
- :class:`ExponentialDecay`: the metric with exponentially discounted history;
- :class:`DriftMonitor`: the current window against the previous block, wired into the
  SLO and alert engine (``drift(name)``, breaches on the ``alert`` event kind);
- :class:`TelescopingFold`: the telescoping multi-resolution retention fold that the
  telemetry history (``observability/timeseries.py``) rides.

Their sync-side counterpart is :class:`~torchmetrics_tpu_torch.parallel.AsyncSyncHandle`,
the double-buffered background sync behind ``MetricCollection.sync(async_=True)``.
"""

from ..metric import window_tier
from .drift import DriftMonitor
from .telescope import TelescopingFold
from .window import ExponentialDecay, SlidingWindow

__all__ = ["DriftMonitor", "ExponentialDecay", "SlidingWindow", "TelescopingFold", "window_tier"]
