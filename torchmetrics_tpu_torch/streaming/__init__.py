"""Streaming plane (counterpart of ``torchmetrics_tpu/streaming``).

Only :mod:`~torchmetrics_tpu_torch.streaming.telescope` is here so far: the
telescoping multi-resolution retention fold that the telemetry history
(``observability/timeseries.py``) rides. The windowed and decayed metrics, the drift
monitor and the package's public names come with the streaming plane's own slice, so
this package exports nothing yet and stays out of the top-level package.
"""

__all__: list = []
