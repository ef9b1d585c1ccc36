"""Exception types (counterpart of ``torchmetrics_tpu/utilities/exceptions.py``)."""


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metric API."""
