"""Exception types (counterpart of ``torchmetrics_tpu/utilities/exceptions.py``)."""


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metric API."""


class TorchMetricsUserWarning(UserWarning):
    """Warning raised on questionable usage of the metric API."""


class TransientRuntimeError(RuntimeError):
    """A transient infrastructure fault (an RPC or transport error, a dropped host) that
    is safe to retry with the same inputs.

    Raised by the fault-injection harness and used by :mod:`..reliability.retry` as the
    always-retryable exception type; real runtime faults are classified by message.
    """


class StateCorruptionError(RuntimeError):
    """A metric state violated its ``init_state()`` spec (a missing leaf, a wrong
    shape or dtype, non-finite values) at a checkpoint-restore, sync or merge boundary.

    Never retryable: the state itself is damaged, so running the same operation again
    can only carry the damage further.
    """
