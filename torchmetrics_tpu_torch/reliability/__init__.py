"""State-integrity guards (counterpart of ``torchmetrics_tpu/reliability/``; the retry
policy and the fault-injection harness are not ported yet)."""

from .guards import validate_restored, validate_state

__all__ = ["validate_restored", "validate_state"]
