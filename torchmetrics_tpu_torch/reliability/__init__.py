"""Reliability layer (counterpart of ``torchmetrics_tpu/reliability/``): transient-failure
retry, fault injection and state-integrity guards.

A long evaluation must classify failures, retry the transient ones, guard state
integrity at trust boundaries (sync, merge, checkpoint restore) and degrade gracefully
instead of letting one bad metric kill the whole eval loop.

Everything here is opt-in: without a :class:`ReliabilityConfig` a metric takes no
backup copy and launches nothing more than it does without this module.
"""

from .faults import (
    ROUND5_CRASH_MESSAGE,
    DeadRank,
    DispatchFaultHook,
    FlakyGather,
    inject_dispatch_fault,
    make_transient_error,
    poison_state_leaf,
    truncate_state_dict,
)
from .guards import validate_restored, validate_state
from .retry import (
    DETERMINISTIC,
    TRANSIENT,
    ReliabilityConfig,
    RetryPolicy,
    classify_exception,
    is_transient_error_text,
)

__all__ = [
    "DETERMINISTIC",
    "TRANSIENT",
    "ROUND5_CRASH_MESSAGE",
    "DeadRank",
    "DispatchFaultHook",
    "FlakyGather",
    "ReliabilityConfig",
    "RetryPolicy",
    "classify_exception",
    "inject_dispatch_fault",
    "is_transient_error_text",
    "make_transient_error",
    "poison_state_leaf",
    "truncate_state_dict",
    "validate_restored",
    "validate_state",
]
