"""Transient-failure classification and bounded retry (counterpart of
``torchmetrics_tpu/reliability/retry.py``).

A long evaluation can die on one transient infrastructure error (a reset connection,
a dropped collective participant, an RPC status such as ``INTERNAL: ... response body
closed before all bytes were read``). This module retries such faults *without* ever
retrying deterministic user errors (bad shapes, bad dtypes, API misuse), which would
re-raise the same exception N times slower, and without retrying state corruption,
which would launder garbage into a "successful" eval.

Two pieces:

- an exception **classifier** (:func:`classify_exception`): transient infrastructure
  faults (RPC and transport errors, host dropout) vs deterministic errors. Unknown
  exceptions classify deterministic: never retry what you can't name. CUDA's sticky
  errors (an illegal address, a device-side assert) and its out-of-memory error carry
  no transient marker, so they classify deterministic: no retry can recover a poisoned
  CUDA context.
- a :class:`RetryPolicy`: bounded attempts, exponential backoff with **deterministic**
  jitter (no wall-clock or RNG dependence: the same failure sequence produces the same
  schedule on every host, keeping ranks in lockstep when they share a policy).

Both are wired behind the opt-in :class:`ReliabilityConfig` (``Metric(...,
reliability=...)``), so the default path is unchanged. The marker tables and the
schedule are the JAX package's, float for float; the telemetry records of a retry
belong to the observability plane, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

from ..utilities.exceptions import (
    StateCorruptionError,
    TorchMetricsUserError,
    TransientRuntimeError,
)

TRANSIENT = "transient"
DETERMINISTIC = "deterministic"

# Status prefixes / message fragments that mark an infrastructure fault: RPC status
# codes ("INTERNAL: ... response body closed before all bytes were read") and plain
# socket-level transport errors. The JAX package's table, verbatim.
_TRANSIENT_MESSAGE_MARKERS: Tuple[str, ...] = (
    "internal:",
    "unavailable:",
    "deadline_exceeded",
    "deadline exceeded",
    "aborted:",
    "cancelled:",
    "response body closed",
    "connection reset",
    "connection refused",
    "connection closed",
    "broken pipe",
    "socket closed",
    "transport closed",
    "stream terminated",
    "stream removed",
    "rst_stream",
    "failed to connect",
    "temporarily unavailable",
    "preempted",
    "host dropped",
    "participant dropped",
    "heartbeat timeout",
    "coordination service",
)

# Status prefixes that mark a *deterministic* runtime error even though they arrive
# wrapped in the same RuntimeError type as the transient ones. These win over any
# transient marker appearing later in the message.
_DETERMINISTIC_MESSAGE_MARKERS: Tuple[str, ...] = (
    "invalid_argument",
    "invalid argument:",
    "not_found",
    "unimplemented",
    "failed_precondition",
    "out_of_range",
    "permission_denied",
    "unauthenticated",
    # RESOURCE_EXHAUSTED is an out-of-memory status: deterministic for a fixed
    # workload — retrying an OOM just re-OOMs, slower
    "resource_exhausted",
)

# Exception types that are transient by construction (transport-level).
_TRANSIENT_TYPES: Tuple[type, ...] = (
    TransientRuntimeError,
    ConnectionError,  # covers ConnectionResetError/RefusedError/Aborted, BrokenPipeError
    TimeoutError,
)

# Exception types that are deterministic by construction: user/API errors and state
# corruption. Checked BEFORE any message heuristics.
_DETERMINISTIC_TYPES: Tuple[type, ...] = (
    TorchMetricsUserError,
    StateCorruptionError,
    ValueError,
    TypeError,
    KeyError,
    IndexError,
    AttributeError,
    AssertionError,
    NotImplementedError,
    ZeroDivisionError,
)


def is_transient_error_text(text: str) -> bool:
    """Classify an error *message* (e.g. the stderr tail of a crashed subprocess)."""
    low = text.lower()
    if any(marker in low for marker in _DETERMINISTIC_MESSAGE_MARKERS):
        return False
    return any(marker in low for marker in _TRANSIENT_MESSAGE_MARKERS)


def classify_exception(exc: BaseException) -> str:
    """``"transient"`` (safe to retry with the same inputs) or ``"deterministic"``.

    Order matters: typed user/corruption errors are deterministic even if their
    message happens to contain a transient-looking fragment; typed transport errors
    are transient regardless of message; everything else (``RuntimeError`` and its
    subclasses, CUDA's and ``torch.distributed``'s errors among them, and ``OSError``)
    is classified by message. Unknown exceptions are deterministic — never retry what
    you can't name.
    """
    if isinstance(exc, _DETERMINISTIC_TYPES):
        return DETERMINISTIC
    if isinstance(exc, _TRANSIENT_TYPES):
        return TRANSIENT
    if isinstance(exc, (RuntimeError, OSError)):
        return TRANSIENT if is_transient_error_text(str(exc)) else DETERMINISTIC
    return DETERMINISTIC


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter.

    Args:
        max_attempts: total attempts including the first (``3`` = 2 retries).
        backoff_base: delay before the first retry, seconds.
        backoff_factor: multiplier per subsequent retry.
        max_backoff: cap on any single delay, seconds.
        jitter: fraction of the delay perturbed deterministically per attempt
            (golden-ratio hash of the attempt number — reproducible everywhere,
            no RNG, no wall-clock). NOTE: this de-rounds the schedule away from
            exact power-of-two boundaries; it does NOT spread simultaneous
            retriers — every rank computes the identical delay for attempt N,
            which is exactly the lockstep the multi-controller sync path needs.
        classify: exception classifier; only ``"transient"`` outcomes retry.
        sleep_fn: injection seam for tests (defaults to ``time.sleep``).
    """

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    max_backoff: float = 2.0
    jitter: float = 0.1
    classify: Callable[[BaseException], str] = classify_exception
    sleep_fn: Callable[[float], None] = time.sleep

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_base < 0 or self.max_backoff < 0:
            raise ValueError("backoff delays must be non-negative")
        if not 0 <= self.jitter <= 1:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay_for(self, attempt: int) -> float:
        """Delay after failed attempt ``attempt`` (1-based), jitter included."""
        raw = min(self.backoff_base * self.backoff_factor ** (attempt - 1), self.max_backoff)
        if self.jitter == 0:
            return raw
        # deterministic jitter in [-jitter, +jitter): Weyl sequence on the attempt
        # number — de-rounds the schedule off exact backoff boundaries while every
        # rank still computes the same delay (lockstep retries, no RNG/host state)
        frac = (attempt * 0.6180339887498949) % 1.0
        return raw * (1.0 + self.jitter * (2.0 * frac - 1.0))

    def schedule(self) -> List[float]:
        """The full backoff schedule (one delay per possible retry) — for tests/docs."""
        return [self.delay_for(a) for a in range(1, self.max_attempts)]

    def call(
        self,
        thunk: Callable[[], Any],
        on_retry: Optional[Callable[[BaseException, int], None]] = None,
        describe: str = "",
    ) -> Any:
        """Run ``thunk``, retrying transient failures per the policy.

        ``on_retry(exc, attempt)`` runs after a transient failure is accepted for
        retry and after the backoff sleep — the seam where callers restore the
        states an attempt may have changed before the next attempt. Deterministic failures
        and exhausted budgets re-raise the original exception unchanged.
        """
        last_outcome = _RetryOutcome()
        return self._call(thunk, on_retry, describe, last_outcome)

    def call_with_outcome(
        self,
        thunk: Callable[[], Any],
        on_retry: Optional[Callable[[BaseException, int], None]] = None,
        describe: str = "",
    ) -> Tuple[Any, "_RetryOutcome"]:
        """Like :meth:`call` but also returns attempt accounting."""
        outcome = _RetryOutcome()
        return self._call(thunk, on_retry, describe, outcome), outcome

    @staticmethod
    def _warn_nonfatal(message: str) -> None:
        """Warn without letting a warnings-as-errors filter (``python -W error``,
        pytest ``filterwarnings = error``) convert the advisory into an exception
        inside the retry loop's except handler — that would mask the original
        transient failure and abort every retry, defeating the feature the
        warning merely narrates."""
        from ..utilities.prints import rank_zero_warn

        try:
            rank_zero_warn(message, UserWarning)
        except Exception:  # noqa: BLE001 — the warning must never outrank the retry
            pass

    def _call(self, thunk, on_retry, describe, outcome: "_RetryOutcome") -> Any:
        while True:
            outcome.attempts += 1
            try:
                return thunk()
            except Exception as exc:  # noqa: BLE001 — classifier decides
                transient = self.classify(exc) == TRANSIENT
                if not transient or outcome.attempts >= self.max_attempts:
                    if transient:
                        # exhausted budget on a transient fault: the moment the
                        # failure becomes final must not pass silently — warn before
                        # the original exception re-raises
                        self._warn_nonfatal(
                            f"Retry budget exhausted for {describe or 'metric dispatch'} "
                            f"after {outcome.attempts} attempts; giving up on transient "
                            f"failure: {exc!r}"
                        )
                    raise
                outcome.recovered_from.append(f"{type(exc).__name__}: {exc}"[:240])
                delay = self.delay_for(outcome.attempts)
                self._warn_nonfatal(
                    f"Transient failure in {describe or 'metric dispatch'} "
                    f"(attempt {outcome.attempts}/{self.max_attempts}): {exc!r}. "
                    f"Retrying in {delay:.3f}s."
                )
                if delay > 0:
                    self.sleep_fn(delay)
                if on_retry is not None:
                    on_retry(exc, outcome.attempts)


@dataclasses.dataclass
class _RetryOutcome:
    """Attempt accounting for one retried call."""

    attempts: int = 0
    recovered_from: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """Opt-in reliability knobs for a :class:`~torchmetrics_tpu_torch.Metric`.

    Passed as ``Metric(..., reliability=ReliabilityConfig(...))``. ``None`` (the
    default everywhere) keeps today's zero-overhead behavior exactly.

    Args:
        retry: policy applied at the boundaries of ``update`` / ``forward`` /
            ``compute`` and around ``process_sync``. ``None`` disables retry (guards
            can still be active).
        validate_on_sync: run :func:`~torchmetrics_tpu_torch.reliability.validate_state`
            on the synced state before it replaces the local one.
        validate_on_merge: validate an incoming state before ``merge_state`` folds
            it in (a corrupt shard must not poison the accumulator).
        validate_on_restore: validate finiteness of leaves restored by
            ``load_state_dict`` (structural shape/key checks always run there).
        check_finite: include NaN/Inf scans in the validations above — scoped to
            AGGREGATE (``sum``/``mean``/``min``/``max``) leaves, where non-finite
            values are always corruption; raw-data leaves (``cat`` lists,
            ``None``-tagged gathers) may carry NaN by construction and are never
            scanned at sync/merge. Costs one device-to-host read per scanned
            leaf — fine at sync/checkpoint boundaries, which is why guards do
            not run per-update.
    """

    retry: Optional[RetryPolicy] = None
    validate_on_sync: bool = True
    validate_on_merge: bool = True
    validate_on_restore: bool = True
    check_finite: bool = True
