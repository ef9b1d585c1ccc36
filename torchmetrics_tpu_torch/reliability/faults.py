"""Deterministic fault injection (counterpart of ``torchmetrics_tpu/reliability/faults.py``):
every recovery path testable on the CPU.

The failure modes this harness reproduces:

- a transient dispatch error on the Nth call of a metric (an RPC status such as
  ``INTERNAL: ... response body closed before all bytes were read``) →
  :func:`inject_dispatch_fault`;
- NaN/Inf corruption of a named state leaf (a bad collective, a bit flip, a buggy
  custom merge) → :func:`poison_state_leaf`;
- a participant dropping out of ``gather_all_arrays`` mid-sync (host preemption)
  → :class:`FlakyGather`;
- a rank dying mid-collective in a larger world → :class:`DeadRank`;
- a truncated / partially-written checkpoint → :func:`truncate_state_dict`.

Everything is deterministic (counters, not clocks or RNG) so recovery tests are
exact: a retried run must be *bitwise identical* to an uninterrupted one.

Example:
    >>> import torch
    >>> from torchmetrics_tpu_torch import MeanMetric
    >>> from torchmetrics_tpu_torch.reliability import ReliabilityConfig, RetryPolicy, inject_dispatch_fault
    >>> metric = MeanMetric(device="cpu", reliability=ReliabilityConfig(retry=RetryPolicy(sleep_fn=lambda s: None)))
    >>> import warnings
    >>> with warnings.catch_warnings():
    ...     warnings.simplefilter("ignore")
    ...     with inject_dispatch_fault(metric, fail_on=1, tag="update") as hook:
    ...         metric.update(torch.tensor([1.0, 2.0]))
    >>> hook.raised, float(metric.compute())
    (1, 1.5)
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ..utilities.exceptions import TransientRuntimeError

# an RPC transport failure's message, status-prefixed: classifier fixtures and docs use it
ROUND5_CRASH_MESSAGE = (
    "INTERNAL: stream terminated by RST_STREAM: response body closed before all bytes were read"
)


def make_transient_error(message: str = ROUND5_CRASH_MESSAGE) -> TransientRuntimeError:
    """A synthetic transient infra error with a realistic status-prefixed message."""
    return TransientRuntimeError(message)


class DispatchFaultHook:
    """Callable installed as ``metric._fault_hook``: raises on configured dispatches.

    Counts every dispatch attempt of the matching ``tag`` (``"update"``,
    ``"forward"``, ``"compute"``, ``"sync"``; ``None`` matches all) and raises
    ``exc_factory()`` for attempts ``fail_on .. fail_on+times-1`` (1-based). With a
    retry policy active the failed attempt is dispatched again, which increments the
    counter again — so ``times=1`` means "fail once, recover on the next attempt".
    """

    def __init__(
        self,
        fail_on: int = 1,
        times: int = 1,
        tag: Optional[str] = None,
        exc_factory: Callable[[], BaseException] = make_transient_error,
    ) -> None:
        self.fail_on = fail_on
        self.times = times
        self.tag = tag
        self.exc_factory = exc_factory
        self.calls = 0
        self.raised = 0

    def __call__(self, tag: str) -> None:
        if self.tag is not None and tag != self.tag:
            return
        self.calls += 1
        if self.fail_on <= self.calls < self.fail_on + self.times:
            self.raised += 1
            raise self.exc_factory()


@contextlib.contextmanager
def inject_dispatch_fault(
    metric: Any,
    fail_on: int = 1,
    times: int = 1,
    tag: Optional[str] = None,
    exc_factory: Callable[[], BaseException] = make_transient_error,
) -> Iterator[DispatchFaultHook]:
    """Inject a fault into a metric's dispatch seam for the duration of the block.

    The hook fires at the start of each attempt, before the attempt touches the
    metric's states, so a retrying metric sees the error where a dispatch failure
    would surface.
    """
    hook = DispatchFaultHook(fail_on=fail_on, times=times, tag=tag, exc_factory=exc_factory)
    prev = getattr(metric, "_fault_hook", None)
    metric._fault_hook = hook
    try:
        yield hook
    finally:
        metric._fault_hook = prev


def poison_state_leaf(metric: Any, name: str, kind: str = "nan") -> None:
    """Overwrite a named state leaf with NaN or Inf (deterministic).

    The leaf is *replaced* in the state dict, not written in place, so every
    compute-group member that aliases the dict sees it; list (concat) leaves get
    every element poisoned. ``kind`` is ``"nan"`` or ``"inf"``.
    """
    if name not in metric._state:
        raise KeyError(f"{type(metric).__name__} has no state {name!r}")
    fill = float("nan") if kind == "nan" else float("inf")
    current = metric._state[name]

    def _poison(x):
        x = torch.as_tensor(x)
        if not x.is_floating_point():
            x = x.to(torch.float32)  # corruption does not respect dtypes either
        return torch.full_like(x, fill)

    metric._state[name] = [_poison(x) for x in current] if isinstance(current, list) else _poison(current)
    metric._computed = None


class FlakyGather:
    """A ``dist_sync_fn`` wrapper simulating a participant dropping out of the
    gather: the configured calls raise *before* any collective is entered (every
    rank shares the same deterministic counter, so in a real cluster all ranks fail
    and retry in lockstep — no desynchronized collectives).

    Wraps the production :func:`~torchmetrics_tpu_torch.parallel.sync.gather_all_arrays`
    by default; pass ``inner`` to wrap a test-world fake gather instead.
    """

    def __init__(
        self,
        inner: Optional[Callable] = None,
        fail_times: int = 1,
        exc_factory: Callable[[], BaseException] = lambda: TransientRuntimeError(
            "UNAVAILABLE: participant dropped during gather_all_arrays"
        ),
    ) -> None:
        if inner is None:
            from ..parallel.sync import gather_all_arrays as inner  # late: avoids a cycle
        self.inner = inner
        self.fail_times = fail_times
        self.exc_factory = exc_factory
        self.calls = 0
        self.failures = 0

    def __call__(self, value, group=None):
        self.calls += 1
        if self.failures < self.fail_times:
            self.failures += 1
            raise self.exc_factory()
        return self.inner(value, group)


class DeadRank:
    """A ``dist_sync_fn`` wrapper simulating a rank DYING mid-collective in a
    ``world``-rank fleet — the failure the coalesced sync's tombstone rows exist to
    survive (``parallel/coalesce.py``).

    Every gathered result is widened to ``world`` rows by mirroring the local
    row for the simulated peers (the world-of-one test-fleet trick); while
    rank ``rank`` is dead its row in EVERY collective result is zeroed —
    exactly the all-zero metadata tombstone and zero bucket payload a real
    lost participant leaves behind. The coalesced plane completes the sync over the
    survivors. :meth:`revive` brings the rank back: its rows mirror the live ones
    again.

    Deterministic (counters, not clocks): ``calls`` counts collectives
    served, ``zeroed`` the rows tombstoned while dead.
    """

    def __init__(self, inner: Optional[Callable] = None, world: int = 2, rank: int = 1) -> None:
        if inner is None:
            from ..parallel.sync import gather_all_arrays as inner  # late: avoids a cycle
        if world < 2:
            raise ValueError(f"DeadRank needs a world of at least 2, got {world}")
        if not 0 <= rank < world:
            raise ValueError(f"rank must be in [0, {world}), got {rank}")
        self.inner = inner
        self.world = world
        self.rank = rank
        self.dead = True
        self.calls = 0
        self.zeroed = 0

    def revive(self) -> None:
        """Bring the dead rank back: its next rows are live mirrors."""
        self.dead = False

    def kill(self) -> None:
        self.dead = True

    def __call__(self, value, group=None):
        self.calls += 1
        rows = [torch.as_tensor(r) for r in self.inner(value, group)]
        while len(rows) < self.world:  # mirror the local row for simulated peers
            rows.append(rows[0].clone())
        if self.dead:
            rows[self.rank] = torch.zeros_like(rows[self.rank])
            self.zeroed += 1
        return rows


def truncate_state_dict(
    state_dict: Dict[str, Any],
    drop_keys: Optional[Iterable[str]] = None,
    slice_keys: Optional[Iterable[str]] = None,
) -> Dict[str, Any]:
    """A damaged copy of a checkpoint dict: ``drop_keys`` removed entirely
    (lost keys), ``slice_keys``' arrays cut to half length along axis 0 when
    possible (partially-written buffers). The original dict is untouched. Tensors stay
    tensors on their device; other values become numpy arrays, as in the JAX package.
    """
    out = dict(state_dict)
    for key in drop_keys or ():
        out.pop(key, None)
    for key in slice_keys or ():
        if key in out:
            value = out[key]
            arr = value if isinstance(value, torch.Tensor) else np.asarray(value)
            if arr.ndim > 0 and arr.shape[0] > 1:
                out[key] = arr[: arr.shape[0] // 2]
            else:
                out[key] = arr.reshape(tuple(arr.shape) + (1,))  # rank damage for scalars
    return out
