"""Drift evaluators over infinite streams (counterpart of
``torchmetrics_tpu/streaming/drift.py``).

A windowed metric answers "what is the value now"; a drift monitor answers "did the
stream change", the question a monitoring service pages on. :class:`DriftMonitor`
compares two views of one update stream:

- the **test window**: a :class:`~torchmetrics_tpu_torch.streaming.SlidingWindow` over
  the last ``test_window`` updates;
- the **reference window**: a tumbling block of ``reference_window`` updates in a plain
  clone of the metric; each time the block fills, its value freezes as the new
  reference and the block resets.

``evaluate()`` scores their divergence (the largest absolute, or relative, elementwise
difference over the value's leaves) and feeds the health plane: the score lands in the
SLO namespace as ``drift(name)``, the ``drift_evals``/``drift_breaches`` counters tick,
and a breach rides the ``alert`` event kind. Evaluation reads both values back to the
host (a deliberate device-to-host copy), every ``eval_every`` updates, never inside a
window step.
"""

from __future__ import annotations

import collections
from typing import Any, Deque, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree

from .. import observability as _observability
from ..metric import Metric
from ..utilities.exceptions import TorchMetricsUserError
from .window import SlidingWindow

_MODES = ("abs", "rel")


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float64).numpy()
    return np.asarray(leaf, np.float64)


def _leaf_scores(test_value: Any, ref_value: Any, mode: str) -> float:
    """The largest divergence over the value's leaves (host floats)."""
    t_leaves = _pytree.tree_leaves(test_value)
    r_leaves = _pytree.tree_leaves(ref_value)
    if len(t_leaves) != len(r_leaves):
        raise TorchMetricsUserError(
            "test and reference computes produced different value structures; "
            "drift scoring needs a stable compute output shape."
        )
    worst = 0.0
    for t, r in zip(t_leaves, r_leaves):
        t, r = _host(t), _host(r)
        diff = np.abs(t - r)
        if mode == "rel":
            diff = diff / np.maximum(np.abs(r), 1e-12)
        finite = diff[np.isfinite(diff)]
        if finite.size:
            worst = max(worst, float(finite.max()))
    return worst


class DriftMonitor:
    """Windowed drift evaluator: the current window's value against the previous
    block's.

    Args:
        metric: the metric template (cloned twice; the caller's object is untouched).
            It must meet :class:`SlidingWindow`'s requirements.
        reference_window: the tumbling block's length in updates; each full block's
            value becomes the next reference.
        test_window: the sliding window's length.
        threshold: the score past which an evaluation is a breach.
        mode: ``"abs"`` (largest absolute difference, the default) or ``"rel"``
            (relative to the reference's magnitude).
        name: identity in the SLO namespace and the alert stream (default
            ``drift_<ClassName>``).
        eval_every: evaluate every this many updates once a reference exists (default
            ``test_window``); ``0`` leaves evaluation to :meth:`evaluate`.
        severity: carried on breach alerts (``info``/``warning``/``critical``).
    """

    def __init__(
        self,
        metric: Metric,
        reference_window: int = 512,
        test_window: int = 128,
        threshold: float = 0.05,
        mode: str = "abs",
        name: Optional[str] = None,
        eval_every: Optional[int] = None,
        severity: str = "warning",
    ) -> None:
        if not (isinstance(reference_window, int) and reference_window > 0):
            raise ValueError(f"Expected `reference_window` to be a positive integer, got {reference_window}")
        if not (isinstance(test_window, int) and test_window > 0):
            raise ValueError(f"Expected `test_window` to be a positive integer, got {test_window}")
        if mode not in _MODES:
            raise ValueError(f"Expected `mode` to be one of {_MODES}, got {mode!r}")
        if threshold < 0:
            raise ValueError(f"Expected `threshold` >= 0, got {threshold}")
        self.reference_window = reference_window
        self.test_window = test_window
        self.threshold = float(threshold)
        self.mode = mode
        self.name = name or f"drift_{type(metric).__name__}"
        self.eval_every = test_window if eval_every is None else int(eval_every)
        self.severity = severity
        # drift is stream-local: neither view may sync mid-stream
        test_base = metric.clone()
        test_base.sync_on_compute = False
        self.test = SlidingWindow(test_base, test_window)
        self._block = metric.clone()
        self._block.sync_on_compute = False
        self._block.reset()
        self.reference_value: Any = None
        self._since_eval = 0
        self.last: Optional[Dict[str, Any]] = None
        self.breached = False
        self.history: Deque[Dict[str, Any]] = collections.deque(maxlen=256)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Feed one batch to both views; roll the reference block when it fills and
        evaluate on the ``eval_every`` cadence."""
        self.test.update(*args, **kwargs)
        self._block.update(*args, **kwargs)
        if self._block._update_count >= self.reference_window:
            self.reference_value = self._block.compute()
            self._block.reset()
        self._since_eval += 1
        if self.eval_every and self.reference_value is not None and self._since_eval >= self.eval_every:
            self.evaluate()

    def evaluate(self) -> Optional[Dict[str, Any]]:
        """Score the test window against the current reference (``None`` until the
        first reference block completes); feeds the health plane in a telemetry
        session."""
        self._since_eval = 0
        if self.reference_value is None:
            return None
        score = _leaf_scores(self.test.compute(), self.reference_value, self.mode)
        self.breached = score > self.threshold
        self.last = {
            "name": self.name,
            "score": score,
            "threshold": self.threshold,
            "breached": self.breached,
            "mode": self.mode,
        }
        self.history.append(dict(self.last))
        rec = _observability._ACTIVE
        if rec is not None:
            rec.record_drift(self.name, score, self.breached, self.threshold, severity=self.severity)
        return self.last

    def reset(self) -> None:
        """Forget both views and the reference (a fresh stream)."""
        self.test.reset()
        self._block.reset()
        self.reference_value = None
        self._since_eval = 0
        self.last = None
        self.breached = False
        self.history.clear()

    def __repr__(self) -> str:
        return (
            f"DriftMonitor({self.name!r}, reference_window={self.reference_window}, "
            f"test_window={self.test_window}, threshold={self.threshold})"
        )
