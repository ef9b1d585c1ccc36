"""MetricTracker (counterpart of ``torchmetrics_tpu/wrappers/tracker.py``): a metric or
collection tracked over time steps. ``increment()`` starts a step with a fresh clone,
``compute_all()`` stacks the steps' values on the metric's device, ``best_metric()``
picks the best step.

``best_metric`` moves the values to the host before numpy's ``argmax``: ``np.asarray``
of a CUDA tensor raises ``TypeError``, which a literal port would catch and turn into
``None`` for every metric on the card. It still warns and gives ``None`` where the JAX
package does (a value with more than one element per step).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from ..collections import MetricCollection
from ..metric import Metric
from ..utilities.prints import rank_zero_warn


def _host_array(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class MetricTracker:
    """List of per-step metric clones with best-value bookkeeping.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MetricTracker
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> tracker = MetricTracker(MulticlassAccuracy(num_classes=3, device="cpu"))
        >>> for epoch in range(2):
        ...     tracker.increment()
        ...     tracker.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1]]), torch.tensor([0, epoch]))
        >>> best, which = tracker.best_metric(return_step=True)
        >>> round(float(best), 4), which
        (1.0, 1)
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool], None] = None) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a torchmetrics_tpu"
                f" `Metric` or `MetricCollection` but got {metric}"
            )
        self._base_metric = metric
        if maximize is None:
            if isinstance(metric, Metric):
                if getattr(metric, "higher_is_better", None) is None:
                    raise AttributeError(
                        f"The metric '{type(metric).__name__}' does not have a 'higher_is_better' attribute set,"
                        " and the `maximize` argument was not provided."
                    )
                maximize = bool(metric.higher_is_better)
            else:
                maximize = []
                for name, m in metric.items(keep_base=True):
                    if getattr(m, "higher_is_better", None) is None:
                        raise AttributeError(
                            f"The metric '{name}' does not have a 'higher_is_better' attribute set,"
                            " and the `maximize` argument was not provided."
                        )
                    maximize.append(bool(m.higher_is_better))
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and not (isinstance(metric, MetricCollection) and len(maximize) == len(metric)):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        if isinstance(metric, Metric) and not isinstance(maximize, bool):
            raise ValueError("Argument `maximize` should be a single bool when `metric` is a single Metric")
        self.maximize = maximize
        self._steps: List[Union[Metric, MetricCollection]] = []
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """Number of tracked steps."""
        return len(self._steps)

    def increment(self) -> None:
        """Start a new time step with a fresh (reset) clone."""
        self._increment_called = True
        clone = self._base_metric.clone()
        clone.reset()
        self._steps.append(clone)

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._steps[-1](*args, **kwargs)

    __call__ = forward

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._steps[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._steps[-1].compute()

    def compute_all(self) -> Any:
        """The values of every step, stacked along a new first axis."""
        self._check_for_increment("compute_all")
        res = [step.compute() for step in self._steps]
        if res and isinstance(res[0], dict):
            return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in res[0].keys()}
        return torch.stack([torch.as_tensor(r) for r in res], dim=0)

    def reset(self) -> None:
        """Reset the current step."""
        self._steps[-1].reset()

    def reset_all(self) -> None:
        """Drop every tracked step."""
        self._steps = []
        self._increment_called = False

    def best_metric(self, return_step: bool = False) -> Union[Any, Tuple[Any, Any]]:
        """The best value over the steps, and with ``return_step`` its step."""
        res = self.compute_all()
        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            value: Dict[str, Any] = {}
            idx: Dict[str, Any] = {}
            for i, (k, v) in enumerate(res.items()):
                try:
                    arr = _host_array(v)
                    best = int(np.argmax(arr)) if maximize[i] else int(np.argmin(arr))
                    value[k], idx[k] = float(arr[best]), best
                except (ValueError, TypeError) as err:
                    rank_zero_warn(
                        f"Encountered the following error when trying to get the best metric for metric {k}:"
                        f"{err}. Returning `None` instead.",
                        UserWarning,
                    )
                    value[k], idx[k] = None, None
            return (value, idx) if return_step else value
        try:
            arr = _host_array(res)
            best = int(np.argmax(arr)) if self.maximize else int(np.argmin(arr))
            return (float(arr[best]), best) if return_step else float(arr[best])
        except (ValueError, TypeError) as err:
            rank_zero_warn(
                f"Encountered the following error when trying to get the best metric: {err}."
                " Returning `None` instead.",
                UserWarning,
            )
            return (None, None) if return_step else None

    def __getitem__(self, idx: int) -> Union[Metric, MetricCollection]:
        return self._steps[idx]

    def __len__(self) -> int:
        return len(self._steps)
