"""MultitaskWrapper (counterpart of ``torchmetrics_tpu/wrappers/multitask.py``): a dict
of task name -> metric applied to dicts of task name -> preds and targets."""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Union

from ..collections import MetricCollection
from ..metric import Metric
from .abstract import WrapperMetric


class MultitaskWrapper(WrapperMetric):
    """Compute different metrics on different tasks.

    Args:
        task_metrics: dict of task name -> ``Metric`` or ``MetricCollection``.
        prefix / postfix: added to the task keys of the output dict.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MultitaskWrapper
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> metric = MultitaskWrapper({'cls': BinaryAccuracy(device="cpu"), 'reg': MeanSquaredError(device="cpu")})
        >>> metric.update({'cls': torch.tensor([0.9, 0.1]), 'reg': torch.tensor([2.5, 1.0])},
        ...               {'cls': torch.tensor([1, 0]), 'reg': torch.tensor([3.0, 1.0])})
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'cls': 1.0, 'reg': 0.125}
    """

    def __init__(
        self,
        task_metrics: Dict[str, Union[Metric, MetricCollection]],
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Expected argument `task_metrics` to be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not isinstance(metric, (Metric, MetricCollection)):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )
        if prefix is not None and not isinstance(prefix, str):
            raise TypeError(f"Expected argument `prefix` to either be `None` or a string but got {prefix}")
        if postfix is not None and not isinstance(postfix, str):
            raise TypeError(f"Expected argument `postfix` to either be `None` or a string but got {postfix}")
        super().__init__(*task_metrics.values(), **kwargs)
        self.task_metrics = task_metrics
        self._prefix = prefix or ""
        self._postfix = postfix or ""
        self._adopt_device()

    def _convert(self, d: Dict[str, Any]) -> Dict[str, Any]:
        return {f"{self._prefix}{k}{self._postfix}": v for k, v in d.items()}

    @staticmethod
    def _check_keys(task_metrics: dict, task_preds: dict, task_targets: dict) -> None:
        if task_metrics.keys() != task_preds.keys() or task_metrics.keys() != task_targets.keys():
            raise ValueError(
                "Expected arguments `task_preds` and `task_targets` to have the same keys as the wrapped `task_metrics`. "
                f"Found task_preds.keys() = {task_preds.keys()}, task_targets.keys() = {task_targets.keys()} "
                f"and self.task_metrics.keys() = {task_metrics.keys()}"
            )

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        self._check_keys(self.task_metrics, task_preds, task_targets)
        for name, metric in self.task_metrics.items():
            metric.update(task_preds[name], task_targets[name])
        self._update_count += 1
        self._computed = None

    def compute(self) -> Dict[str, Any]:
        return self._convert({name: metric.compute() for name, metric in self.task_metrics.items()})

    def forward(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> Dict[str, Any]:
        self._check_keys(self.task_metrics, task_preds, task_targets)
        self._update_count += 1
        return self._convert(
            {name: metric.forward(task_preds[name], task_targets[name]) for name, metric in self.task_metrics.items()}
        )

    __call__ = forward

    def _merge_children(self) -> list:
        return [self.task_metrics[k] for k in sorted(self.task_metrics)]

    def merge_state(self, incoming_state: Any) -> None:
        # pairing the sorted children is sound only when the task sets agree
        if isinstance(incoming_state, MultitaskWrapper) and set(self.task_metrics) != set(incoming_state.task_metrics):
            raise ValueError(
                "Cannot merge MultitaskWrappers with different tasks: "
                f"{sorted(set(self.task_metrics) ^ set(incoming_state.task_metrics))}"
            )
        super().merge_state(incoming_state)

    def reset(self) -> None:
        for metric in self.task_metrics.values():
            metric.reset()
        self._update_count = 0
        self._computed = None

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MultitaskWrapper":
        new = copy.deepcopy(self)
        if prefix is not None:
            new._prefix = prefix
        if postfix is not None:
            new._postfix = postfix
        return new

    def keys(self):
        return self.task_metrics.keys()

    def items(self):
        return self.task_metrics.items()

    def values(self):
        return self.task_metrics.values()

    def __getitem__(self, key: str):
        return self.task_metrics[key]
