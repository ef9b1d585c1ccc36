"""MinMaxMetric (counterpart of ``torchmetrics_tpu/wrappers/minmax.py``): the running
min and max of the wrapped metric's value over time.

The extrema are float32 scalars on the wrapped metric's device, as ``jnp.maximum`` keeps
them float32 whatever the value's type; a Python float goes in through
``torch.as_tensor``, which ``torch.maximum`` needs.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..metric import Metric
from .abstract import WrapperMetric


class MinMaxMetric(WrapperMetric):
    """Report ``{"raw": value, "max": highest seen, "min": lowest seen}``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MinMaxMetric
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = MinMaxMetric(BinaryAccuracy(device="cpu"))
        >>> out1 = metric(torch.tensor([0.9, 0.1]), torch.tensor([1, 0]))
        >>> out2 = metric(torch.tensor([0.9, 0.1]), torch.tensor([0, 0]))
        >>> {k: round(float(v), 4) for k, v in out2.items()}
        {'raw': 0.5, 'max': 1.0, 'min': 0.5}
    """

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `torchmetrics_tpu.Metric` but received {base_metric}"
            )
        super().__init__(base_metric, **kwargs)
        self._base_metric = base_metric
        self._adopt_device()
        self._reset_extrema()

    def _reset_extrema(self) -> None:
        self.min_val = torch.tensor(math.inf, dtype=torch.float32, device=self.device)
        self.max_val = torch.tensor(-math.inf, dtype=torch.float32, device=self.device)

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, torch.Tensor):
            return val.numel() == 1
        if hasattr(val, "shape"):
            return val.size == 1
        return False

    def _fold_extrema(self, val: Any) -> None:
        val = torch.as_tensor(val, device=self.device).to(torch.float32)
        self.max_val = torch.maximum(self.max_val, val)
        self.min_val = torch.minimum(self.min_val, val)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)
        self._update_count += 1
        self._computed = None

    def compute(self) -> Dict[str, Any]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        self._fold_extrema(val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        val = self._base_metric.forward(*args, **kwargs)
        self._update_count += 1
        if self._is_suitable_val(val):
            self._fold_extrema(val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    __call__ = forward

    def _merge_children(self) -> list:
        return [self._base_metric]

    def _merge_wrapper_extra(self, incoming: "MinMaxMetric") -> None:
        # running extrema fold by min and max
        self.min_val = torch.minimum(self.min_val, incoming.min_val.to(self.device))
        self.max_val = torch.maximum(self.max_val, incoming.max_val.to(self.device))

    def _move_extra(self) -> None:
        if "min_val" in self.__dict__:
            self.min_val, self.max_val = self.min_val.to(self.device), self.max_val.to(self.device)

    def _checkpoint_extra(self) -> dict:
        return {"min_val": self.min_val, "max_val": self.max_val}

    def _load_checkpoint_extra(self, extra: dict) -> None:
        self.min_val = extra["min_val"]
        self.max_val = extra["max_val"]

    def reset(self) -> None:
        self._base_metric.reset()
        self._reset_extrema()
        self._update_count = 0
        self._computed = None

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self._base_metric._filter_kwargs(**kwargs)
