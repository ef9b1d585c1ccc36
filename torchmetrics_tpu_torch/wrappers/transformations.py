"""Input-transforming wrappers (counterpart of ``torchmetrics_tpu/wrappers/transformations.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from ..collections import MetricCollection
from ..metric import Metric, _to_device
from .abstract import WrapperMetric


class MetricInputTransformer(WrapperMetric):
    """Base class: preprocess (preds, target) before delegating to the wrapped metric.

    Subclasses override ``transform_pred`` and/or ``transform_target``.
    """

    def __init__(self, wrapped_metric: Union[Metric, MetricCollection], **kwargs: Any) -> None:
        if not isinstance(wrapped_metric, (Metric, MetricCollection)):
            raise TypeError(
                "Expected wrapped metric to be an instance of `torchmetrics_tpu_torch.Metric` or "
                f"`torchmetrics_tpu_torch.MetricCollection` but received {wrapped_metric}"
            )
        super().__init__(wrapped_metric, **kwargs)
        self.wrapped_metric = wrapped_metric
        self._adopt_device()

    def _merge_children(self) -> list:
        return [self.wrapped_metric]

    def transform_pred(self, pred: Any) -> Any:
        """Identity by default."""
        return pred

    def transform_target(self, target: Any) -> Any:
        """Identity by default."""
        return target

    def _wrap_transform(self, *args: Any) -> tuple:
        if len(args) == 1:
            return (self.transform_pred(args[0]),)
        if len(args) >= 2:
            return (self.transform_pred(args[0]), self.transform_target(args[1]), *args[2:])
        return args

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.wrapped_metric.update(*self._wrap_transform(*args), **kwargs)
        self._update_count += 1
        self._computed = None

    def compute(self) -> Any:
        return self.wrapped_metric.compute()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._update_count += 1
        return self.wrapped_metric.forward(*self._wrap_transform(*args), **kwargs)

    __call__ = forward

    def reset(self) -> None:
        self.wrapped_metric.reset()
        self._update_count = 0
        self._computed = None

    def _filter_kwargs(self, **kwargs: Any) -> dict:
        return kwargs


class LambdaInputTransformer(MetricInputTransformer):
    """Transform inputs with user-provided callables.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import LambdaInputTransformer
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = LambdaInputTransformer(BinaryAccuracy(device="cpu"), transform_pred=lambda p: 1 - p)
        >>> metric.update(torch.tensor([0.2, 0.8, 0.1]), torch.tensor([1, 0, 1]))
        >>> metric.compute()
        tensor(1.)
    """

    def __init__(
        self,
        wrapped_metric: Union[Metric, MetricCollection],
        transform_pred: Optional[Callable] = None,
        transform_target: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(wrapped_metric, **kwargs)
        if transform_pred is not None and not callable(transform_pred):
            raise TypeError(f"Expected `transform_pred` to be a callable, but got {type(transform_pred)}")
        if transform_target is not None and not callable(transform_target):
            raise TypeError(f"Expected `transform_target` to be a callable, but got {type(transform_target)}")
        if transform_pred is not None:
            self.transform_pred = transform_pred  # type: ignore[method-assign]
        if transform_target is not None:
            self.transform_target = transform_target  # type: ignore[method-assign]


class BinaryTargetTransformer(MetricInputTransformer):
    """Binarize targets at ``threshold``: int32 ones where the target is above it.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import BinaryTargetTransformer
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = BinaryTargetTransformer(BinaryAccuracy(device="cpu"), threshold=2)
        >>> metric.update(torch.tensor([0.8, 0.2, 0.9]), torch.tensor([3.0, 1.0, 5.0]))
        >>> metric.compute()
        tensor(1.)
    """

    def __init__(
        self, wrapped_metric: Union[Metric, MetricCollection], threshold: float = 0, **kwargs: Any
    ) -> None:
        super().__init__(wrapped_metric, **kwargs)
        if not isinstance(threshold, (int, float)):
            raise TypeError(f"Expected `threshold` to be a float, but got {type(threshold)}")
        self.threshold = threshold

    def transform_target(self, target: Any) -> torch.Tensor:
        target = torch.as_tensor(_to_device(target, self.device), device=self.device)
        return (target > self.threshold).to(torch.int32)
