"""ClasswiseWrapper (counterpart of ``torchmetrics_tpu/wrappers/classwise.py``): a
per-class output (``average=None`` metrics) as a labelled dict."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from ..metric import Metric
from .abstract import WrapperMetric


class ClasswiseWrapper(WrapperMetric):
    """Wrap a metric returning a per-class vector into a ``{label: scalar}`` dict.

    Args:
        metric: base metric returning a tensor with one element per class.
        labels: list of class label strings; defaults to class indices.
        prefix: key prefix; defaults to ``<metricname>_`` when neither prefix nor
            postfix is given.
        postfix: key postfix.
        device: the device to run on; the wrapped metric's by default.

    A dict output (detection's) labels its ``*_per_class`` vectors by the class ids of
    the metric's ``classes`` output (user labels are indexed by class id), and passes
    every other key through under its prefixed name, ``classes`` included.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import ClasswiseWrapper
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = ClasswiseWrapper(MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
        >>> metric.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'multiclassaccuracy_0': 1.0, 'multiclassaccuracy_1': 1.0, 'multiclassaccuracy_2': 1.0}
    """

    def __init__(
        self,
        metric: Metric,
        labels: Optional[List[str]] = None,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        if prefix is not None and not isinstance(prefix, str):
            raise ValueError(f"Expected argument `prefix` to either be `None` or a string but got {prefix}")
        if postfix is not None and not isinstance(postfix, str):
            raise ValueError(f"Expected argument `postfix` to either be `None` or a string but got {postfix}")
        super().__init__(metric, device=device)
        self.metric = metric
        self.labels = labels
        if prefix is None and postfix is None:
            prefix = f"{type(metric).__name__.lower()}_"
        self._prefix = prefix or ""
        self._postfix = postfix or ""
        self._adopt_device()

    def _convert_output(self, x: Any) -> Dict[str, Any]:
        if isinstance(x, dict):
            out: Dict[str, Any] = {}
            for key, val in x.items():
                if key.endswith("_per_class") and getattr(val, "ndim", 0) == 1:
                    stem = key[: -len("_per_class")]
                    # per-class vectors align with the observed class ids (``classes``),
                    # which may be sparse: user labels are indexed by class id
                    classes = x.get("classes")
                    if classes is not None and getattr(classes, "ndim", 0) == 1 and classes.shape[0] == val.shape[0]:
                        class_ids = [int(c) for c in classes.tolist()]
                    else:
                        class_ids = list(range(int(val.shape[0])))
                    if self.labels is not None:
                        if class_ids and max(class_ids) >= len(self.labels):
                            raise ValueError(
                                f"Metric reported class id {max(class_ids)} but only "
                                f"{len(self.labels)} labels were given for key {key!r}."
                            )
                        labels = [self.labels[c] for c in class_ids]
                    else:
                        labels = class_ids
                    for i, lab in enumerate(labels):
                        out[f"{self._prefix}{stem}_{lab}{self._postfix}"] = val[i]
                else:
                    out[f"{self._prefix}{key}{self._postfix}"] = val
            return out
        n = int(x.shape[0]) if getattr(x, "ndim", 0) > 0 else 1
        labels = self.labels if self.labels is not None else list(range(n))
        if len(labels) != n:
            raise ValueError(
                f"Expected number of labels ({len(labels)}) to match the metric output length ({n})."
            )
        return {f"{self._prefix}{lab}{self._postfix}": x[i] for i, lab in enumerate(labels)}

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.metric._filter_kwargs(**kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)
        self._update_count += 1
        self._computed = None

    def compute(self) -> Dict[str, Any]:
        return self._convert_output(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        val = self.metric.forward(*args, **kwargs)
        self._update_count += 1
        return self._convert_output(val)

    __call__ = forward

    def _merge_children(self) -> list:
        return [self.metric]

    def reset(self) -> None:
        self.metric.reset()
        self._update_count = 0
        self._computed = None

    @property
    def metric_state(self) -> dict:
        return self.metric.metric_state
