"""Accuracy metric class, multiclass (counterpart of
``torchmetrics_tpu/classification/accuracy.py``)."""

from __future__ import annotations

from ..functional.classification.accuracy import _accuracy_reduce
from .stat_scores import MulticlassStatScores


class MulticlassAccuracy(MulticlassStatScores):
    """Multiclass accuracy.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassAccuracy(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True

    def _compute(self, state):
        return _accuracy_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, top_k=self.top_k,
        )
