"""Hamming distance metric classes (counterpart of ``torchmetrics_tpu/classification/hamming.py``)."""

from __future__ import annotations

from ..functional.classification.hamming import _hamming_distance_reduce
from .base import _ClassificationTaskWrapper, _task_facade_new
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores


class BinaryHammingDistance(BinaryStatScores):
    """Binary hamming distance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryHammingDistance
        >>> metric = BinaryHammingDistance(device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 0, 1]))
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return _hamming_distance_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average="binary", multidim_average=self.multidim_average,
        )


class MulticlassHammingDistance(MulticlassStatScores):
    """Multiclass hamming distance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassHammingDistance
        >>> metric = MulticlassHammingDistance(num_classes=3, average="micro", device="cpu")
        >>> metric(torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.3, 0.6]]), torch.tensor([0, 1]))
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def _compute(self, state):
        return _hamming_distance_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average,
        )


class MultilabelHammingDistance(MultilabelStatScores):
    """Multilabel hamming distance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelHammingDistance
        >>> metric = MultilabelHammingDistance(num_labels=2, device="cpu")
        >>> metric(torch.tensor([[0.9, 0.2], [0.3, 0.7]]), torch.tensor([[1, 0], [1, 0]]))
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def _compute(self, state):
        return _hamming_distance_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, multilabel=True,
        )


class HammingDistance(_ClassificationTaskWrapper):
    """Task facade over the three hamming-distance classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import HammingDistance
        >>> metric = HammingDistance(task="multilabel", num_labels=2, device="cpu")
        >>> metric(torch.tensor([[0.9, 0.2], [0.3, 0.7]]), torch.tensor([[1, 0], [1, 0]]))
        tensor(0.5000)
    """

    __new__ = _task_facade_new(BinaryHammingDistance, MulticlassHammingDistance, MultilabelHammingDistance)
