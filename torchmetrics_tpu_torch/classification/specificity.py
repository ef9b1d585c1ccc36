"""Specificity metric classes (counterpart of ``torchmetrics_tpu/classification/specificity.py``)."""

from __future__ import annotations

from ..functional.classification.specificity import _specificity_reduce
from .base import _ClassificationTaskWrapper, _task_facade_new
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores


class BinarySpecificity(BinaryStatScores):
    """Binary specificity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinarySpecificity
        >>> metric = BinarySpecificity(device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 0, 0]))
        tensor(0.6667)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return _specificity_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average="binary", multidim_average=self.multidim_average, zero_division=self.zero_division,
        )


class MulticlassSpecificity(MulticlassStatScores):
    """Multiclass specificity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassSpecificity
        >>> metric = MulticlassSpecificity(num_classes=3, device="cpu")
        >>> metric(torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.3, 0.6]]), torch.tensor([0, 1]))
        tensor(0.8333)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def _compute(self, state):
        return _specificity_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, top_k=self.top_k,
            zero_division=self.zero_division,
        )


class MultilabelSpecificity(MultilabelStatScores):
    """Multilabel specificity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelSpecificity
        >>> metric = MultilabelSpecificity(num_labels=2, device="cpu")
        >>> metric(torch.tensor([[0.9, 0.2], [0.6, 0.7]]), torch.tensor([[0, 0], [1, 0]]))
        tensor(0.2500)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def _compute(self, state):
        return _specificity_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"],
            average=self.average, multidim_average=self.multidim_average, multilabel=True,
            zero_division=self.zero_division,
        )


class Specificity(_ClassificationTaskWrapper):
    """Task facade over the three specificity classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import Specificity
        >>> metric = Specificity(task="binary", device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 0, 0]))
        tensor(0.6667)
    """

    __new__ = _task_facade_new(BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity)
