"""F-beta and F1 metric classes (counterpart of ``torchmetrics_tpu/classification/f_beta.py``)."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.f_beta import _fbeta_reduce, _validate_beta
from ..metric import Metric
from .base import _ClassificationTaskWrapper, _new_task_metric
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores


class BinaryFBetaScore(BinaryStatScores):
    """Binary F-beta score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryFBetaScore
        >>> metric = BinaryFBetaScore(beta=2.0, device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 1]))
        tensor(0.7143)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        beta: float,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            threshold=threshold,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=False,
            zero_division=zero_division,
            **kwargs,
        )
        if validate_args:
            _validate_beta(beta)
        self.validate_args = validate_args
        self.beta = beta

    def _compute(self, state):
        return _fbeta_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"], self.beta,
            average="binary", multidim_average=self.multidim_average, zero_division=self.zero_division,
        )


class BinaryF1Score(BinaryFBetaScore):
    """Binary F1 score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryF1Score
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BinaryF1Score(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0,
            threshold=threshold,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            zero_division=zero_division,
            **kwargs,
        )


class MulticlassFBetaScore(MulticlassStatScores):
    """Multiclass F-beta score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassFBetaScore
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassFBetaScore(beta=2.0, num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def __init__(
        self,
        beta: float,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            top_k=top_k,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=False,
            zero_division=zero_division,
            **kwargs,
        )
        if validate_args:
            _validate_beta(beta)
        self.validate_args = validate_args
        self.beta = beta

    def _compute(self, state):
        return _fbeta_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"], self.beta,
            average=self.average, multidim_average=self.multidim_average, top_k=self.top_k,
            zero_division=self.zero_division,
        )


class MulticlassF1Score(MulticlassFBetaScore):
    """Multiclass F1 score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassF1Score
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> metric = MulticlassF1Score(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0,
            num_classes=num_classes,
            top_k=top_k,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            zero_division=zero_division,
            **kwargs,
        )


class MultilabelFBetaScore(MultilabelStatScores):
    """Multilabel F-beta score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelFBetaScore
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelFBetaScore(beta=2.0, num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.7963)
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def __init__(
        self,
        beta: float,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels,
            threshold=threshold,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=False,
            zero_division=zero_division,
            **kwargs,
        )
        if validate_args:
            _validate_beta(beta)
        self.validate_args = validate_args
        self.beta = beta

    def _compute(self, state):
        return _fbeta_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"], self.beta,
            average=self.average, multidim_average=self.multidim_average, multilabel=True,
            zero_division=self.zero_division,
        )


class MultilabelF1Score(MultilabelFBetaScore):
    """Multilabel F1 score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelF1Score
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric = MultilabelF1Score(num_labels=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.7778)
    """

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0,
            num_labels=num_labels,
            threshold=threshold,
            average=average,
            multidim_average=multidim_average,
            ignore_index=ignore_index,
            validate_args=validate_args,
            zero_division=zero_division,
            **kwargs,
        )


_FBETA_CLASSES = (BinaryFBetaScore, MulticlassFBetaScore, MultilabelFBetaScore)
_F1_CLASSES = (BinaryF1Score, MulticlassF1Score, MultilabelF1Score)


class FBetaScore(_ClassificationTaskWrapper):
    """Task facade over the three F-beta classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import FBetaScore
        >>> metric = FBetaScore(task="binary", beta=2.0, device="cpu")
        >>> metric(torch.tensor([0.2, 0.8, 0.6, 0.4]), torch.tensor([0, 1, 1, 1]))
        tensor(0.7143)
    """

    def __new__(
        cls,
        task: str,
        beta: float = 1.0,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update(multidim_average=multidim_average, ignore_index=ignore_index, validate_args=validate_args,
                      zero_division=zero_division)
        return _new_task_metric(_FBETA_CLASSES, task, threshold, num_classes, num_labels, average, top_k, beta,
                                **kwargs)


class F1Score(_ClassificationTaskWrapper):
    """Task facade over the three F1 classes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import F1Score
        >>> metric = F1Score(task="multilabel", num_labels=2, device="cpu")
        >>> metric(torch.tensor([[0.9, 0.2], [0.6, 0.7]]), torch.tensor([[1, 1], [1, 0]]))
        tensor(0.6667)
    """

    def __new__(
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update(multidim_average=multidim_average, ignore_index=ignore_index, validate_args=validate_args,
                      zero_division=zero_division)
        return _new_task_metric(_F1_CLASSES, task, threshold, num_classes, num_labels, average, top_k, **kwargs)
