"""F-beta / F1 metric classes, multiclass (counterpart of
``torchmetrics_tpu/classification/f_beta.py``)."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.classification.f_beta import _fbeta_reduce
from .stat_scores import MulticlassStatScores


def _validate_beta(beta: float) -> None:
    if not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a positive float, but got {beta}.")


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
