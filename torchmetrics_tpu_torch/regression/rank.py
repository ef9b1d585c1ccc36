"""Spearman and Kendall rank correlation and cosine similarity metric classes
(counterpart of ``torchmetrics_tpu/regression/rank.py``): concat states that keep the
samples, ranked or scored at compute."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.regression.cosine_similarity import _cosine_similarity_compute, _cosine_similarity_update
from ..functional.regression.kendall import _ALLOWED_ALTERNATIVES, _ALLOWED_VARIANTS, _kendall_corrcoef_compute
from ..functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from ..metric import Metric


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import SpearmanCorrCoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = SpearmanCorrCoef(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.0000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError("Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        preds, target = _spearman_corrcoef_update(preds, target, self.num_outputs)
        return {"preds": preds, "target": target}

    def _compute(self, state):
        return _spearman_corrcoef_compute(state["preds"], state["target"])


class KendallRankCorrCoef(Metric):
    """Kendall rank correlation coefficient (variants a, b and c); ``(tau, p_value)``
    when ``t_test``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import KendallRankCorrCoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = KendallRankCorrCoef(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        variant: str = "b",
        t_test: bool = False,
        alternative: Optional[str] = "two-sided",
        num_outputs: int = 1,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if variant not in _ALLOWED_VARIANTS:
            raise ValueError(f"Argument `variant` is expected to be one of {_ALLOWED_VARIANTS}, but got {variant!r}")
        if not isinstance(t_test, bool):
            raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {t_test}.")
        if t_test and alternative not in _ALLOWED_ALTERNATIVES:
            raise ValueError(f"Argument `alternative` is expected to be one of {_ALLOWED_ALTERNATIVES}, but got {alternative!r}")
        self.variant = variant
        self.alternative = alternative if t_test else None
        self.t_test = t_test
        self.num_outputs = num_outputs
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        return {"preds": preds.to(torch.float32), "target": target.to(torch.float32)}

    def _compute(self, state):
        tau, p_value = _kendall_corrcoef_compute(state["preds"], state["target"], self.variant, self.t_test,
                                                 self.alternative)
        if p_value is not None:
            return tau, p_value
        return tau


class CosineSimilarity(Metric):
    """Cosine similarity of row pairs (``reduction`` sum, mean or none).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import CosineSimilarity
        >>> preds = torch.tensor([[1.0, 2.0, 3.0], [1.0, 0.0, 1.0]])
        >>> target = torch.tensor([[1.0, 2.0, 2.0], [0.5, 0.0, 1.0]])
        >>> metric = CosineSimilarity(reduction='mean', device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.9643)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        preds, target = _cosine_similarity_update(preds, target)
        return {"preds": preds, "target": target}

    def _compute(self, state):
        return _cosine_similarity_compute(state["preds"], state["target"], self.reduction)
