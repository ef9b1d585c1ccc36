"""KL and Jensen-Shannon divergence metric classes (counterpart of
``torchmetrics_tpu/regression/divergence.py``): a float32 sum state when reducing
(``mean``, ``sum``), a concat state of per-row measures for ``reduction=None``."""

from __future__ import annotations

from typing import Any, Optional

from ..functional.regression.kl_divergence import _jsd_update, _kld_compute, _kld_update
from ..metric import Metric
from ..utilities.compute import _float32_sum
from .mse import _count, _zeros


class _DivergenceBase(Metric):
    """Shared state plumbing of the two divergences."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        self.log_prob = log_prob
        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        if self.reduction in ("mean", "sum"):
            self.add_state("measures", default=_zeros(), dist_reduce_fx="sum")
        else:
            self.add_state("measures", default=[], dist_reduce_fx="cat")
        self.add_state("total", default=_zeros(), dist_reduce_fx="sum")

    def _measures(self, p, q):
        raise NotImplementedError

    def _batch_state(self, p, q):
        measures, total = self._measures(p, q)
        if self.reduction in ("mean", "sum"):
            measures = _float32_sum(measures)
        return {"measures": measures, "total": _count(total, measures)}

    def _compute(self, state):
        measures = state["measures"]
        if self.reduction == "mean":
            return measures / state["total"]
        if self.reduction == "sum":
            return measures
        return _kld_compute(measures, state["total"], self.reduction)


class KLDivergence(_DivergenceBase):
    """KL divergence of row distributions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import KLDivergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> metric = KLDivergence(device="cpu")
        >>> metric.update(p, q)
        >>> metric.compute()
        tensor(0.0853)
    """

    def _measures(self, p, q):
        return _kld_update(p, q, self.log_prob)


class JensenShannonDivergence(_DivergenceBase):
    """Jensen-Shannon divergence of row distributions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import JensenShannonDivergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> metric = JensenShannonDivergence(device="cpu")
        >>> metric.update(p, q)
        >>> metric.compute()
        tensor(0.0225)
    """

    def _measures(self, p, q):
        return _jsd_update(p, q, self.log_prob)
