"""Nominal association metric classes (counterpart of ``torchmetrics_tpu/nominal/metrics.py``).

The four contingency metrics share one design: a ``(C, C)`` float32 sum state, to which
each update adds its int32 table (counted on the metric's device), and a scalar
computed on the host from the small table. ``FleissKappa`` keeps the per-sample counts
as a cat state.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..functional.nominal._association import (
    _cramers_v_compute,
    _nominal_update,
    _pearsons_contingency_coefficient_compute,
    _theils_u_compute,
    _tschuprows_t_compute,
)
from ..functional.nominal.fleiss_kappa import _fleiss_kappa_compute, _fleiss_kappa_update
from ..functional.nominal.utils import _nominal_input_validation
from ..metric import Metric


class _ContingencyMetric(Metric):
    """Shared shell for the confusion-state nominal metrics."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    _jittable_compute = False

    def __init__(
        self,
        num_classes: int,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError(f"Expected argument `num_classes` to be a positive integer, but got {num_classes}")
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.num_classes = num_classes
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=torch.float32), dist_reduce_fx="sum")

    def _prepare_inputs(self, preds, target):
        confmat = _nominal_update(preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value)
        return (confmat,), {}

    def _batch_state(self, confmat):
        return {"confmat": confmat}


class CramersV(_ContingencyMetric):
    """Cramer's V association statistic.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import CramersV
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 1, 0])
        >>> metric = CramersV(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6847)
    """

    def __init__(
        self,
        num_classes: int,
        bias_correction: bool = True,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, nan_strategy, nan_replace_value, **kwargs)
        self.bias_correction = bias_correction

    def _compute(self, state):
        return _cramers_v_compute(state["confmat"], self.bias_correction)


class PearsonsContingencyCoefficient(_ContingencyMetric):
    """Pearson's contingency coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import PearsonsContingencyCoefficient
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 1, 0])
        >>> metric = PearsonsContingencyCoefficient(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.7348)
    """

    def _compute(self, state):
        return _pearsons_contingency_coefficient_compute(state["confmat"])


class TheilsU(_ContingencyMetric):
    """Theil's U uncertainty coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import TheilsU
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 1, 0])
        >>> metric = TheilsU(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6181)
    """

    def _compute(self, state):
        return _theils_u_compute(state["confmat"])


class TschuprowsT(_ContingencyMetric):
    """Tschuprow's T association statistic.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import TschuprowsT
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 1, 0])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 1, 0])
        >>> metric = TschuprowsT(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6847)
    """

    def __init__(
        self,
        num_classes: int,
        bias_correction: bool = True,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, nan_strategy, nan_replace_value, **kwargs)
        self.bias_correction = bias_correction

    def _compute(self, state):
        return _tschuprows_t_compute(state["confmat"], self.bias_correction)


class FleissKappa(Metric):
    """Fleiss' kappa inter-rater agreement.

    The per-sample counts are a cat state: kappa does not decompose into fixed-size
    sufficient statistics, because the rater normalisation depends on the global maximum
    rater count.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import FleissKappa
        >>> ratings = torch.tensor([[0, 4, 1], [2, 2, 1], [4, 0, 1], [1, 3, 1]])
        >>> metric = FleissKappa(mode='counts', device="cpu")
        >>> metric.update(ratings)
        >>> metric.compute()
        tensor(0.0945)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, mode: str = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ["counts", "probs"]:
            raise ValueError("Argument ``mode`` must be one of ['counts', 'probs'].")
        self.mode = mode
        self.add_state("counts", default=[], dist_reduce_fx="cat")

    def _batch_state(self, ratings):
        return {"counts": _fleiss_kappa_update(ratings, self.mode)}

    def _compute(self, state):
        return _fleiss_kappa_compute(state["counts"])
