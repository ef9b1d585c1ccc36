"""Negative predictive value (counterpart of
``torchmetrics_tpu/functional/classification/negative_predictive_value.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.compute import _adjust_weights_safe_divide, _safe_divide
from ._family import make_binary, make_multiclass, make_multilabel, make_task_dispatch


def _negative_predictive_value_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
    zero_division: float = 0,
) -> torch.Tensor:
    if average == "binary":
        return _safe_divide(tn, tn + fn, zero_division)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tn_s, fn_s = tn.sum(dim), fn.sum(dim)
        return _safe_divide(tn_s, tn_s + fn_s, zero_division)
    score = _safe_divide(tn, tn + fn, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


binary_negative_predictive_value = make_binary(_negative_predictive_value_reduce, "binary_negative_predictive_value")
multiclass_negative_predictive_value = make_multiclass(
    _negative_predictive_value_reduce, "multiclass_negative_predictive_value"
)
multilabel_negative_predictive_value = make_multilabel(
    _negative_predictive_value_reduce, "multilabel_negative_predictive_value"
)
negative_predictive_value = make_task_dispatch(
    binary_negative_predictive_value,
    multiclass_negative_predictive_value,
    multilabel_negative_predictive_value,
    "negative_predictive_value",
)
