"""Specificity, the true negative rate (counterpart of
``torchmetrics_tpu/functional/classification/specificity.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.compute import _adjust_weights_safe_divide, _safe_divide
from ._family import make_binary, make_multiclass, make_multilabel, make_task_dispatch


def _specificity_reduce(
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
        return _safe_divide(tn, tn + fp, zero_division)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tn_s, fp_s = tn.sum(dim), fp.sum(dim)
        return _safe_divide(tn_s, tn_s + fp_s, zero_division)
    score = _safe_divide(tn, tn + fp, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


binary_specificity = make_binary(_specificity_reduce, "binary_specificity")
multiclass_specificity = make_multiclass(_specificity_reduce, "multiclass_specificity")
multilabel_specificity = make_multilabel(_specificity_reduce, "multilabel_specificity")
specificity = make_task_dispatch(binary_specificity, multiclass_specificity, multilabel_specificity, "specificity")
