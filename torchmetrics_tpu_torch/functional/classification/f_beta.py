"""F-beta reduction (counterpart of
``torchmetrics_tpu/functional/classification/f_beta.py``: ``_fbeta_reduce``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.compute import _adjust_weights_safe_divide, _safe_divide


def _fbeta_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
    zero_division: float = 0,
) -> torch.Tensor:
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp_s, fn_s, fp_s = tp.sum(dim), fn.sum(dim), fp.sum(dim)
        return _safe_divide((1 + beta2) * tp_s, (1 + beta2) * tp_s + beta2 * fn_s + fp_s, zero_division)
    fbeta_score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    return _adjust_weights_safe_divide(fbeta_score, average, multilabel, tp, fp, fn, top_k)
