"""Accuracy reduction (counterpart of
``torchmetrics_tpu/functional/classification/accuracy.py``: ``_accuracy_reduce``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.compute import _adjust_weights_safe_divide, _safe_divide


def _accuracy_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> torch.Tensor:
    """Reduce stat scores into accuracy."""
    if average == "binary":
        return _safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp_s, fn_s = tp.sum(dim), fn.sum(dim)
        if multilabel:
            fp_s, tn_s = fp.sum(dim), tn.sum(dim)
            return _safe_divide(tp_s + tn_s, tp_s + tn_s + fp_s + fn_s)
        return _safe_divide(tp_s, tp_s + fn_s)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)
