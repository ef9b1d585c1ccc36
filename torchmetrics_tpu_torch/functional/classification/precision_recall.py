"""Precision and recall (counterpart of
``torchmetrics_tpu/functional/classification/precision_recall.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.compute import _adjust_weights_safe_divide, _safe_divide
from ._family import make_binary, make_multiclass, make_multilabel, make_task_dispatch


def _precision_recall_reduce(
    stat: str,
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
    different_stat = fp if stat == "precision" else fn  # the one count in which the two scores differ
    if average == "binary":
        return _safe_divide(tp, tp + different_stat, zero_division)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = tp.sum(dim)
        different_stat = different_stat.sum(dim)
        return _safe_divide(tp, tp + different_stat, zero_division)
    score = _safe_divide(tp, tp + different_stat, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def _precision_reduce(tp, fp, tn, fn, average, multidim_average="global", multilabel=False, top_k=1, zero_division=0):
    return _precision_recall_reduce("precision", tp, fp, tn, fn, average, multidim_average, multilabel, top_k, zero_division)


def _recall_reduce(tp, fp, tn, fn, average, multidim_average="global", multilabel=False, top_k=1, zero_division=0):
    return _precision_recall_reduce("recall", tp, fp, tn, fn, average, multidim_average, multilabel, top_k, zero_division)


binary_precision = make_binary(_precision_reduce, "binary_precision")
multiclass_precision = make_multiclass(_precision_reduce, "multiclass_precision")
multilabel_precision = make_multilabel(_precision_reduce, "multilabel_precision")
precision = make_task_dispatch(binary_precision, multiclass_precision, multilabel_precision, "precision")

binary_recall = make_binary(_recall_reduce, "binary_recall")
multiclass_recall = make_multiclass(_recall_reduce, "multiclass_recall")
multilabel_recall = make_multilabel(_recall_reduce, "multilabel_recall")
recall = make_task_dispatch(binary_recall, multiclass_recall, multilabel_recall, "recall")
