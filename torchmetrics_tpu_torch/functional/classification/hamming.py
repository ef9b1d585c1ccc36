"""Hamming distance (counterpart of
``torchmetrics_tpu/functional/classification/hamming.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.compute import _adjust_weights_safe_divide, _safe_divide
from ._family import make_binary, make_multiclass, make_multilabel, make_task_dispatch


def _hamming_distance_reduce(
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
    """One minus accuracy. As in the JAX package, ``top_k`` does not reach the macro
    weights: a class counts as absent when it has no tp, fp or fn."""
    if average == "binary":
        return 1 - _safe_divide(tp + tn, tp + fp + tn + fn)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp_s, fn_s = tp.sum(dim), fn.sum(dim)
        if multilabel:
            fp_s, tn_s = fp.sum(dim), tn.sum(dim)
            return 1 - _safe_divide(tp_s + tn_s, tp_s + tn_s + fp_s + fn_s)
        return 1 - _safe_divide(tp_s, tp_s + fn_s)
    score = 1 - _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else 1 - _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


binary_hamming_distance = make_binary(_hamming_distance_reduce, "binary_hamming_distance")
multiclass_hamming_distance = make_multiclass(_hamming_distance_reduce, "multiclass_hamming_distance")
multilabel_hamming_distance = make_multilabel(_hamming_distance_reduce, "multilabel_hamming_distance")
hamming_distance = make_task_dispatch(
    binary_hamming_distance, multiclass_hamming_distance, multilabel_hamming_distance, "hamming_distance"
)
