"""Shared machinery of the metrics read off a curve: EER, LogAUC and the four operating
points (counterpart of ``torchmetrics_tpu/functional/classification/_operating_point.py``).

The JAX package reduces each class's curve in a Python loop. Here every class's curve
is a row of one padded ``(K, L)`` layout, as the curve core builds it (the exact rows
after one batched sort, the binned ones straight from the confusion), with each row's
count of valid points; the reductions run along the rows, so their launches do not grow
with the classes. A padded point is masked out of every reduction and never wins.

The two tie rules of the JAX package:

- ``_masked_lex_best`` (precision at recall, recall at precision): the best objective
  where the constraint holds, ties broken by the higher constraint, then by the higher
  threshold; NaN points are dropped; nothing feasible, or a best objective of 0, gives
  the threshold NaN (and the objective 0).
- ``_constrained_first_argmax`` (sensitivity at specificity and the converse): the first
  maximum of the objective where the constraint holds (a NaN objective wins, as in
  ``argmax``); nothing feasible gives ``(0, 1e6)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .precision_recall_curve import (
    _binary_exact_rows,
    _binned_pr,
    _exact_pr_curve_rows,
    _multiclass_exact_rows,
    _multilabel_exact_rows,
)
from .roc import _binned_roc, _exact_roc_curve_rows

Rows = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _is_binned(state, thresholds: Optional[torch.Tensor]) -> bool:
    return not isinstance(state, tuple) and thresholds is not None


def _exact_inputs(state, task: str, num_classes: Optional[int] = None, ignore_index: Optional[int] = None):
    """-> (scores, positives, all-negative flag, kept entries) of the exact state, in the
    ``(K, N)`` layout of the curve core; ``task`` names the state's layout."""
    if task == "binary":
        return (*_binary_exact_rows(state[0], state[1]), None)
    if task == "multiclass":
        return (*_multiclass_exact_rows(state[0], state[1], num_classes), None)
    return _multilabel_exact_rows(state[0], state[1], ignore_index)


def _as_rows(*curves: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Binned curves along the first axis, ``(P,)`` or ``(P, K)``, as ``(K, P)`` rows."""
    return tuple(c[None] if c.ndim == 1 else c.T for c in curves)


def _full(rows: torch.Tensor, points: int) -> torch.Tensor:
    return torch.full((rows.shape[0],), points, dtype=torch.int64, device=rows.device)


def _pr_rows(state, thresholds: Optional[torch.Tensor], task: str, num_classes: Optional[int] = None,
             ignore_index: Optional[int] = None) -> Rows:
    """Every PR curve of the state: (precision, recall, thresholds, points) with
    precision and recall ``(K, P + 1)`` (each row's last valid point the extra (1, 0)),
    the thresholds ``(K, P)`` or, binned, shared ``(T,)``, and ``points`` each row's
    count of thresholds."""
    if _is_binned(state, thresholds):
        precision, recall = _as_rows(*_binned_pr(state))
        return precision, recall, thresholds, _full(precision, thresholds.numel())
    return _exact_pr_curve_rows(*_exact_inputs(state, task, num_classes, ignore_index))


def _roc_rows(state, thresholds: Optional[torch.Tensor], task: str, num_classes: Optional[int] = None,
              ignore_index: Optional[int] = None) -> Rows:
    """Every ROC curve of the state: (fpr, tpr, thresholds, points), the thresholds
    descending, ``(K, P)`` or, binned, shared ``(T,)``."""
    if _is_binned(state, thresholds):
        fpr, tpr = _as_rows(*_binned_roc(state))
        return fpr, tpr, thresholds.flip(0), _full(fpr, thresholds.numel())
    preds, positive, _, keep = _exact_inputs(state, task, num_classes, ignore_index)
    return _exact_roc_curve_rows(preds, positive, keep)


def _aligned(objective: torch.Tensor, constraint: torch.Tensor, thresholds: torch.Tensor, points: torch.Tensor):
    """The rows cut to their common width, the thresholds broadcast to rows, and the
    mask of each row's valid points (its first ``points``)."""
    thresholds = thresholds.expand(objective.shape[0], -1) if thresholds.ndim == 1 else thresholds
    width = min(objective.shape[1], constraint.shape[1], thresholds.shape[1])
    valid = torch.arange(width, device=objective.device) < points[:, None]
    return objective[:, :width], constraint[:, :width], thresholds[:, :width], valid


def _masked_lex_best(objective: torch.Tensor, constraint: torch.Tensor, thresholds: torch.Tensor,
                     points: torch.Tensor, min_constraint: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row by row, the highest ``objective`` with ``constraint >= min_constraint``, ties
    broken by the higher constraint and then the higher threshold: -> (best objective,
    its threshold), each ``(K,)``."""
    obj, con, thr, valid = _aligned(objective, constraint, thresholds, points)
    mask = valid & (con >= min_constraint) & ~(obj.isnan() | con.isnan())
    neg = float("-inf")
    obj_m = torch.where(mask, obj, neg)
    best_obj = obj_m.amax(1, keepdim=True)
    tie = mask & (obj_m == best_obj)
    con_m = torch.where(tie, con, neg)
    tie = tie & (con_m == con_m.amax(1, keepdim=True))
    best_thr = torch.where(tie, thr, neg).amax(1)
    feasible = mask.any(1)
    best_obj = torch.where(feasible, best_obj[:, 0], 0.0)
    best_thr = torch.where(feasible & (best_obj != 0.0), best_thr, float("nan"))
    return best_obj, best_thr


def _constrained_first_argmax(objective: torch.Tensor, constraint: torch.Tensor, thresholds: torch.Tensor,
                              points: torch.Tensor, min_constraint: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row by row, the first maximum of ``objective`` with ``constraint >=
    min_constraint``: -> (objective, threshold) there, or (0, 1e6) where nothing is
    feasible; each ``(K,)``."""
    obj, con, thr, valid = _aligned(objective, constraint, thresholds, points)
    mask = valid & (con >= min_constraint)
    index = torch.where(mask, obj, float("-inf")).argmax(1, keepdim=True)
    feasible = mask.any(1)
    return (torch.where(feasible, obj.gather(1, index)[:, 0], 0.0),
            torch.where(feasible, thr.gather(1, index)[:, 0], 1e6))


def _per_class(point: Tuple[torch.Tensor, torch.Tensor], task: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """A binary task's point as 0-d values; a per-class one as ``(K,)`` values with
    float32 thresholds."""
    value, threshold = point
    if task == "binary":
        return value[0], threshold[0]
    return value, threshold.to(torch.float32)
