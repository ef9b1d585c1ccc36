"""Precision-recall curves, the core of the curve family (counterpart of
``torchmetrics_tpu/functional/classification/precision_recall_curve.py``).

Two paths, as in the JAX package:

- **Binned** (``thresholds`` given): the state is an int32 confusion tensor per threshold,
  ``(T, 2, 2)`` or ``(T, C, 2, 2)``, laid out ``[[tn, fp], [fn, tp]]``. The JAX package
  contracts an ``(M, C, T)`` float32 mask in chunked matmuls; PyTorch would build that
  mask whole (20 GB for ImageNet's 50,000 x 1,000 scores at 100 thresholds). Here each
  score's count of passed thresholds (``searchsorted`` on the sorted thresholds, NaN
  passing none) goes into one int64 histogram over (class, positive, count), and a
  reverse cumulative sum over the counts gives every threshold's tp and fp: exact, in
  chunks of ``_BINNED_CHUNK`` scores, for thresholds in any order and with repeats.
- **Exact** (``thresholds=None``): the states are the raw scores and targets, and the
  curve has one point per distinct score. All classes are sorted in one batched sort of
  a ``(C, N)`` layout (the JAX package loops over classes on the host), in numpy's order:
  an ascending stable sort of ``-preds`` puts NaN last, as ``np.argsort(-preds,
  kind="stable")`` does, where a descending torch sort would put it first. Each row's
  distinct thresholds are compacted to its front; the per-class lists the JAX package
  returns are split from one tensor after one host read of their lengths.

Counts are cast to float32 before any division, as the JAX package's float64 numpy
counts are cast by ``jnp.asarray`` before it divides, so the ratios have the same bits.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _safe_divide, normalize_logits_if_needed
from ...utilities.enums import ClassificationTask
from ...utilities.prints import rank_zero_warn
from .stat_scores import _check_task_args, _ignore_weights

# scores per histogram pass of a binned update: bounds its temporaries near 60 MB
_BINNED_CHUNK = 1 << 21

Curve = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
CurveLists = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def _adjust_threshold_arg(thresholds=None, device: Optional[torch.device] = None) -> Optional[torch.Tensor]:
    """``thresholds`` as a float32 tensor: an int ``T`` is ``T`` points from 0 to 1
    (numpy's ``linspace`` in float32, so the bits are the JAX package's); a list, array
    or tensor is kept in its order, repeats included."""
    if thresholds is None:
        return None
    if isinstance(thresholds, int):
        thresholds = np.linspace(0, 1, thresholds, dtype=np.float32)
    if isinstance(thresholds, torch.Tensor):
        return thresholds.to(device=device if device is not None else thresholds.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(thresholds, np.float32), device=device)


# ------------------------------------------------------------------ binned


def _binned_counts(
    preds: torch.Tensor, positive: torch.Tensor, keep: torch.Tensor, thresholds: torch.Tensor
) -> torch.Tensor:
    """int32 ``(T, K, 2, 2)`` confusion per threshold and column of the ``(M, K)`` scores
    ``preds``: ``positive`` marks the positives, ``keep`` the counted entries. A score
    counts as predicted positive at a threshold it is ``>=`` to; NaN at none."""
    m, k = preds.shape
    t = thresholds.numel()
    dtype = torch.promote_types(preds.dtype, torch.float32)
    ordered, perm = torch.sort(thresholds.to(dtype), stable=True)
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(t, device=perm.device)
    n_bins = k * 2 * (t + 1)
    hist = torch.zeros(n_bins + 1, dtype=torch.int64, device=preds.device)
    column = torch.arange(k, device=preds.device) * 2
    rows = max(1, _BINNED_CHUNK // max(k, 1))
    for start in range(0, m, rows):
        p = preds[start:start + rows].to(dtype).contiguous()
        passed = torch.searchsorted(ordered, p, right=True)  # thresholds <= p
        passed = torch.where(p.isnan(), 0, passed)
        bins = (column + positive[start:start + rows]) * (t + 1) + passed
        hist += torch.bincount(torch.where(keep[start:start + rows], bins, n_bins).reshape(-1), minlength=n_bins + 1)
    # at_least[..., j]: scores passing j or more of the sorted thresholds
    at_least = hist[:n_bins].reshape(k, 2, t + 1).flip(-1).cumsum(-1).flip(-1)
    passing = at_least[..., 1:][..., rank]  # (K, 2, T), in the thresholds' own order
    total = at_least[..., :1]
    fp, tp = passing[:, 0], passing[:, 1]
    fn, tn = total[:, 1] - tp, total[:, 0] - fp
    state = torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)  # (K, T, 2, 2)
    return state.transpose(0, 1).to(torch.int32)


def _binned_pr(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, ...) confusion -> precision, recall with NaN where undefined, each ending in
    the extra point (1, 0) along the first axis."""
    tps, fps, fns = state[..., 1, 1], state[..., 0, 1], state[..., 1, 0]
    precision = _safe_divide(tps, tps + fps, float("nan"))
    recall = _safe_divide(tps, tps + fns, float("nan"))
    precision = torch.cat([precision, torch.ones_like(precision[:1])])
    recall = torch.cat([recall, torch.zeros_like(recall[:1])])
    return precision, recall


# ------------------------------------------------------------------- exact


class _SortedCounts(NamedTuple):
    """Each row's points at its distinct thresholds, compacted to the row's front and
    padded by repeating its last point: fps, tps (float32), thresholds (the scores'
    dtype), all ``(K, L)``, and the points per row (``(K,)``, on the device)."""

    fps: torch.Tensor
    tps: torch.Tensor
    thresholds: torch.Tensor
    lengths: torch.Tensor


def _compact_index(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (index, count): ``index[i, j]`` is the column of row ``i``'s ``j``-th set entry
    of ``mask`` for ``j < count[i]``, and its last set entry's beyond."""
    k, n = mask.shape
    position = mask.cumsum(1) - 1
    count = position[:, -1] + 1
    index = torch.zeros((k, n + 1), dtype=torch.int64, device=mask.device)
    index.scatter_(1, torch.where(mask, position, n), torch.arange(n, device=mask.device).expand(k, n))
    index = index[:, :n]
    last = index.gather(1, (count - 1).clamp(min=0)[:, None])
    return torch.where(torch.arange(n, device=mask.device) < count[:, None], index, last), count


def _numpy_order(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The indices of numpy's stable ascending sort of ``x``: equal values (``-0.0`` and
    ``+0.0`` among them) keep their order and every NaN comes last. The sort's key has
    one zero and one NaN, since CUDA's radix sort of a float orders ``-0.0`` before
    ``+0.0`` and NaNs by their bits."""
    key = torch.where(x == 0, torch.zeros_like(x), x)
    key = torch.where(key.isnan(), torch.full_like(key, float("nan")), key)
    return torch.sort(key, dim=dim, stable=True).indices


def _sorted_counts(preds: torch.Tensor, positive: torch.Tensor, keep: Optional[torch.Tensor] = None) -> _SortedCounts:
    """False and true positives at every distinct threshold of each row of the ``(K, N)``
    scores, thresholds descending: the JAX package's ``_binary_clf_curve`` per row, with
    the entries outside ``keep`` left out of their row."""
    k, n = preds.shape
    order = _numpy_order(-preds, dim=1)
    if keep is None:
        n_valid = torch.full((k,), n, dtype=torch.int64, device=preds.device)
    else:  # kept entries first, each part still in score order
        dropped = (~keep).gather(1, order).to(torch.uint8)
        order = order.gather(1, torch.sort(dropped, dim=1, stable=True).indices)
        n_valid = keep.sum(1)
    scores = preds.gather(1, order)
    tps = positive.gather(1, order).cumsum(1)
    fps = torch.arange(1, n + 1, device=preds.device) - tps
    column = torch.arange(n, device=preds.device)
    last = n_valid[:, None] - 1
    distinct = torch.ones((k, n), dtype=torch.bool, device=preds.device)
    distinct[:, :-1] = scores.diff(dim=1) != 0  # NaNs and equal infinities differ, as in numpy
    distinct = (distinct & (column < last)) | (column == last)
    index, lengths = _compact_index(distinct)
    return _SortedCounts(fps.gather(1, index).to(torch.float32), tps.gather(1, index).to(torch.float32),
                         scores.gather(1, index), lengths)


def _last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``(K, 1)``: each row's last valid entry."""
    return x.gather(1, (lengths - 1).clamp(min=0)[:, None])


def _reversed_rows(x: torch.Tensor, lengths: torch.Tensor, tail: Optional[float] = None) -> torch.Tensor:
    """Each row's valid part reversed; then ``tail`` (when given) and padding by
    repeating the row's last entry."""
    k, n = x.shape
    column = torch.arange(n + (tail is not None), device=x.device)
    index = lengths[:, None] - 1 - column
    if tail is None:
        return x.gather(1, index.clamp(min=0))
    x = torch.cat([x, torch.full((k, 1), tail, dtype=x.dtype, device=x.device)], dim=1)
    return x.gather(1, torch.where(index >= 0, index, n))


def _exact_pr_rows(counts: _SortedCounts, all_negative: torch.Tensor):
    """-> (precision, recall, thresholds, lengths): padded rows of the exact PR curves,
    ascending thresholds; precision and recall hold ``lengths + 1`` points, the last one
    (1, 0). Recall is 1 where ``all_negative`` (the JAX package's literal test that
    every target is 0)."""
    fps, tps, thresholds, lengths = counts
    precision = tps / (tps + fps)
    recall = torch.where(all_negative.reshape(-1, 1), 1.0, tps / _last(tps, lengths))
    return (_reversed_rows(precision, lengths, 1.0), _reversed_rows(recall, lengths, 0.0),
            _reversed_rows(thresholds, lengths), lengths)


def _rows_to_list(x: torch.Tensor, lengths: List[int]) -> List[torch.Tensor]:
    """The valid part of each padded row, as views of one packed tensor."""
    valid = torch.arange(x.shape[1], device=x.device) < torch.tensor(lengths, device=x.device)[:, None]
    return list(x[valid].split(lengths))


def _host_ints(*values: torch.Tensor) -> List[List[int]]:
    """Small integer or bool tensors of one length, read back to the host in one copy."""
    return torch.stack([v.reshape(-1).to(torch.int64) for v in values]).tolist()


def _check_rows(empty: int) -> None:
    """A row without a single kept entry (a multilabel label whose every target is
    ``ignore_index``) has no curve: raise the JAX package's error, which its numpy gives
    on the empty row."""
    if empty:
        raise IndexError("index -1 is out of bounds for axis 0 with size 0")


def _warn_no_positives(all_negative: List[int]) -> None:
    if any(all_negative):
        rank_zero_warn(
            "No positive samples found in target, recall is undefined. Setting recall to one for all thresholds.",
            UserWarning,
        )


def _exact_pr_curve_rows(preds: torch.Tensor, positive: torch.Tensor, all_negative: torch.Tensor,
                         keep: Optional[torch.Tensor] = None):
    """``_exact_pr_rows`` of the ``(K, N)`` scores after one host read, which raises on
    an empty row and warns where a row has no positives."""
    precision, recall, thresholds, lengths = _exact_pr_rows(_sorted_counts(preds, positive, keep), all_negative)
    (empty, no_positives), = _host_ints(torch.stack([(lengths == 0).any(), all_negative.any()]))
    _check_rows(empty)
    _warn_no_positives([no_positives])
    return precision, recall, thresholds, lengths


def _exact_pr_compute(preds: torch.Tensor, positive: torch.Tensor, all_negative: torch.Tensor,
                      keep: Optional[torch.Tensor] = None) -> CurveLists:
    """Per-row exact PR curves of the ``(K, N)`` scores, as lists."""
    precision, recall, thresholds, lengths = _exact_pr_rows(_sorted_counts(preds, positive, keep), all_negative)
    lengths, all_negative = _host_ints(lengths, all_negative.expand(lengths.shape))
    _check_rows(0 in lengths)
    _warn_no_positives(all_negative)
    points = [n + 1 for n in lengths]
    return _rows_to_list(precision, points), _rows_to_list(recall, points), _rows_to_list(thresholds, lengths)


def _binary_exact_rows(preds: torch.Tensor, target: torch.Tensor, pos_label: int = 1):
    """The ``(1, N)`` layout of one binary curve: scores, positives, all-negative flag."""
    return preds.reshape(1, -1), (target == pos_label).reshape(1, -1), (target == 0).all()


def _multiclass_exact_rows(preds: torch.Tensor, target: torch.Tensor, num_classes: int):
    """The ``(C, M)`` layout of ``(M, C)`` scores, one-vs-rest: class ``i``'s positives
    are the targets equal to ``i``; the all-negative flag tests every target for 0."""
    classes = torch.arange(num_classes, device=target.device)
    return preds.T.contiguous(), target[None, :] == classes[:, None], (target == 0).all()


def _multilabel_exact_rows(preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None):
    """The ``(C, M)`` layout of ``(M, C)`` multilabel scores, with each label's entries
    whose target is ``ignore_index`` left out of its row."""
    target = target.T
    keep = None if ignore_index is None else target != ignore_index
    zero = target == 0
    all_negative = (zero if keep is None else zero | ~keep).all(1)
    return preds.T.contiguous(), target == 1, all_negative, keep


def _reduce_class_scores(res: torch.Tensor, average: Optional[str], weights: Optional[torch.Tensor] = None):
    """Per-class AUROC or AP -> ``average``: ``"macro"`` and ``"weighted"`` skip the NaN
    classes (with a warning, whose host read is skipped under ``torch.export`` as the
    JAX package skips it while tracing), ``"none"``/None return them all."""
    if average is None or average == "none":
        return res
    valid = ~res.isnan()
    if not torch.compiler.is_exporting() and not bool(valid.all()):
        rank_zero_warn(
            f"Average precision score for one or more classes was `nan`. Ignoring these classes in {average}-average",
            UserWarning,
        )
    scores = torch.where(valid, res, 0.0)
    if average == "macro":
        return scores.sum() / valid.sum()
    if average == "weighted" and weights is not None:
        weights = torch.where(valid, weights.to(torch.float32), 0.0)
        return (scores * _safe_divide(weights, weights.sum())).sum()
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


# ------------------------------------------------------------------ binary


def _binary_precision_recall_curve_arg_validation(thresholds=None, ignore_index: Optional[int] = None) -> None:
    if thresholds is not None and not isinstance(thresholds, (list, int)) and not hasattr(thresholds, "shape"):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or tensor of floats,"
            f" but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}")
    if isinstance(thresholds, list) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(f"If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range,"
                         f" but got {thresholds}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_precision_recall_curve_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> None:
    """Shape and dtype checks, then the target's values (read back to the host)."""
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError("Expected argument `preds` to be an floating tensor with probability/logit scores,"
                         f" but got tensor with dtype {preds.dtype}")
    ok = (target == 0) | (target == 1)
    if ignore_index is not None:
        ok |= target == ignore_index
    if not bool(ok.all()):
        raise RuntimeError(f"Detected the following values in `target`: {torch.unique(target).tolist()} but expected"
                           f" only the following values {[0, 1] if ignore_index is None else [ignore_index]}.")


def _binary_precision_recall_curve_format(
    preds: torch.Tensor, target: torch.Tensor, thresholds=None, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """-> (scores, int32 targets with ignored points set to 0, thresholds, int32 0/1
    weights), flat; the scores go through one batch-wide sigmoid when any lies outside
    [0, 1]."""
    preds = normalize_logits_if_needed(preds.reshape(-1), "sigmoid")
    target, w = _ignore_weights(target.reshape(-1), ignore_index)
    return preds, target.to(torch.int32), _adjust_threshold_arg(thresholds, preds.device), w


def _binary_precision_recall_curve_update(
    preds: torch.Tensor, target: torch.Tensor, thresholds: Optional[torch.Tensor], weights: Optional[torch.Tensor] = None
):
    """Exact: the (scores, targets) themselves. Binned: the int32 ``(T, 2, 2)`` confusion."""
    if thresholds is None:
        return preds, target
    keep = torch.ones_like(target, dtype=torch.bool) if weights is None else weights != 0
    return _binned_counts(preds[:, None], (target == 1)[:, None], keep[:, None], thresholds)[:, 0]


def _binary_precision_recall_curve_compute(state, thresholds: Optional[torch.Tensor], pos_label: int = 1) -> Curve:
    """-> (precision, recall, thresholds); precision and recall end in the point (1, 0)."""
    if not isinstance(state, tuple) and thresholds is not None:
        precision, recall = _binned_pr(state)
        return precision, recall, thresholds
    preds, positive, all_negative = _binary_exact_rows(state[0], state[1], pos_label)
    (precision,), (recall,), (thresholds,) = _exact_pr_compute(preds, positive, all_negative)
    return precision, recall, thresholds


def _filter_ignored(preds: torch.Tensor, target: torch.Tensor, weights: torch.Tensor):
    """The exact path's ignored rows, dropped (reads the mask back to the host)."""
    keep = weights != 0
    return preds[keep], target[keep]


def binary_precision_recall_curve(
    preds, target, thresholds=None, ignore_index: Optional[int] = None, validate_args: bool = True
) -> Curve:
    """Binary precision-recall curve.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_precision_recall_curve
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_precision_recall_curve(preds, target, thresholds=5)
        (tensor([0.5000, 0.7500, 1.0000, 1.0000,    nan, 1.0000]), tensor([1.0000, 1.0000, 1.0000, 0.6667, 0.0000, 0.0000]), tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000]))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds, w = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, w)
    return _binary_precision_recall_curve_compute(state, thresholds)


# -------------------------------------------------------------- multiclass


def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int, thresholds=None, ignore_index: Optional[int] = None, average: Optional[str] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if average not in (None, "micro", "macro"):
        raise ValueError(f"Expected argument `average` to be one of None, 'micro' or 'macro', but got {average}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim != target.ndim + 1:
        raise ValueError("Expected `preds` to have one more dimension than `target` but got"
                         f" {preds.ndim} and {target.ndim}")
    if not preds.is_floating_point():
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to be equal to the number of classes"
                         f" {num_classes}")
    if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
        raise ValueError("Expected the shape of `preds` should be (N, C, ...) and the shape of `target` should be"
                         " (N, ...).")
    t = target[target != ignore_index] if ignore_index is not None else target
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= num_classes):
        raise RuntimeError("Detected more unique values in `target` than expected.")


def _multiclass_precision_recall_curve_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    thresholds=None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
):
    """-> (``(M, C)`` scores after one batch-wide softmax when needed, int32 targets
    clipped to the classes, thresholds, int32 0/1 weights). ``average="micro"`` flattens
    to one binary problem over every (sample, class) pair."""
    n, c = preds.shape[0], preds.shape[1]
    preds = normalize_logits_if_needed(preds.reshape(n, c, -1).movedim(1, -1).reshape(-1, c), "softmax")
    target, w = _ignore_weights(target.reshape(-1), ignore_index)
    target = target.clamp(0, num_classes - 1).to(torch.int32)
    if average == "micro":
        one_hot = target[:, None] == torch.arange(num_classes, device=target.device)
        preds, target, w = preds.reshape(-1), one_hot.reshape(-1).to(torch.int32), w[:, None].expand(-1, c).reshape(-1)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device), w


def _multiclass_precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    thresholds: Optional[torch.Tensor],
    weights: Optional[torch.Tensor] = None,
    average: Optional[str] = None,
):
    """Exact: the (scores, targets). Binned: int32 ``(T, C, 2, 2)`` (``(T, 2, 2)`` for micro)."""
    if thresholds is None:
        return preds, target
    if average == "micro":
        return _binary_precision_recall_curve_update(preds, target, thresholds, weights)
    positive = target[:, None] == torch.arange(num_classes, device=target.device)
    keep = torch.ones_like(positive) if weights is None else (weights != 0)[:, None].expand_as(positive)
    return _binned_counts(preds, positive, keep, thresholds)


def _multiclass_precision_recall_curve_compute(
    state, num_classes: int, thresholds: Optional[torch.Tensor], average: Optional[str] = None
):
    """Binned: ``(C, T + 1)`` precision and recall and the thresholds. Exact: a list per
    class, one-vs-rest."""
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)
    if not isinstance(state, tuple) and thresholds is not None:
        precision, recall = _binned_pr(state)
        return precision.T, recall.T, thresholds
    return _exact_pr_compute(*_multiclass_exact_rows(state[0], state[1], num_classes))


def multiclass_precision_recall_curve(
    preds,
    target,
    num_classes: int,
    thresholds=None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Multiclass precision-recall curves, one-vs-rest.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_precision_recall_curve
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> precision, recall, thresholds = multiclass_precision_recall_curve(preds, target, num_classes=3, thresholds=5)
        >>> precision
        tensor([[0.2500, 0.5000, 1.0000, 1.0000,    nan, 1.0000],
                [0.5000, 0.6667, 1.0000, 1.0000,    nan, 1.0000],
                [0.2500, 0.5000, 1.0000,    nan,    nan, 1.0000]])
        >>> recall
        tensor([[1.0000, 1.0000, 1.0000, 1.0000, 0.0000, 0.0000],
                [1.0000, 1.0000, 0.5000, 0.5000, 0.0000, 0.0000],
                [1.0000, 1.0000, 1.0000, 0.0000, 0.0000, 0.0000]])
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds, w = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    if thresholds is None and ignore_index is not None:
        preds, target = _filter_ignored(preds, target, w)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, w, average)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds, average)


# -------------------------------------------------------------- multilabel


def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int, thresholds=None, ignore_index: Optional[int] = None
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError("Expected `preds` to be a float tensor")
    if preds.shape[1] != num_labels:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to equal `num_labels={num_labels}`")


def _multilabel_precision_recall_curve_format(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, thresholds=None, ignore_index: Optional[int] = None
):
    """-> (``(M, C)`` scores after one batch-wide sigmoid when needed, int32 ``(M, C)``
    targets, thresholds, int32 0/1 weights). The binned path sets ignored targets to 0;
    the exact path keeps the ``ignore_index`` markers, which its compute drops label by
    label."""
    n, c = preds.shape[0], preds.shape[1]
    preds = normalize_logits_if_needed(preds.reshape(n, c, -1).movedim(1, -1).reshape(-1, c), "sigmoid")
    target = target.reshape(n, c, -1).movedim(1, -1).reshape(-1, c)
    masked, w = _ignore_weights(target, ignore_index)
    if thresholds is not None:
        target = masked
    return preds, target.to(torch.int32), _adjust_threshold_arg(thresholds, preds.device), w


def _multilabel_precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    thresholds: Optional[torch.Tensor],
    weights: Optional[torch.Tensor] = None,
):
    """Exact: the (scores, targets). Binned: int32 ``(T, C, 2, 2)``."""
    if thresholds is None:
        return preds, target
    keep = torch.ones_like(target, dtype=torch.bool) if weights is None else weights != 0
    return _binned_counts(preds, target == 1, keep, thresholds)


def _multilabel_precision_recall_curve_compute(
    state, num_labels: int, thresholds: Optional[torch.Tensor], ignore_index: Optional[int] = None
):
    if not isinstance(state, tuple) and thresholds is not None:
        return _multiclass_precision_recall_curve_compute(state, num_labels, thresholds, None)
    return _exact_pr_compute(*_multilabel_exact_rows(state[0], state[1], ignore_index))


def multilabel_precision_recall_curve(
    preds, target, num_labels: int, thresholds=None, ignore_index: Optional[int] = None, validate_args: bool = True
):
    """Multilabel precision-recall curves, one per label.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_precision_recall_curve
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> precision, recall, thresholds = multilabel_precision_recall_curve(preds, target, num_labels=3)
        >>> precision[0], recall[0], thresholds[0]
        (tensor([0.3333, 0.5000, 1.0000, 1.0000]), tensor([1., 1., 1., 0.]), tensor([0.0500, 0.4500, 0.7500]))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds, w = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, w)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)


def precision_recall_curve(
    preds,
    target,
    task: str,
    thresholds=None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Curve, CurveLists]:
    """Task dispatch over the three precision-recall curves.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import precision_recall_curve
        >>> precision_recall_curve(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1]), task="binary")
        (tensor([0.6667, 1.0000, 1.0000, 1.0000]), tensor([1.0000, 1.0000, 0.5000, 0.0000]), tensor([0.2000, 0.6000, 0.8000]))
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_precision_recall_curve(preds, target, num_classes, thresholds, average, ignore_index,
                                                 validate_args)
    return multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args)
