"""True/false positive/negative sufficient statistics: the core of the accuracy,
precision, recall, F-beta, specificity, NPV and hamming family (counterpart of
``torchmetrics_tpu/functional/classification/stat_scores.py``).

As in the JAX package, ``ignore_index`` is a zero weight per element instead of boolean
indexing, so every shape is static; binary and multilabel inputs are 0/1 tensors and
multiclass inputs one-hot masks, reduced over samples. All counts are int32. With
``validate_args=False`` nothing here waits for the device; the ``*_tensor_validation``
functions read values back to the host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import normalize_logits_if_needed
from ...utilities.data import _one_hot, select_topk
from ...utilities.enums import ClassificationTask

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _ignore_weights(target: torch.Tensor, ignore_index: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (target with ignored points set to 0, int32 0/1 weights of the same shape)."""
    if ignore_index is None:
        return target, torch.ones(target.shape, dtype=torch.int32, device=target.device)
    keep = target != ignore_index
    return torch.where(keep, target, 0), keep.to(torch.int32)


def _counts(preds: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, dims: Sequence[int]) -> Counts:
    """int32 (tp, fp, tn, fn) of 0/1 ``preds`` against 0/1 ``target`` under 0/1
    ``weights``, summed over ``dims``: three sums of products, the rest by difference,
    which is exact in integers."""
    weighted_preds = weights * preds
    tp = (weighted_preds * target).sum(dims)
    fp = weighted_preds.sum(dims) - tp
    fn = (weights * target).sum(dims) - tp
    tn = weights.sum(dims) - tp - fp - fn
    return tuple(x.to(torch.int32) for x in (tp, fp, tn, fn))


def _check_zero_one(x: torch.Tensor, name: str, ignore_index: Optional[int] = None) -> None:
    """Raise unless every value of ``x`` is 0, 1 or ``ignore_index`` (reads ``x`` back)."""
    ok = (x == 0) | (x == 1)
    if ignore_index is not None:
        ok |= x == ignore_index
    if not bool(ok.all()):
        allowed = [0, 1] if ignore_index is None else [0, 1, ignore_index]
        raise RuntimeError(
            f"Detected the following values in `{name}`: {torch.unique(x).tolist()} but expected only"
            f" the following values {allowed}."
        )


def _check_args(
    multidim_average: str, ignore_index: Optional[int], zero_division: float,
    threshold: Optional[float] = None, average: Optional[str] = "macro",
) -> None:
    """The argument checks that the three tasks share."""
    if threshold is not None and not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if zero_division not in (0, 0.0, 1, 1.0):
        raise ValueError(f"Expected argument `zero_division` to be 0 or 1, but got {zero_division}.")


# --------------------------------------------------------------------- binary


def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    zero_division: float = 0,
) -> None:
    _check_args(multidim_average, ignore_index, zero_division, threshold=threshold)


def _binary_stat_scores_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")
    _check_zero_one(target, "target", ignore_index)
    if not preds.is_floating_point():
        _check_zero_one(preds, "preds")


def _binary_stat_scores_format(
    preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (preds 0/1, target 0/1, weights), all int32 ``(N, S)``; ignored points get
    weight 0. Float preds go through one batch-wide sigmoid when any lies outside
    [0, 1], then count as positive where strictly above ``threshold``."""
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid") > threshold
    preds = preds.reshape(preds.shape[0], -1).to(torch.int32)
    target, w = _ignore_weights(target.reshape(target.shape[0], -1), ignore_index)
    return preds, target.to(torch.int32), w


def _binary_stat_scores_update(
    preds: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, multidim_average: str = "global"
) -> Counts:
    """Global -> 0-d counts; samplewise -> ``(N,)``."""
    return _counts(preds, target, weights, (0, 1) if multidim_average == "global" else (1,))


def _binary_stat_scores_compute(
    tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor, multidim_average: str = "global"
) -> torch.Tensor:
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=-1).squeeze()


def binary_stat_scores(
    preds,
    target,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """tp/fp/tn/fn/support for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_stat_scores
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_stat_scores(preds, target)
        tensor([3, 0, 3, 0, 3], dtype=torch.int32)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, w = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, w, multidim_average)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# ------------------------------------------------------------------ multiclass


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    zero_division: float = 0,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not isinstance(top_k, int) or top_k < 1:
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    _check_args(multidim_average, ignore_index, zero_division, average=average)


def _multiclass_stat_scores_tensor_validation(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    """Shape checks, then value checks (these read the tensors back to the host)."""
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
        if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError("The `preds` and `target` should have the same shape,"
                             f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}.")
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError("when `preds` and `target` have the same shape, they should be at least 2D when"
                             " `multidim_average` is set to `samplewise`")
    else:
        raise ValueError("Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be"
                         " (N, ...) and `preds` should be (N, C, ...).")
    t = target[target != ignore_index] if ignore_index is not None else target
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= num_classes):
        raise RuntimeError(f"Detected more unique values in `target` than expected: values outside"
                           f" [0, {num_classes - 1}] found.")
    if preds.ndim == target.ndim and not preds.is_floating_point():
        if preds.numel() and (int(preds.min()) < 0 or int(preds.max()) >= num_classes):
            raise RuntimeError("Detected more unique values in `preds` than expected.")


def _multiclass_stat_scores_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    top_k: int = 1,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (preds_onehot ``(N, S, C)``, target labels ``(N, S)`` with ignored points
    remapped to 0, 0/1 weights ``(N, S)``), all int32."""
    n = target.shape[0]
    target2, w = _ignore_weights(target.reshape(n, -1), ignore_index)
    # clip stray labels (validated when validate_args) so the one-hot stays total
    target2 = target2.clamp(0, num_classes - 1).to(torch.int32)
    if preds.ndim == target.ndim + 1:  # (N, C, ...) float scores
        scores = preds.reshape(n, preds.shape[1], -1).movedim(1, -1)  # (N, S, C)
        if top_k > 1:
            # each sample predicts exactly ONE class: the target when it sits in the
            # top-k, else the top-1 (reference _refine_preds_oh)
            topk_oh = select_topk(scores, top_k, dim=-1)
            in_topk = torch.gather(topk_oh, -1, target2[..., None].long())[..., 0] > 0
            refined = torch.where(in_topk, target2, scores.argmax(dim=-1).to(torch.int32))
            oh = _one_hot(refined, num_classes)
        else:
            oh = select_topk(scores, 1, dim=-1)
    else:  # (N, ...) int labels
        oh = _one_hot(preds.reshape(n, -1), num_classes)
    return oh, target2, w


def _multiclass_stat_scores_update(
    preds_oh: torch.Tensor,
    target: torch.Tensor,
    weights: torch.Tensor,
    num_classes: int,
    multidim_average: str = "global",
) -> Counts:
    """Per-class int32 stats via one-hot products: global -> ``(C,)``, samplewise -> ``(N, C)``."""
    dims = (0, 1) if multidim_average == "global" else (1,)
    return _counts(preds_oh, _one_hot(target, num_classes), weights[..., None], dims)


def _multiclass_stat_scores_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> torch.Tensor:
    """Average over the class axis: micro sums, macro means in float, weighted uses
    support weights (normalised per sample on the samplewise path), none keeps the
    (..., C, 5) table."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_dim = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(sum_dim).to(torch.int32) if res.ndim > 1 else res
    if average == "macro":
        return res.float().mean(sum_dim)
    if average == "weighted":
        weight = tp + fn
        if multidim_average == "global":
            norm = weight / weight.sum()
        else:
            norm = weight / weight.sum(-1, keepdim=True)
        return (res * norm.reshape(*weight.shape, 1)).sum(sum_dim)
    return res


def multiclass_stat_scores(
    preds,
    target,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """tp/fp/tn/fn/support for multiclass tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_stat_scores
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_stat_scores(preds, target, num_classes=3)
        tensor([1.3333, 0.0000, 2.6667, 0.0000, 1.3333])
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds_oh, target, w = _multiclass_stat_scores_format(preds, target, num_classes, top_k, ignore_index)
    tp, fp, tn, fn = _multiclass_stat_scores_update(preds_oh, target, w, num_classes, multidim_average)
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ------------------------------------------------------------------ multilabel


def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    zero_division: float = 0,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _check_args(multidim_average, ignore_index, zero_division, threshold=threshold, average=average)


def _multilabel_stat_scores_tensor_validation(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(f"Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
                         f" but got {preds.shape[1]} and expected {num_labels}")
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")
    _check_zero_one(target, "target", ignore_index)
    if not preds.is_floating_point():
        _check_zero_one(preds, "preds")


def _multilabel_stat_scores_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (preds 0/1, target 0/1, weights), all int32 ``(N, C, S)``; float preds as in
    the binary task (one batch-wide sigmoid when needed, strict threshold)."""
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid") > threshold
    n, c = preds.shape[0], preds.shape[1]
    preds = preds.reshape(n, c, -1).to(torch.int32)
    target, w = _ignore_weights(target.reshape(n, c, -1), ignore_index)
    return preds, target.to(torch.int32), w


def _multilabel_stat_scores_update(
    preds: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, multidim_average: str = "global"
) -> Counts:
    """Per-label counts: global -> ``(C,)``, samplewise -> ``(N, C)``."""
    return _counts(preds, target, weights, (0, 2) if multidim_average == "global" else (2,))


def _multilabel_stat_scores_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> torch.Tensor:
    """As the multiclass reduction, except that ``weighted`` normalises by the GLOBAL
    support sum even on the samplewise path: the JAX package keeps this asymmetry of
    its reference on purpose, and so does the port."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_dim = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(sum_dim).to(torch.int32)
    if average == "macro":
        return res.float().mean(sum_dim)
    if average == "weighted":
        weight = tp + fn
        return (res * (weight / weight.sum()).reshape(*weight.shape, 1)).sum(sum_dim)
    return res


def multilabel_stat_scores(
    preds,
    target,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """tp/fp/tn/fn/support for multilabel tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multilabel_stat_scores
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_stat_scores(preds, target, num_labels=3)
        tensor([1.0000, 0.3333, 1.3333, 0.3333, 1.3333])
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, w = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, w, multidim_average)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ------------------------------------------------------------------- dispatch


def _check_task_args(task: ClassificationTask, num_classes=None, num_labels=None, top_k=1) -> None:
    """The integer arguments a task needs, as the task facades check them."""
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
    if task == ClassificationTask.MULTILABEL and not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")


def stat_scores(
    preds,
    target,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: Optional[str] = "global",
    top_k: Optional[int] = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch over ``binary_/multiclass_/multilabel_stat_scores``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import stat_scores
        >>> stat_scores(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 0]), task="binary")
        tensor([1, 1, 1, 0, 1], dtype=torch.int32)
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels, top_k)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    return multilabel_stat_scores(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
