"""True/false positive/negative sufficient statistics, multiclass (counterpart of
``torchmetrics_tpu/functional/classification/stat_scores.py``; binary and multilabel
are not ported yet).

As in the JAX package, ``ignore_index`` is a zero weight per element instead of boolean
indexing, so every shape is static, and the per-class stats are one-hot products
reduced over samples. All counts are int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.data import _one_hot, select_topk


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
    target2 = target.reshape(n, -1)
    if ignore_index is not None:
        w = (target2 != ignore_index).to(torch.int32)
        target2 = torch.where(w == 1, target2, torch.zeros_like(target2))
    else:
        w = torch.ones(target2.shape, dtype=torch.int32, device=target.device)
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class int32 stats via one-hot products: global -> ``(C,)``, samplewise -> ``(N, C)``."""
    t_oh = _one_hot(target, num_classes)  # (N, S, C)
    w = weights[..., None]
    dims = (0, 1) if multidim_average == "global" else (1,)

    def count(x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=dims).to(torch.int32)

    tp = count(w * preds_oh * t_oh)
    fp = count(w * preds_oh * (1 - t_oh))
    fn = count(w * (1 - preds_oh) * t_oh)
    tn = count(w * (1 - preds_oh) * (1 - t_oh))
    return tp, fp, tn, fn


def _multiclass_stat_scores_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> torch.Tensor:
    """Average over the class axis: micro sums, macro means in float, weighted uses
    support weights, none keeps the (..., C, 5) table."""
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
