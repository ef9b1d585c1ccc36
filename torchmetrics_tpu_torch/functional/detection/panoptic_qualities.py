"""Panoptic quality and modified panoptic quality (counterpart of
``torchmetrics_tpu/functional/detection/panoptic_qualities.py``).

The per-image statistics are the JAX package's host numpy algorithm, in the port's own
copy: segment colours ``(category_id, instance_id)`` are encoded as int64 codes, their
areas and pairwise intersections come from ``np.unique`` with counts, and the matches,
false positives and false negatives are boolean masks over the table of unique
(pred, target) colour pairs, folded per category by ``np.add.at`` into float64 IoU sums
and int64 counts. The same inputs give the same sums as the JAX package's, bit for bit.
The per-class and averaged qualities are computed in float32 torch ops on the device of
the sums; the means over the classes add in float64 and round once.
"""
from __future__ import annotations

from typing import Any, Collection, Dict, Optional, Set, Tuple

import numpy as np
import torch

from ...utilities.checks import resolve_device
from ...utilities.prints import rank_zero_warn

_SHIFT = np.int64(1) << np.int64(32)


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    things_parsed = set(things)
    if len(things_parsed) < len(things):
        rank_zero_warn("The provided `things` categories contained duplicates, which have been removed.", UserWarning)
    stuffs_parsed = set(stuffs)
    if len(stuffs_parsed) < len(stuffs):
        rank_zero_warn("The provided `stuffs` categories contained duplicates, which have been removed.", UserWarning)
    if not all(isinstance(val, int) and not isinstance(val, bool) for val in things_parsed):
        raise TypeError(f"Expected argument `things` to contain `int` categories, but got {things}")
    if not all(isinstance(val, int) and not isinstance(val, bool) for val in stuffs_parsed):
        raise TypeError(f"Expected argument `stuffs` to contain `int` categories, but got {stuffs}")
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    if not (things_parsed | stuffs_parsed):
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    return things_parsed, stuffs_parsed


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    return 1 + max([0, *list(things), *list(stuffs)]), 0


def _get_category_id_to_continuous_id(things: Set[int], stuffs: Set[int]) -> Dict[int, int]:
    thing_map = {thing_id: idx for idx, thing_id in enumerate(sorted(things))}
    stuff_map = {stuff_id: idx + len(things) for idx, stuff_id in enumerate(sorted(stuffs))}
    return {**thing_map, **stuff_map}


def _validate_inputs(preds: Any, target: Any) -> None:
    if not hasattr(preds, "shape"):
        raise TypeError(f"Expected argument `preds` to be an array, but got {type(preds)}")
    if not hasattr(target, "shape"):
        raise TypeError(f"Expected argument `target` to be an array, but got {type(target)}")
    if tuple(preds.shape) != tuple(target.shape):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same shape, but got {preds.shape} and {target.shape}"
        )
    if preds.ndim < 3:
        raise ValueError(
            f"Expected argument `preds` to have at least one spatial dimension (B, *spatial_dims, 2), got {preds.shape}"
        )
    if preds.shape[-1] != 2:
        raise ValueError(
            "Expected argument `preds` to have exactly 2 channels in the last dimension (category, instance), "
            f"got {preds.shape} instead"
        )


def _host(x: Any) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _preprocess_inputs(
    things: Set[int],
    stuffs: Set[int],
    inputs: Any,
    void_color: Tuple[int, int],
    allow_unknown_category: bool,
) -> np.ndarray:
    """Flatten the spatial dims, zero the stuff instance ids, map unknown categories to void."""
    inputs = _host(inputs)
    arr = inputs.astype(np.int64).reshape(inputs.shape[0], -1, 2)  # astype copies
    cats = arr[..., 0]
    mask_stuffs = np.isin(cats, list(stuffs))
    mask_things = np.isin(cats, list(things))
    arr[..., 1] = np.where(mask_stuffs, 0, arr[..., 1])
    unknown = ~(mask_things | mask_stuffs)
    if not allow_unknown_category and unknown.any():
        raise ValueError(f"Unknown categories found: {np.unique(cats[unknown])}")
    arr[unknown] = np.asarray(void_color, np.int64)
    return arr


def _encode(colors: np.ndarray) -> np.ndarray:
    """(N, 2) colours -> int64 codes (the category in the high 32 bits)."""
    return colors[..., 0] * _SHIFT + colors[..., 1]


def _panoptic_quality_update_sample(
    pred_s: np.ndarray,
    target_s: np.ndarray,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    stuffs_modified_metric: Optional[Set[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One image's statistics per category: (iou_sum, tp, fp, fn)."""
    modified = stuffs_modified_metric or set()
    num_categories = len(cat_id_to_continuous_id)
    iou_sum = np.zeros(num_categories, np.float64)
    tp = np.zeros(num_categories, np.int64)
    fp = np.zeros(num_categories, np.int64)
    fn = np.zeros(num_categories, np.int64)
    cont_of = np.vectorize(cat_id_to_continuous_id.__getitem__, otypes=[np.int64])

    # instance ids are any ints (negative sentinels too): renumber them jointly to a
    # dense non-negative range, so the (category << 32 | instance) code cannot shift
    # into a neighbouring category
    all_inst = np.concatenate([pred_s[:, 1], target_s[:, 1], np.asarray([void_color[1]], np.int64)])
    inst_values = np.unique(all_inst)
    pred_s = np.stack([pred_s[:, 0], np.searchsorted(inst_values, pred_s[:, 1])], axis=1)
    target_s = np.stack([target_s[:, 0], np.searchsorted(inst_values, target_s[:, 1])], axis=1)
    void_inst = int(np.searchsorted(inst_values, void_color[1]))

    pc = _encode(pred_s)
    tc = _encode(target_s)
    void = int(void_color[0]) * int(_SHIFT) + void_inst

    # the colours and (pred, target) colour pairs in code order, with their areas
    up, p_areas = np.unique(pc, return_counts=True)
    ut, t_areas = np.unique(tc, return_counts=True)
    upair, i_areas = np.unique(np.stack([pc, tc], axis=1), axis=0, return_counts=True)
    p_of, t_of = upair[:, 0], upair[:, 1]

    # each colour's overlap with void, aligned to up and ut
    pred_void = np.zeros(up.shape[0], np.int64)
    mask_pv = t_of == void
    pred_void[np.searchsorted(up, p_of[mask_pv])] = i_areas[mask_pv]
    void_target = np.zeros(ut.shape[0], np.int64)
    mask_vt = p_of == void
    void_target[np.searchsorted(ut, t_of[mask_vt])] = i_areas[mask_vt]

    area_p = p_areas[np.searchsorted(up, p_of)]
    area_t = t_areas[np.searchsorted(ut, t_of)]
    pv_of = pred_void[np.searchsorted(up, p_of)]
    vt_of = void_target[np.searchsorted(ut, t_of)]

    cat_p = (p_of >> np.int64(32)).astype(np.int64)
    cat_t = (t_of >> np.int64(32)).astype(np.int64)
    cand = (t_of != void) & (cat_p == cat_t)  # the void prediction's category is in no map
    union = area_p - pv_of + area_t - vt_of - i_areas
    iou = np.where(cand & (union > 0), i_areas / np.where(union > 0, union, 1), 0.0)

    is_modified = np.isin(cat_t, list(modified)) if modified else np.zeros_like(cand)
    matched = cand & ~is_modified & (iou > 0.5)
    mod_hit = cand & is_modified & (iou > 0)
    for mask in (matched, mod_hit):
        if mask.any():
            np.add.at(iou_sum, cont_of(cat_t[mask]), iou[mask])
    if matched.any():
        np.add.at(tp, cont_of(cat_t[matched]), 1)

    matched_p = p_of[matched]
    matched_t = t_of[matched]

    # false negatives: unmatched target segments not mostly void in the prediction
    t_unmatched = (ut != void) & ~np.isin(ut, matched_t)
    t_keep = t_unmatched & (void_target / t_areas <= 0.5)
    cat_fn = (ut[t_keep] >> np.int64(32)).astype(np.int64)
    cat_fn = cat_fn[~np.isin(cat_fn, list(modified))] if modified else cat_fn
    if cat_fn.size:
        np.add.at(fn, cont_of(cat_fn), 1)

    # false positives: unmatched predicted segments not mostly void in the target
    p_unmatched = (up != void) & ~np.isin(up, matched_p)
    p_keep = p_unmatched & (pred_void / p_areas <= 0.5)
    cat_fp = (up[p_keep] >> np.int64(32)).astype(np.int64)
    cat_fp = cat_fp[~np.isin(cat_fp, list(modified))] if modified else cat_fp
    if cat_fp.size:
        np.add.at(fp, cont_of(cat_fp), 1)

    # modified PQ's stuffs: "tp" counts the target segments of that category
    if modified:
        cat_ut = (ut[ut != void] >> np.int64(32)).astype(np.int64)
        cat_mod = cat_ut[np.isin(cat_ut, list(modified))]
        if cat_mod.size:
            np.add.at(tp, cont_of(cat_mod), 1)

    return iou_sum, tp, fp, fn


def _panoptic_quality_update(
    flatten_preds: np.ndarray,
    flatten_target: np.ndarray,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A batch's statistics; segments are never matched across images."""
    num_categories = len(cat_id_to_continuous_id)
    iou_sum = np.zeros(num_categories, np.float64)
    tp = np.zeros(num_categories, np.int64)
    fp = np.zeros(num_categories, np.int64)
    fn = np.zeros(num_categories, np.int64)
    for pred_s, target_s in zip(flatten_preds, flatten_target):
        r = _panoptic_quality_update_sample(
            pred_s, target_s, cat_id_to_continuous_id, void_color, stuffs_modified_metric=modified_metric_stuffs
        )
        iou_sum += r[0]
        tp += r[1]
        fp += r[2]
        fn += r[3]
    return iou_sum, tp, fp, fn


def _panoptic_quality_compute(
    iou_sum: torch.Tensor,
    true_positives: torch.Tensor,
    false_positives: torch.Tensor,
    false_negatives: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Per-class (pq, sq, rq) and their means over the classes seen, in float32."""
    tp = true_positives.to(torch.float32)
    iou_sum = iou_sum.to(torch.float32)
    one = torch.ones_like(tp)
    sq = torch.where(tp > 0, iou_sum / torch.where(tp > 0, tp, one), torch.zeros_like(tp))
    denominator = tp + 0.5 * false_positives.to(torch.float32) + 0.5 * false_negatives.to(torch.float32)
    rq = torch.where(denominator > 0, tp / torch.where(denominator > 0, denominator, one), torch.zeros_like(tp))
    pq = sq * rq
    seen = denominator > 0
    n_seen = seen.sum()
    safe = torch.where(n_seen > 0, n_seen, torch.ones_like(n_seen)).to(torch.float32)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=tp.device)

    def seen_mean(x: torch.Tensor) -> torch.Tensor:
        # float32 qualities in [0, 1] add exactly in float64, so in any order: one
        # rounding gives the same bits on every device
        total = torch.where(seen, x, torch.zeros_like(x)).to(torch.float64).sum().to(torch.float32)
        return torch.where(n_seen > 0, total / safe, nan)

    return pq, sq, rq, seen_mean(pq), seen_mean(sq), seen_mean(rq)


def _statistics(preds: Any, target: Any, things: Collection[int], stuffs: Collection[int],
                allow_unknown_preds_category: bool, modified: bool) -> Tuple[torch.Tensor, ...]:
    things, stuffs = _parse_categories(things, stuffs)
    _validate_inputs(preds, target)
    void_color = _get_void_color(things, stuffs)
    cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
    flatten_preds = _preprocess_inputs(things, stuffs, preds, void_color, allow_unknown_preds_category)
    flatten_target = _preprocess_inputs(things, stuffs, target, void_color, True)
    sums = _panoptic_quality_update(flatten_preds, flatten_target, cat_id_to_continuous_id, void_color,
                                    modified_metric_stuffs=stuffs if modified else None)
    # the result lies where the input did: a tensor's device, else the default (CUDA)
    device = preds.device if isinstance(preds, torch.Tensor) else resolve_device(None)
    return _panoptic_quality_compute(*(torch.as_tensor(s, device=device) for s in sums))


def panoptic_quality(
    preds: Any,
    target: Any,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    return_sq_and_rq: bool = False,
    return_per_class: bool = False,
) -> torch.Tensor:
    """Panoptic quality of panoptic segmentations: ``(B, *spatial_dims, 2)`` integer
    inputs of ``(category_id, instance_id)`` pairs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import panoptic_quality
        >>> preds = torch.tensor([[[[6, 0], [0, 0], [6, 0], [6, 0]], [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]], [[0, 0], [7, 0], [6, 0], [1, 0]]]])
        >>> target = torch.tensor([[[[6, 0], [0, 1], [6, 0], [0, 1]], [[0, 1], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [1, 0]], [[0, 1], [7, 0], [1, 0], [1, 0]]]])
        >>> panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})
        tensor(0.5417)
    """
    pq, sq, rq, pq_avg, sq_avg, rq_avg = _statistics(preds, target, things, stuffs, allow_unknown_preds_category,
                                                     modified=False)
    if return_per_class:
        if return_sq_and_rq:
            return torch.stack([pq, sq, rq], dim=-1)
        return pq.reshape(1, -1)
    if return_sq_and_rq:
        return torch.stack([pq_avg, sq_avg, rq_avg])
    return pq_avg


def modified_panoptic_quality(
    preds: Any,
    target: Any,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> torch.Tensor:
    """Modified panoptic quality: stuff classes scored by the relaxed rule (IoU above 0,
    one true positive per target segment).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import modified_panoptic_quality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> modified_panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})
        tensor(0.7667)
    """
    return _statistics(preds, target, things, stuffs, allow_unknown_preds_category, modified=True)[3]
