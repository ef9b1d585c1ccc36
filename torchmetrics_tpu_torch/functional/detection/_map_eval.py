"""COCO mAP evaluation on the host, with the greedy matcher on the metric's device
(counterpart of ``torchmetrics_tpu/functional/detection/_map_eval.py``).

The COCOeval algorithm in four steps, as in the JAX package:

1. vectorized row building: every (class, image) cell becomes one row of a padded
   ``(rows, dmax)`` / ``(rows, gmax)`` batch through one lexsort over the flat state,
2. pairwise IoU of a row block in one broadcast, in float64 on the host (pycocotools'
   dtype; pixel products per cell for segm), with the threshold eligibility resolved
   there too,
3. a batched greedy matcher: a loop over score-sorted detection slots whose body is
   plain broadcasting over ``rows x areas x thresholds x gts``, in torch ops on the
   matcher's device,
4. numpy accumulation: global stable score sort, cumsum TP/FP, precision envelope,
   101-point interpolation by ``searchsorted``.

Steps 1, 2 and 4 are the JAX package's numpy, copied; they carry pycocotools' float64
semantics, including the crowd/ignore and tie-breaking rules (last ground truth wins
an equal IoU; an ignored gt is matchable only when no other gt clears the threshold).
The JAX package pins its matcher to the host CPU to save a TPU's transfers; here it
runs where the metric lives, the card by default, and each row block crosses once
each way.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# COCO area ranges: all / small / medium / large (reference _mean_ap.py:351-356)
_AREA_RANGES = np.array(
    [[0.0, 1e5**2], [0.0, 32.0**2], [32.0**2, 96.0**2], [96.0**2, 1e5**2]], np.float32
)
_AREA_KEYS = ("all", "small", "medium", "large")
_ROW_BLOCK = 8192  # matcher rows per block (bounds the f64 IoU staging and the device buffers)

# Default thresholds: the reference builds these with torch.linspace in FLOAT32
# (mean_ap.py:382,388) and feeds the f32-quantized values into COCOeval as f64, so
# e.g. its "0.6" IoU threshold is really 0.6000000238418579 — an exact-0.6 IoU does
# NOT clear it (the segm doctest golden, map 0.2 not 0.3, hinges on this). The exact
# values are pinned here as literals.
DEFAULT_IOU_THRESHOLDS = [
    0.5, 0.550000011920929, 0.6000000238418579, 0.6499999761581421, 0.699999988079071,
    0.75, 0.800000011920929, 0.8500000238418579, 0.8999999761581421, 0.949999988079071,
]
DEFAULT_REC_THRESHOLDS = [
    0.0, 0.009999999776482582, 0.019999999552965164, 0.029999999329447746, 0.03999999910593033,
    0.04999999701976776, 0.05999999865889549, 0.07000000029802322, 0.07999999821186066, 0.08999999612569809,
    0.09999999403953552, 0.10999999940395355, 0.11999999731779099, 0.12999999523162842, 0.14000000059604645,
    0.14999999105930328, 0.1599999964237213, 0.17000000178813934, 0.17999999225139618, 0.1899999976158142,
    0.19999998807907104, 0.20999999344348907, 0.2199999988079071, 0.22999998927116394, 0.23999999463558197,
    0.25, 0.25999999046325684, 0.26999998092651367, 0.2800000011920929, 0.28999999165534973,
    0.29999998211860657, 0.3100000023841858, 0.3199999928474426, 0.32999998331069946, 0.3400000035762787,
    0.3499999940395355, 0.35999998450279236, 0.3700000047683716, 0.3799999952316284, 0.38999998569488525,
    0.3999999761581421, 0.4099999964237213, 0.41999998688697815, 0.429999977350235, 0.4399999976158142,
    0.44999998807907104, 0.4599999785423279, 0.4699999988079071, 0.47999998927116394, 0.4899999797344208,
    0.5, 0.5099999904632568, 0.5199999809265137, 0.5300000309944153, 0.5400000214576721,
    0.550000011920929, 0.5600000023841858, 0.5699999928474426, 0.5799999833106995, 0.5900000333786011,
    0.6000000238418579, 0.6100000143051147, 0.6200000047683716, 0.6299999952316284, 0.6399999856948853,
    0.6500000357627869, 0.6600000262260437, 0.6700000166893005, 0.6800000071525574, 0.6899999976158142,
    0.699999988079071, 0.7099999785423279, 0.7200000286102295, 0.7300000190734863, 0.7400000095367432,
    0.75, 0.7599999904632568, 0.7699999809265137, 0.7800000309944153, 0.7900000214576721,
    0.800000011920929, 0.8100000023841858, 0.8199999928474426, 0.8299999833106995, 0.8400000333786011,
    0.8500000238418579, 0.8600000143051147, 0.8700000047683716, 0.8799999952316284, 0.8899999856948853,
    0.8999999761581421, 0.9100000262260437, 0.9200000166893005, 0.9300000071525574, 0.9399999976158142,
    0.949999988079071, 0.9599999785423279, 0.9700000286102295, 0.9800000190734863, 0.9900000095367432,
    1.0,
]


def _mask_iou_np(dets: np.ndarray, gts: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """Host pairwise mask IoU for one cell (f64, pycocotools dtype): per-cell device
    calls would dominate at COCO scale, and host BLAS handles the small pixel products."""
    d = dets.reshape(dets.shape[0], -1).astype(np.float64)
    g = gts.reshape(gts.shape[0], -1).astype(np.float64)
    inter = d @ g.T
    d_area = d.sum(-1)[:, None]
    union = d_area + g.sum(-1)[None, :] - inter
    denom = np.where(crowd[None, :], d_area, union)
    return np.where(denom > 0, inter / np.where(denom > 0, denom, 1.0), 0.0)


def _box_iou_np(det: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """Host pairwise crowd-IoU for one (class, image) cell (f64, pycocotools dtype)."""
    det = det.astype(np.float64)
    gt = gt.astype(np.float64)
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    det_area = ((det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1]))[:, None]
    gt_area = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]))[None, :]
    union = det_area + gt_area - inter
    denom = np.where(crowd[None, :], det_area, union)
    return np.where(denom > 0, inter / np.where(denom > 0, denom, 1.0), 0.0).astype(np.float32)


def _bucket(n: int, floor: int = 4) -> int:
    """Round up to the next power of two, so that a few padded shapes recur."""
    b = floor
    while b < n:
        b *= 2
    return b


def _match_kernel(
    iou: torch.Tensor,  # (R, D, G) crowd-adjusted IoU, dets score-sorted per row
    clears: torch.Tensor,  # (R, D, G) int32: #sorted thresholds cleared, resolved in f64 on the host
    det_valid: torch.Tensor,  # (R, D) bool
    det_area: torch.Tensor,  # (R, D)
    gt_valid: torch.Tensor,  # (R, G) bool
    gt_area: torch.Tensor,  # (R, G)
    gt_crowd: torch.Tensor,  # (R, G) bool
    thr_idx: torch.Tensor,  # (T,) int32: rank of each threshold in ascending order
    area_ranges: torch.Tensor,  # (A, 2)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy COCO matching over rows x area ranges x IoU thresholds, one step per
    detection slot, on the device of ``iou``.

    Threshold eligibility arrives resolved as ``clears`` (``iou >= thrs[t]`` iff
    ``clears > thr_idx[t]``), so float32 rounding of ``iou`` cannot flip a boundary tie:
    ``iou`` only picks the best match, and among equal IoUs the later gt wins (the
    flip before ``argmax``, which returns the first maximum).

    Returns ``det_match (R,A,T,D)``, ``det_ignore (R,A,T,D)``, ``gt_ignore (R,A,G)``.
    """
    gt_ign = (
        (gt_area[:, None, :] < area_ranges[None, :, :1])
        | (gt_area[:, None, :] > area_ranges[None, :, 1:])
        | gt_crowd[:, None, :]
        | ~gt_valid[:, None, :]
    )  # (R, A, G)
    det_out = (det_area[:, None, :] < area_ranges[None, :, :1]) | (
        det_area[:, None, :] > area_ranges[None, :, 1:]
    )  # (R, A, D)
    num_rows, num_det, num_gt = iou.shape
    shape = (num_rows, area_ranges.shape[0], thr_idx.shape[0])
    gt_matched = torch.zeros(shape + (num_gt,), dtype=torch.bool, device=iou.device)
    dm = torch.zeros(shape + (num_det,), dtype=torch.bool, device=iou.device)
    dig = torch.zeros_like(dm)
    gt_ign_t = gt_ign[:, :, None, :]
    open_crowd = gt_crowd[:, None, None, :]
    gt_ok = gt_valid[:, None, None, :]
    slots = torch.arange(num_gt, device=iou.device)
    for d in range(num_det):
        cand = (
            gt_ok
            & (~gt_matched | open_crowd)
            & (clears[:, d, None, None, :] > thr_idx[None, None, :, None])
            & det_valid[:, d, None, None, None]
        )
        cand_nonign = cand & ~gt_ign_t
        pool = torch.where(cand_nonign.any(-1, keepdim=True), cand_nonign, cand)
        vals = torch.where(pool, iou[:, d, None, None, :], -torch.inf)
        m = num_gt - 1 - torch.argmax(vals.flip(-1), dim=-1)  # last argmax: later gt wins ties
        matched = pool.any(-1)  # (R, A, T)
        oh = (slots == m[..., None]) & matched[..., None]
        gt_matched |= oh
        dm[..., d] = matched
        dig[..., d] = (oh & gt_ign_t).any(-1)
    dig |= ~dm & det_out[:, :, None, :]  # unmatched dets outside the range: ignored
    return dm, dig, gt_ign


class MAPInputs:
    """Per-image numpy views of the flat mAP state (reconstructed from cat rows)."""

    def __init__(
        self,
        det_boxes: List[np.ndarray],
        det_scores: List[np.ndarray],
        det_labels: List[np.ndarray],
        gt_boxes: List[np.ndarray],
        gt_labels: List[np.ndarray],
        gt_crowds: List[np.ndarray],
        gt_areas: List[np.ndarray],
        det_masks: Optional[List[np.ndarray]] = None,
        gt_masks: Optional[List[np.ndarray]] = None,
    ) -> None:
        self.det_boxes = det_boxes
        self.det_scores = det_scores
        self.det_labels = det_labels
        self.gt_boxes = gt_boxes
        self.gt_labels = gt_labels
        self.gt_crowds = gt_crowds
        self.gt_areas = gt_areas
        self.det_masks = det_masks
        self.gt_masks = gt_masks
        self.num_images = len(det_scores)

    def classes(self) -> List[int]:
        parts = [x for x in self.det_labels + self.gt_labels if x.size]
        if not parts:
            return []
        return np.unique(np.concatenate(parts)).astype(int).tolist()


def _mask_areas(masks: np.ndarray) -> np.ndarray:
    # sum over every axis but the first: reshape(n, -1) raises on n == 0 (an
    # empty-image mask stack like (0, H, W) makes -1 ambiguous)
    return masks.sum(axis=tuple(range(1, masks.ndim))).astype(np.float64)


def _det_area(inputs: MAPInputs, img: int, iou_type: str) -> np.ndarray:
    if iou_type == "segm":
        return _mask_areas(inputs.det_masks[img])
    b = inputs.det_boxes[img]
    return ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).astype(np.float64)


def _gt_area(inputs: MAPInputs, img: int, iou_type: str) -> np.ndarray:
    provided = inputs.gt_areas[img].astype(np.float64)
    if iou_type == "segm":
        computed = _mask_areas(inputs.gt_masks[img])
    else:
        b = inputs.gt_boxes[img]
        computed = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).astype(np.float64)
    return np.where(provided > 0, provided, computed)


class _RowBatch:
    """Padded (class, image)-cell row arrays built in one vectorized pass."""

    __slots__ = (
        "num_rows", "dmax", "gmax", "classes", "class_slices", "row_img", "row_cls",
        "det_valid", "det_score", "det_area", "det_box", "det_src",
        "gt_valid", "gt_area", "gt_crowd", "gt_box", "gt_src",
    )


def _build_rows(
    inputs: MAPInputs, iou_type: str, max_det: int,
    det_areas_all: List[np.ndarray], gt_areas_all: List[np.ndarray],
) -> Optional[_RowBatch]:
    """Flatten every (class, image) cell into padded rows via one lexsort pass.

    Row order is class-major, image-minor, so each class owns a contiguous row
    slice; dets inside a row are score-sorted (stable) and truncated to
    ``max_det`` — exactly COCOeval's per-cell ordering.
    """
    classes = np.asarray(inputs.classes(), np.int64)
    if classes.size == 0:
        return None
    num_images = inputs.num_images
    d_sizes = np.array([x.size for x in inputs.det_labels], np.int64)
    g_sizes = np.array([x.size for x in inputs.gt_labels], np.int64)

    img_d = np.repeat(np.arange(num_images), d_sizes)
    lab_d = np.searchsorted(classes, np.concatenate(inputs.det_labels) if img_d.size else np.zeros(0, np.int64))
    score_d = np.concatenate(inputs.det_scores) if img_d.size else np.zeros(0)
    img_g = np.repeat(np.arange(num_images), g_sizes)
    lab_g = np.searchsorted(classes, np.concatenate(inputs.gt_labels) if img_g.size else np.zeros(0, np.int64))

    order_d = np.lexsort((-score_d, img_d, lab_d))
    key_d = lab_d[order_d] * num_images + img_d[order_d]
    uq_d, start_d = np.unique(key_d, return_index=True)
    cnt_d = np.diff(np.append(start_d, key_d.size))
    order_g = np.lexsort((img_g, lab_g))
    key_g = lab_g[order_g] * num_images + img_g[order_g]
    uq_g, start_g = np.unique(key_g, return_index=True)
    cnt_g = np.diff(np.append(start_g, key_g.size))

    all_keys = np.union1d(uq_d, uq_g)  # sorted: class-major, image-minor
    rb = _RowBatch()
    rb.num_rows = all_keys.size
    rb.classes = classes
    rb.row_img = (all_keys % num_images).astype(np.int64)
    rb.row_cls = (all_keys // num_images).astype(np.int64)
    lo = np.searchsorted(rb.row_cls, np.arange(classes.size), side="left")
    hi = np.searchsorted(rb.row_cls, np.arange(classes.size), side="right")
    rb.class_slices = [slice(int(a), int(b)) for a, b in zip(lo, hi)]

    # ---- dets: scatter into (rows, dmax) padding, truncating at max_det
    row_idx_d = np.repeat(np.searchsorted(all_keys, uq_d), cnt_d)
    pos_d = np.arange(key_d.size) - np.repeat(start_d, cnt_d)
    keep = pos_d < max_det
    row_idx_d, pos_d, src_d = row_idx_d[keep], pos_d[keep], order_d[keep]
    rb.dmax = _bucket(int(pos_d.max()) + 1 if pos_d.size else 1)
    rb.det_valid = np.zeros((rb.num_rows, rb.dmax), bool)
    rb.det_valid[row_idx_d, pos_d] = True
    rb.det_score = np.full((rb.num_rows, rb.dmax), -np.inf, np.float32)
    rb.det_score[row_idx_d, pos_d] = score_d[src_d]
    flat_det_area = np.concatenate(det_areas_all) if img_d.size else np.zeros(0)
    rb.det_area = np.zeros((rb.num_rows, rb.dmax), np.float32)
    rb.det_area[row_idx_d, pos_d] = flat_det_area[src_d]
    if iou_type == "bbox":
        flat_det_box = (
            np.concatenate(inputs.det_boxes).astype(np.float64).reshape(-1, 4)
            if img_d.size else np.zeros((0, 4))
        )
        rb.det_box = np.zeros((rb.num_rows, rb.dmax, 4), np.float64)
        rb.det_box[row_idx_d, pos_d] = flat_det_box[src_d]
    else:
        rb.det_box = None
    # per-row flat det source indices (pos-ordered) for segm / extended summary
    bounds_d = np.searchsorted(row_idx_d, np.arange(rb.num_rows + 1))
    rb.det_src = (src_d, bounds_d)

    # ---- gts
    row_idx_g = np.repeat(np.searchsorted(all_keys, uq_g), cnt_g)
    pos_g = np.arange(key_g.size) - np.repeat(start_g, cnt_g)
    src_g = order_g
    rb.gmax = _bucket(int(cnt_g.max()) if cnt_g.size else 1)
    rb.gt_valid = np.zeros((rb.num_rows, rb.gmax), bool)
    rb.gt_valid[row_idx_g, pos_g] = True
    flat_gt_area = np.concatenate(gt_areas_all) if img_g.size else np.zeros(0)
    rb.gt_area = np.zeros((rb.num_rows, rb.gmax), np.float32)
    rb.gt_area[row_idx_g, pos_g] = flat_gt_area[src_g]
    flat_gt_crowd = (
        np.concatenate(inputs.gt_crowds).astype(bool) if img_g.size else np.zeros(0, bool)
    )
    rb.gt_crowd = np.zeros((rb.num_rows, rb.gmax), bool)
    rb.gt_crowd[row_idx_g, pos_g] = flat_gt_crowd[src_g]
    if iou_type == "bbox":
        flat_gt_box = (
            np.concatenate(inputs.gt_boxes).astype(np.float64).reshape(-1, 4)
            if img_g.size else np.zeros((0, 4))
        )
        rb.gt_box = np.zeros((rb.num_rows, rb.gmax, 4), np.float64)
        rb.gt_box[row_idx_g, pos_g] = flat_gt_box[src_g]
    else:
        rb.gt_box = None
    bounds_g = np.searchsorted(row_idx_g, np.arange(rb.num_rows + 1))
    rb.gt_src = (src_g, bounds_g)
    return rb


def _block_iou_bbox(rb: _RowBatch, sl: slice, thrs64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pairwise crowd-adjusted IoU for a row block, f64 math (pycocotools dtype)
    broadcast in bounded sub-chunks: at COCO scale (dmax=gmax=128) a whole-block
    broadcast would stage multi-GB f64 temporaries, mostly padding.

    Returns ``(iou_f32, clears_i32)``: threshold eligibility is resolved here in
    f64 against the f64 thresholds (pycocotools comparison semantics) before the
    downcast, so f32 rounding can never flip a boundary tie."""
    n = sl.stop - sl.start
    out = np.empty((n, rb.dmax, rb.gmax), np.float32)
    clears = np.empty((n, rb.dmax, rb.gmax), np.int32)
    step = max(1, int(128 * 1024 * 1024 // max(1, rb.dmax * rb.gmax * 8 * 4)))
    for s in range(0, n, step):
        dbox = rb.det_box[sl.start + s : sl.start + min(s + step, n)]  # (C, dmax, 4)
        gbox = rb.gt_box[sl.start + s : sl.start + min(s + step, n)]  # (C, gmax, 4)
        lt = np.maximum(dbox[:, :, None, :2], gbox[:, None, :, :2])
        rbn = np.minimum(dbox[:, :, None, 2:], gbox[:, None, :, 2:])
        wh = np.clip(rbn - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        d_area = (dbox[..., 2] - dbox[..., 0]) * (dbox[..., 3] - dbox[..., 1])
        g_area = (gbox[..., 2] - gbox[..., 0]) * (gbox[..., 3] - gbox[..., 1])
        union = d_area[:, :, None] + g_area[:, None, :] - inter
        crowd = rb.gt_crowd[sl.start + s : sl.start + min(s + step, n)]
        denom = np.where(crowd[:, None, :], d_area[:, :, None], union)
        iou64 = np.where(denom > 0, inter / np.where(denom > 0, denom, 1.0), 0.0)
        out[s : s + dbox.shape[0]] = iou64
        clears[s : s + dbox.shape[0]] = np.searchsorted(thrs64, iou64.reshape(-1), side="right").reshape(iou64.shape)
    return out, clears


def _block_iou_segm(rb: _RowBatch, sl: slice, inputs: MAPInputs, thrs64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Segm IoU per cell (pixel matmul on host); cells are ragged in H,W so the
    block can't be one broadcast like bbox. Returns ``(iou_f32, clears_i32)`` with
    f64 threshold resolution like ``_block_iou_bbox``."""
    src_d, bounds_d = rb.det_src
    src_g, bounds_g = rb.gt_src
    d_sizes = np.array([x.size for x in inputs.det_labels], np.int64)
    g_sizes = np.array([x.size for x in inputs.gt_labels], np.int64)
    d_off = np.concatenate([[0], np.cumsum(d_sizes)])
    g_off = np.concatenate([[0], np.cumsum(g_sizes)])
    iou = np.zeros((sl.stop - sl.start, rb.dmax, rb.gmax), np.float32)
    clears = np.zeros((sl.stop - sl.start, rb.dmax, rb.gmax), np.int32)
    for off, r in enumerate(range(sl.start, sl.stop)):
        ds = src_d[bounds_d[r] : bounds_d[r + 1]]
        gs = src_g[bounds_g[r] : bounds_g[r + 1]]
        if ds.size == 0 or gs.size == 0:
            continue
        img = rb.row_img[r]
        d_local = ds - d_off[img]
        g_local = gs - g_off[img]
        crowd = inputs.gt_crowds[img][g_local].astype(bool)
        cell64 = _mask_iou_np(inputs.det_masks[img][d_local], inputs.gt_masks[img][g_local], crowd)
        iou[off, : ds.size, : gs.size] = cell64
        clears[off, : ds.size, : gs.size] = np.searchsorted(
            thrs64, cell64.reshape(-1), side="right"
        ).reshape(cell64.shape)
    return iou, clears


def _thresholds_by_rank(iou_thresholds: List[float]) -> Tuple[np.ndarray, np.ndarray]:
    """The clamped thresholds sorted ascending (float64) and each threshold's rank among
    them. pycocotools clamps each threshold, ``min(t, 1 - 1e-10)``, so an exact 1.0 IoU
    still clears a 1.0 threshold; ``clears`` counts against the sorted list, so
    user-supplied unsorted lists resolve correctly."""
    thrs_eff = np.minimum(np.asarray(iou_thresholds, np.float64), 1.0 - 1e-10)
    order = np.argsort(thrs_eff, kind="stable")
    ranks = np.empty(len(iou_thresholds), np.int32)
    ranks[order] = np.arange(len(iou_thresholds), dtype=np.int32)
    return thrs_eff[order], ranks


def match_rows(
    inputs: MAPInputs,
    iou_type: str,
    iou_thresholds: List[float],
    max_det: int,
    device: torch.device,
    want_ious: bool = False,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[Optional[_RowBatch], Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray], Dict]:
    """Build the rows and match them: ``(rows, det_match, det_ignore, gt_ignore, ious)``
    as host arrays ``(rows, A, T, dmax)``, ``(rows, A, T, dmax)``, ``(rows, A, gmax)``;
    all None when there is no class. The matcher runs on ``device``; ``timings``, if
    given, gains the seconds of each part (``rows``, ``iou``, ``matcher``)."""
    timings = {} if timings is None else timings
    start = time.perf_counter()
    det_areas_all = [_det_area(inputs, i, iou_type) for i in range(inputs.num_images)]
    gt_areas_all = [_gt_area(inputs, i, iou_type) for i in range(inputs.num_images)]
    rb = _build_rows(inputs, iou_type, max_det, det_areas_all, gt_areas_all)
    timings["rows"] = timings.get("rows", 0.0) + time.perf_counter() - start
    ious_out: Dict = {}
    if rb is None:
        return None, None, None, None, ious_out
    num_rows, num_a, num_t = rb.num_rows, len(_AREA_RANGES), len(iou_thresholds)
    dm_all = np.zeros((num_rows, num_a, num_t, rb.dmax), bool)
    dig_all = np.zeros_like(dm_all)
    gt_ign_all = np.zeros((num_rows, num_a, rb.gmax), bool)
    thrs64, ranks = _thresholds_by_rank(iou_thresholds)
    thr_idx = torch.as_tensor(ranks, device=device)
    area_ranges = torch.as_tensor(_AREA_RANGES, device=device)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    for block_start in range(0, num_rows, _ROW_BLOCK):
        sl = slice(block_start, min(block_start + _ROW_BLOCK, num_rows))
        start = time.perf_counter()
        iou_b, clears_b = (
            _block_iou_bbox(rb, sl, thrs64) if iou_type == "bbox" else _block_iou_segm(rb, sl, inputs, thrs64)
        )
        timings["iou"] = timings.get("iou", 0.0) + time.perf_counter() - start
        start = time.perf_counter()
        dm_b, dig_b, gt_ign_b = _match_kernel(
            on(iou_b), on(clears_b), on(rb.det_valid[sl]), on(rb.det_area[sl]), on(rb.gt_valid[sl]),
            on(rb.gt_area[sl]), on(rb.gt_crowd[sl]), thr_idx, area_ranges,
        )
        dm_all[sl] = dm_b.cpu().numpy()
        dig_all[sl] = dig_b.cpu().numpy()
        gt_ign_all[sl] = gt_ign_b.cpu().numpy()
        timings["matcher"] = timings.get("matcher", 0.0) + time.perf_counter() - start
        if want_ious:
            src_d, bounds_d = rb.det_src
            src_g, bounds_g = rb.gt_src
            for r in range(sl.start, sl.stop):
                nd = bounds_d[r + 1] - bounds_d[r]
                ng = bounds_g[r + 1] - bounds_g[r]
                ious_out[(int(rb.row_img[r]), int(rb.classes[rb.row_cls[r]]))] = iou_b[r - sl.start, :nd, :ng]
    return rb, dm_all, dig_all, gt_ign_all, ious_out


def evaluate_map(
    inputs: MAPInputs,
    iou_type: str,
    iou_thresholds: List[float],
    rec_thresholds: List[float],
    max_detection_thresholds: List[int],
    want_ious: bool = False,
    device: Optional[torch.device] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """Run matching (on ``device``, the CPU if None) and accumulation; returns
    COCOeval-shaped arrays.

    ``precision``: (T, R, K, A, M); ``recall``: (T, K, A, M); ``scores`` like
    precision; ``classes``: (K,). Entries stay -1 where a (class, area) has no
    non-ignored ground truth (COCOeval convention). ``timings``, if given, gains the
    seconds of ``rows``, ``iou``, ``matcher`` and ``accumulate``.
    """
    timings = {} if timings is None else timings
    num_t, num_r = len(iou_thresholds), len(rec_thresholds)
    classes_list = inputs.classes()
    num_k, num_a, num_m = len(classes_list), len(_AREA_RANGES), len(max_detection_thresholds)
    precision = -np.ones((num_t, num_r, num_k, num_a, num_m))
    recall = -np.ones((num_t, num_k, num_a, num_m))
    scores_out = -np.ones((num_t, num_r, num_k, num_a, num_m))
    rec_thrs = np.asarray(rec_thresholds, np.float64)
    rb, dm_all, dig_all, gt_ign_all, ious_out = match_rows(
        inputs, iou_type, iou_thresholds, max_detection_thresholds[-1],
        torch.device("cpu") if device is None else device, want_ious=want_ious, timings=timings,
    )
    if rb is None:
        return {
            "precision": precision, "recall": recall, "scores": scores_out,
            "classes": np.asarray(classes_list, np.int32),
            **({"ious": ious_out} if want_ious else {}),
        }

    start = time.perf_counter()
    # ---- accumulate (COCOeval.accumulate semantics), per class over its row slice
    pos_in_cell = np.arange(rb.dmax)[None, :]
    for k_idx in range(num_k):
        sl = rb.class_slices[k_idx]
        if sl.start == sl.stop:
            continue
        dm = dm_all[sl]
        dig = dig_all[sl]
        gt_ign = gt_ign_all[sl]
        det_valid_c = rb.det_valid[sl]
        det_score = rb.det_score[sl]
        gt_valid_n = rb.gt_valid[sl]

        for a_idx in range(num_a):
            npig = int((~gt_ign[:, a_idx, :] & gt_valid_n).sum())
            if npig == 0:
                continue
            dm_a = np.ascontiguousarray(dm[:, a_idx, :, :].transpose(1, 0, 2).reshape(num_t, -1))
            dig_a = np.ascontiguousarray(dig[:, a_idx, :, :].transpose(1, 0, 2).reshape(num_t, -1))
            for m_idx, mdet in enumerate(max_detection_thresholds):
                sel = det_valid_c & (pos_in_cell < mdet)  # (rows_c, dmax)
                flat_scores = np.where(sel, det_score, -np.inf).reshape(-1)
                order = np.argsort(-flat_scores, kind="mergesort")
                nd = int(sel.sum())
                ord_nd = order[:nd]
                scores_sorted = flat_scores[ord_nd]
                dm_f = dm_a[:, ord_nd]
                dig_f = dig_a[:, ord_nd]
                tps = dm_f & ~dig_f
                fps = ~dm_f & ~dig_f
                tp_sum = np.cumsum(tps, axis=1, dtype=np.float64)
                fp_sum = np.cumsum(fps, axis=1, dtype=np.float64)
                for t_idx in range(num_t):
                    tp, fp = tp_sum[t_idx], fp_sum[t_idx]
                    rc = tp / npig
                    pr = tp / (fp + tp + np.spacing(1))
                    recall[t_idx, k_idx, a_idx, m_idx] = rc[-1] if nd else 0.0
                    q = np.zeros(num_r)
                    ss = np.zeros(num_r)
                    if nd:
                        pr_env = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, rec_thrs, side="left")
                        valid = inds < nd
                        q[valid] = pr_env[inds[valid]]
                        ss[valid] = scores_sorted[inds[valid]]
                    precision[t_idx, :, k_idx, a_idx, m_idx] = q
                    scores_out[t_idx, :, k_idx, a_idx, m_idx] = ss

    timings["accumulate"] = timings.get("accumulate", 0.0) + time.perf_counter() - start
    out = {
        "precision": precision,
        "recall": recall,
        "scores": scores_out,
        "classes": np.asarray(classes_list, np.int32),
    }
    if want_ious:
        out["ious"] = ious_out
    return out


def summarize(
    precision: np.ndarray,
    recall: np.ndarray,
    iou_thresholds: List[float],
    max_detection_thresholds: List[int],
    class_idx: Optional[int] = None,
) -> Dict[str, float]:
    """COCOeval.summarize: means over entries > -1, -1 when empty."""

    def _mean(arr: np.ndarray) -> float:
        vals = arr[arr > -1]
        return float(vals.mean()) if vals.size else -1.0

    k = slice(None) if class_idx is None else slice(class_idx, class_idx + 1)
    last_m = len(max_detection_thresholds) - 1
    res = {
        "map": _mean(precision[:, :, k, 0, last_m]),
        "map_small": _mean(precision[:, :, k, 1, last_m]),
        "map_medium": _mean(precision[:, :, k, 2, last_m]),
        "map_large": _mean(precision[:, :, k, 3, last_m]),
        "mar_small": _mean(recall[:, k, 1, last_m]),
        "mar_medium": _mean(recall[:, k, 2, last_m]),
        "mar_large": _mean(recall[:, k, 3, last_m]),
    }
    res["map_50"] = (
        _mean(precision[iou_thresholds.index(0.5), :, k, 0, last_m]) if 0.5 in iou_thresholds else -1.0
    )
    res["map_75"] = (
        _mean(precision[iou_thresholds.index(0.75), :, k, 0, last_m]) if 0.75 in iou_thresholds else -1.0
    )
    for m_idx, mdet in enumerate(max_detection_thresholds):
        res[f"mar_{mdet}"] = _mean(recall[:, k, 0, m_idx])
    return res
