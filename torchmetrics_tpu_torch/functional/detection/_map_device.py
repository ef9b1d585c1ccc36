"""Device-resident COCO mAP: one torch function from the padded row state to the summary
(counterpart of ``torchmetrics_tpu/functional/detection/_map_device.py``).

Layout (built on the host by ``detection/helpers.py:_build_device_rows``):

- ``det_rows`` ``(capacity, 7)`` f32: ``[img, label, score, x1, y1, x2, y2]``
- ``gt_rows``  ``(capacity, 8)`` f32: ``[img, label, iscrowd, area, x1, y1, x2, y2]``
- ``det_n`` / ``gt_n`` / ``img_n`` int32 scalars: valid-row cursors

Algorithm, as in the JAX package except for the matcher's loop:

1. sort gts by cell key ``img * K + label`` (stable: in-cell order is input order, the
   pycocotools tie-break order); each det finds its cell's gt window by two
   ``searchsorted`` calls, at most ``gt_group_cap`` wide, so per-det gt views are a
   ``(D, Gc)`` gather,
2. per-cell score ranks from a lexsort (successive stable sorts, least significant key
   first) and a first-occurrence ``searchsorted``; dets that can match (valid, inside
   maxDet, non-empty window) are compacted to the front,
3. the greedy matcher, **rank-major**: the JAX package walks the compacted dets one at
   a time under ``lax.fori_loop``, which in eager torch would be a dozen launches per
   detection (500,000 at COCO scale). Cells (image x class) are independent and a det
   only reads and writes its own cell's gt window, so all dets of in-cell rank ``r``
   are matched together, for ``r`` below the largest rank present (at most
   ``max_detection_thresholds[-1]`` steps): the same greedy matching. Windows of
   different cells overlap past each cell's end, so a step writes back only its
   in-cell hits (a scatter), never the whole window. Eagerly one host read, the number
   of dets at each rank, sizes the loop. Under ``torch.export`` the loop is one traced
   ``while_loop`` (the JAX package's ``fori_loop``) over a table of fixed-width chunks
   of each rank's run, built on the device; its trip count, the number of chunks, is a
   device scalar, and a chunk's padding writes to a spare row. The same matches, in at
   most ``max_detection_thresholds[-1] + capacity / chunk`` steps,
4. accumulation as segment ops: one global ``(class, -score, img, rank)`` lexsort,
   per-class TP/FP cumsums by subtracting class-start prefixes, the precision envelope
   as a segmented suffix maximum (one ``cummax`` over a flipped key that carries the
   class above the value's bits), the 101-point interpolation as a vectorized binary
   search, and masked means for the summary.

An exported and compiled evaluator gives the eager one's values: Triton's float32
division is not correctly rounded, its multiply-adds may fuse, and Inductor drops a
float32 round trip between two float64 steps, so every division is the float32 quotient
rounded once from float64 (``_div``), the IoU is computed in float64 from the float32
boxes (exact up to its division) and rounded once, and the summary means add in
float64. IoU and recall thresholds resolve in float32 (the state's dtype), as in
the JAX package, where the host evaluator compares in float64: the results differ where an IoU
lies within float32 rounding of an IoU threshold, or a recall ``k / n`` rounds onto a
recall threshold in float32 (3/5 onto float32 0.6, which lies above 0.6), and the
precision is read one detection later. With few ground truths in a class that moves a
summary value by more than 1e-4.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from torch._higher_order_ops.while_loop import while_loop

from ...utilities.data import _static_bincount
from ._map_eval import _AREA_RANGES

_INT32_MAX = int(np.iinfo(np.int32).max)
# rows of one step of the exported matcher's loop
_MATCH_CHUNK = 16384


def _segment_sum(values: torch.Tensor, segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sums of ``values`` rows by segment id in ``[0, num_segments]``; the spare segment
    ``num_segments`` (padding) is dropped."""
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, segments, values)[:num_segments]


def _lexsort(keys: List[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the last key is the primary one; stable throughout."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` as float32, divided in float64 and rounded once: the correctly rounded
    float32 quotient (53 >= 2 * 24 + 2 bits), whatever a compiler makes of a float32
    ``/`` (Triton's is not correctly rounded, and a recall ``k / n`` one unit off moves
    the recall bin it lands in). A float64 ``a`` (a mean's sum) rounds once at the end."""
    return (a.double() / torch.as_tensor(b, device=a.device).double()).to(torch.float32)


def _rows_last(values: torch.Tensor) -> torch.Tensor:
    """``(D, ...)`` -> contiguous ``(prod(...), D)``: PyTorch's CUDA scans are fast along
    the innermost dimension and slow along an outer one (a ``cumsum`` over dim 0 of
    ``(524288, 4, 10)`` took 185 ms on an H100, one thread per column)."""
    return values.reshape(values.shape[0], -1).T.contiguous()


def _rows_first(values: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """The inverse of ``_rows_last``."""
    return values.T.reshape(shape)


def _cumsum_rows(values: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along dim 0 (counts of 0/1 values: exact in float32 below 2**24)."""
    return _rows_first(torch.cumsum(_rows_last(values), dim=1), values.shape)


def _segmented_suffix_max(values: torch.Tensor, segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Within each run of equal ``segments`` (non-decreasing along dim 0), the maximum of
    ``values`` (non-negative float32) from each row to the run's end. One ``cummax`` over
    the flipped rows of an int64 key: the run's rank from the end above the value's bits,
    which for non-negative floats order as the values do."""
    flipped = _rows_last(values).flip(1).view(torch.int32).to(torch.int64)
    run = (num_segments - segments.flip(0))[None, :]
    key = (run << 32) | flipped
    best = torch.cummax(key, dim=1).values & 0xFFFFFFFF
    return _rows_first(best.to(torch.int32).view(torch.float32).flip(1), values.shape)


def build_mapeval_program(
    capacity: int,
    num_classes: int,
    gt_group_cap: int,
    iou_thresholds: List[float],
    rec_thresholds: List[float],
    max_detection_thresholds: List[int],
) -> Callable:
    """The evaluator for one (capacity, classes, window, thresholds) geometry.

    Returns ``fn(tensors) -> {summary scalars, per-class arrays, present mask}``, all
    tensors on the state's device.
    """
    D, K, Gc = int(capacity), int(num_classes), int(gt_group_cap)
    A = int(_AREA_RANGES.shape[0])
    T, R, M = len(iou_thresholds), len(rec_thresholds), len(max_detection_thresholds)
    mdet_last = int(max_detection_thresholds[-1])
    # pycocotools clamps each threshold to min(t, 1 - 1e-10) in f64 so an exact-1.0
    # IoU clears a 1.0 threshold; quantizing the clamped value to f32 keeps that
    # behavior (f32(1 - 1e-10) == 1.0 and f32 IoUs saturate at 1.0)
    thrs_np = np.minimum(np.asarray(iou_thresholds, np.float64), 1.0 - 1e-10).astype(np.float32)
    # summaries are means over all R bins, so sorting user-supplied recall
    # thresholds changes nothing observable
    rec_np = np.sort(np.asarray(rec_thresholds, np.float32))
    t50 = iou_thresholds.index(0.5) if 0.5 in iou_thresholds else None
    t75 = iou_thresholds.index(0.75) if 0.75 in iou_thresholds else None
    eps = float(np.float32(np.spacing(np.float64(1.0))))  # COCOeval's precision denominator guard

    def fn(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        det, gt = tensors["det_rows"], tensors["gt_rows"]
        dev = det.device
        thrs = torch.as_tensor(thrs_np, device=dev)
        rec_t = torch.as_tensor(rec_np, device=dev)
        areas = torch.as_tensor(_AREA_RANGES, device=dev)  # (A, 2)
        slot = torch.arange(D, device=dev)

        d_img = det[:, 0].to(torch.int32).long()
        d_lab = det[:, 1].to(torch.int32).long()
        d_score = det[:, 2]
        d_box = det[:, 3:7]
        g_img = gt[:, 0].to(torch.int32).long()
        g_lab = gt[:, 1].to(torch.int32).long()
        g_crowd = gt[:, 2] > 0
        g_area_user = gt[:, 3]
        g_box = gt[:, 4:8]
        dvalid = slot < tensors["det_n"]
        gvalid = slot < tensors["gt_n"]

        d_area = (d_box[:, 2] - d_box[:, 0]) * (d_box[:, 3] - d_box[:, 1])
        g_area_box = (g_box[:, 2] - g_box[:, 0]) * (g_box[:, 3] - g_box[:, 1])
        g_area = torch.where(g_area_user > 0, g_area_user, g_area_box)

        # ---- gts sorted by cell; stable, so in-cell order stays input order
        g_key = torch.where(gvalid, g_img * K + g_lab, _INT32_MAX)
        g_order = torch.argsort(g_key, stable=True)
        gs_key = g_key[g_order].contiguous()
        gs_valid = gvalid[g_order]
        gs_lab = torch.where(gs_valid, g_lab[g_order], K)
        gs_crowd = g_crowd[g_order] & gs_valid
        gs_area = g_area[g_order]
        gs_box = g_box[g_order]

        # ---- each det's gt window [glo, ghi) in the sorted order
        d_key = torch.where(dvalid, d_img * K + d_lab, _INT32_MAX)
        glo = torch.searchsorted(gs_key, d_key)
        ghi = torch.searchsorted(gs_key, d_key, right=True)

        # ---- per-cell score rank (stable descending: COCOeval's det order)
        neg_score = torch.where(dvalid, -d_score, torch.inf)
        d_order = _lexsort([slot, neg_score, d_key])
        key_sorted = d_key[d_order].contiguous()
        rank_sorted = slot - torch.searchsorted(key_sorted, key_sorted)

        # ---- compact matchable dets to the front, keeping (cell, -score) order
        glo_sorted, ghi_sorted = glo[d_order], ghi[d_order]
        part = dvalid[d_order] & (rank_sorted < mdet_last) & (ghi_sorted > glo_sorted)
        comp = torch.argsort((~part).to(torch.uint8), stable=True)
        perm = d_order[comp]
        part_c = part[comp]

        img_c = d_img[perm]
        valid_c = dvalid[perm]
        lab_c = torch.where(valid_c, d_lab[perm], K)
        score_c = d_score[perm]
        area_c = d_area[perm]
        rank_c = rank_sorted[comp]

        # ---- matchable dets by rank, then compacted order: rank r's dets are one run
        # of ``by_rank``
        rank_m = torch.where(part_c, rank_c, mdet_last)
        by_rank = torch.argsort(rank_m, stable=True)
        counts = _static_bincount(rank_m, minlength=mdet_last + 1)[:mdet_last]
        glo_c, ghi_c, box_c = glo_sorted[comp], ghi_sorted[comp], d_box[perm]
        gt_lanes = torch.arange(Gc, device=dev)[None, :]
        lanes = torch.arange(A * T, device=dev).reshape(1, A, T)

        def window_view(rows, valid=None):
            """Each of the dets at compacted positions ``rows``: its cell's gt window and
            the crowd-adjusted IoUs with it (``valid`` masks a chunk's padding)."""
            glo_m, box_m, area_m = glo_c[rows], box_c[rows], area_c[rows]
            widx = glo_m[:, None] + gt_lanes
            win = widx < ghi_c[rows][:, None]  # (n, Gc)
            if valid is not None:
                win = win & valid[:, None]
            widx_cl = widx.clamp(max=D - 1)
            wg_box = gs_box[widx_cl]  # (n, Gc, 4)
            wcr = gs_crowd[widx_cl] & win
            wg_area = gs_area[widx_cl]
            lt = torch.maximum(box_m[:, None, :2], wg_box[..., :2])
            rb = torch.minimum(box_m[:, None, 2:], wg_box[..., 2:])
            # the IoU in float64 from the float32 corners and areas, rounded once: the
            # products of float32 values and their sums are exact there, so neither a
            # fused multiply-add nor a compiler's removal of a float32 round trip
            # changes it (an IoU one unit off can cross a threshold)
            wh = (rb - lt).clamp(min=0.0).double()
            inter = wh[..., 0] * wh[..., 1]
            wg_box_area = (wg_box[..., 2] - wg_box[..., 0]).double() * (wg_box[..., 3] - wg_box[..., 1]).double()
            area64 = area_m[:, None].double()
            denom = torch.where(wcr, area64, area64 + wg_box_area - inter)
            pos_den = denom > 0
            wi = torch.where(pos_den, (inter / torch.where(pos_den, denom, 1.0)).to(torch.float32), 0.0)
            wig = (
                (wg_area[:, None, :] < areas[None, :, 0:1])
                | (wg_area[:, None, :] > areas[None, :, 1:2])
                | wcr[:, None, :]
                | ~win[:, None, :]
            )  # (n, A, Gc)
            return glo_m, widx_cl, win, wcr, wi, wig

        def match(gmatch, glo_m, widx_cl, win, wcr, wi, wig):
            """The greedy matcher for one rank's dets: their hits and ignored hits, and
            the flat gmatch slots they take (the spare slot where there is no hit)."""
            mwin = gmatch[: D * A * T].view(D, A, T)[widx_cl].permute(0, 2, 3, 1)  # (n, A, T, Gc)
            clr = wi[:, None, :] >= thrs[None, :, None]  # (n, T, Gc)
            cand = win[:, None, None, :] & (~mwin | wcr[:, None, None, :]) & clr[:, None, :, :]
            cand_ni = cand & ~wig[:, :, None, :]
            pool = torch.where(cand_ni.any(-1, keepdim=True), cand_ni, cand)
            vals = torch.where(pool, wi[:, None, None, :], -torch.inf)
            m = Gc - 1 - torch.argmax(vals.flip(-1), dim=-1)  # last argmax: later gt wins ties
            hit = pool.any(-1)  # (n, A, T)
            taken = torch.where(hit, (glo_m[:, None, None] + m) * (A * T) + lanes, D * A * T).reshape(-1)
            ign = hit & torch.gather(wig[:, :, None, :].expand(-1, -1, T, -1), -1, m[..., None])[..., 0]
            return hit, ign, taken

        # ---- greedy matcher, rank-major. gmatch: (sorted gt, area, threshold), plus
        # one spare row that takes the writes of dets without a hit; dm and dig carry a
        # spare row for a chunk's padding
        gmatch = torch.zeros(((D + 1) * A * T,), dtype=torch.bool, device=dev)
        dm = torch.zeros((D + 1, A, T), dtype=torch.bool, device=dev)
        dig = torch.zeros_like(dm)
        if torch.compiler.is_exporting():
            # one traced loop, as the JAX package's fori_loop: rank r's run in chunks of
            # a fixed width, the chunk table and the trip count on the device; the body
            # is functional, each chunk's window made in it
            width = min(D, _MATCH_CHUNK)
            chunks = (counts + (width - 1)) // width
            chunk_end = torch.cumsum(chunks, 0)
            slot = torch.arange(mdet_last + -(-D // width), device=dev)
            r_of = torch.searchsorted(chunk_end, slot, right=True).clamp(max=mdet_last - 1)
            offsets = torch.cumsum(counts, 0) - counts
            starts = offsets[r_of] + (slot - (chunk_end - chunks)[r_of]) * width
            ends = (offsets + counts)[r_of]
            chunk_lanes = torch.arange(width, device=dev)
            n_chunks = chunk_end[-1]

            def step(i, gmatch, dm, dig):
                at = i.reshape(1)
                idx = starts.index_select(0, at) + chunk_lanes
                valid = idx < ends.index_select(0, at)
                sel = by_rank.index_select(0, idx.clamp(max=D - 1))
                hit, ign, taken = match(gmatch, *window_view(sel, valid))
                rows = torch.where(valid, sel, D)
                return i + 1, gmatch.index_fill(0, taken, True), dm.index_put((rows,), hit), dig.index_put((rows,), ign)

            _, gmatch, dm, dig = while_loop(
                lambda i, *_: i < n_chunks, step, (torch.zeros((), dtype=torch.int64, device=dev), gmatch, dm, dig)
            )
        else:
            # eager: one host read, the number of dets at each rank, sizes the loop; the
            # windows of all matchable dets (the compacted prefix) are made once
            per_rank = counts.tolist()
            view = window_view(torch.arange(sum(per_rank), device=dev))
            start = 0
            for count in per_rank:
                if count:
                    sel = by_rank[start : start + count]
                    hit, ign, taken = match(gmatch, *(part[sel] for part in view))
                    gmatch.index_fill_(0, taken, True)
                    dm[sel] = hit
                    dig[sel] = ign
                start += count
        dm, dig = dm[:D], dig[:D]
        det_out = (area_c[:, None] < areas[None, :, 0]) | (area_c[:, None] > areas[None, :, 1])
        dig |= ~dm & det_out[:, :, None]  # unmatched dets outside the range: ignored

        # ---- COCOeval.accumulate: one global sort, per-class segment cumsums
        sel_lab = torch.where(valid_c & (rank_c < mdet_last), lab_c, K)
        acc = _lexsort([rank_c, img_c, torch.where(sel_lab < K, -score_c, torch.inf), sel_lab])
        lab_s = sel_lab[acc].contiguous()
        rank_s = rank_c[acc]
        dm_s, dig_s = dm[acc], dig[acc]

        mdets = torch.as_tensor(max_detection_thresholds, device=dev)
        sel = (lab_s[:, None] < K) & (rank_s[:, None] < mdets[None, :])  # (D, M)
        classes = torch.arange(K, device=dev)
        cls_start = torch.searchsorted(lab_s, classes)
        cls_end = torch.searchsorted(lab_s, classes, right=True)
        lab_cl = lab_s.clamp(max=K - 1)

        # summarize() reads precision at the last maxDet only, so the PR-curve
        # pipeline runs on (D, A, T), without the M axis
        tp_hit = dm_s & ~dig_s
        tps = tp_hit.to(torch.float32)  # (D, A, T); every segment row already
        fps = (~dm_s & ~dig_s).to(torch.float32)  # has rank < mdet_last
        tp_cum_g = _cumsum_rows(tps)
        fp_cum_g = _cumsum_rows(fps)
        has_prefix = (cls_start > 0)[:, None, None]
        prev = (cls_start - 1).clamp(min=0)
        base_tp = torch.where(has_prefix, tp_cum_g[prev], 0.0)  # (K, A, T)
        base_fp = torch.where(has_prefix, fp_cum_g[prev], 0.0)
        tp = tp_cum_g - base_tp[lab_cl]
        fp = fp_cum_g - base_fp[lab_cl]

        gs_ign = (gs_area[:, None] < areas[None, :, 0]) | (gs_area[:, None] > areas[None, :, 1]) | gs_crowd[:, None]
        counted = (gs_valid[:, None] & ~gs_ign).to(torch.float32)
        npig = _segment_sum(counted, gs_lab, K)  # (K, A)
        npig_d = npig[lab_cl]  # (D, A)
        rc = torch.where(npig_d[:, :, None] > 0, _div(tp, npig_d.clamp(min=1.0)[:, :, None]), 0.0)
        pr = _div(tp, tp + fp + eps)
        pr_env = _segmented_suffix_max(pr, lab_s, K)  # precision envelope per class

        # 101-point interpolation: rc is non-decreasing within a class segment, so
        # q[c, r] = pr_env[lower_bound(rc[seg_c], rec_thrs[r])], one vectorized binary
        # search over (K, R, A, T)
        lane = torch.arange(A * T, device=dev).reshape(1, 1, A, T)
        rc_lin = rc.reshape(-1)
        lo = cls_start[:, None, None, None].expand(K, R, A, T).contiguous()
        hi = cls_end[:, None, None, None].expand(K, R, A, T).contiguous()
        thr = rec_t[None, :, None, None]
        for _ in range(max(D.bit_length(), 1)):
            mid = (lo + hi) // 2
            v = rc_lin[mid.clamp(max=D - 1) * (A * T) + lane]
            go_right = (v < thr) & (mid < hi)
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        found = lo < cls_end[:, None, None, None]
        q = torch.where(found, pr_env.reshape(-1)[lo.clamp(max=D - 1) * (A * T) + lane], 0.0)  # (K, R, A, T)

        tp_tot = torch.stack(
            [_segment_sum((tp_hit & sel[:, m, None, None]).to(torch.float32), lab_s, K) for m in range(M)], dim=-1
        )  # (K, A, T, M)
        nd_cnt = _segment_sum(sel.to(torch.float32), lab_s, K)  # (K, M)
        valid_cell = npig > 0  # (K, A)
        rec_raw = torch.where(nd_cnt[:, None, None, :] > 0, _div(tp_tot, npig.clamp(min=1.0)[:, :, None, None]), 0.0)
        recall = torch.where(valid_cell[:, :, None, None], rec_raw, -1.0)  # (K, A, T, M)
        q = torch.where(valid_cell[:, None, :, None], q, -1.0)  # (K, R, A, T)

        # ---- summarize: masked means are the host's mean over entries > -1 (inside a
        # valid cell every entry is >= 0; invalid cells are uniform -1)
        lastm = M - 1

        def _precision_mean(a_idx: int, t_idx=None) -> torch.Tensor:
            block = q[:, :, a_idx, :]  # (K, R, T)
            if t_idx is not None:
                block = block[:, :, t_idx : t_idx + 1]
            w = valid_cell[:, a_idx].to(torch.float32)
            cnt = w.sum() * (block.shape[1] * block.shape[2])
            return torch.where(cnt > 0, _div((block.double() * w.double()[:, None, None]).sum(), cnt.clamp(min=1.0)), -1.0)

        def _recall_mean(a_idx: int, m_idx: int) -> torch.Tensor:
            block = recall[:, a_idx, :, m_idx]  # (K, T)
            w = valid_cell[:, a_idx].to(torch.float32)
            cnt = w.sum() * block.shape[1]
            return torch.where(cnt > 0, _div((block.double() * w.double()[:, None]).sum(), cnt.clamp(min=1.0)), -1.0)

        minus_one = torch.tensor(-1.0, device=dev)
        out: Dict[str, torch.Tensor] = {
            "map": _precision_mean(0),
            "map_small": _precision_mean(1),
            "map_medium": _precision_mean(2),
            "map_large": _precision_mean(3),
            "mar_small": _recall_mean(1, lastm),
            "mar_medium": _recall_mean(2, lastm),
            "mar_large": _recall_mean(3, lastm),
            "map_50": _precision_mean(0, t50) if t50 is not None else minus_one,
            "map_75": _precision_mean(0, t75) if t75 is not None else minus_one,
        }
        for m_idx, mdet in enumerate(max_detection_thresholds):
            out[f"mar_{mdet}"] = _recall_mean(0, m_idx)

        out["map_per_class"] = torch.where(valid_cell[:, 0], _div(q[:, :, 0, :].double().sum((1, 2)), R * T), -1.0)
        out["mar_per_class"] = torch.where(valid_cell[:, 0], _div(recall[:, 0, :, lastm].double().sum(1), T), -1.0)
        det_seen = _segment_sum(dvalid.to(torch.int32), torch.where(dvalid, d_lab, K), K)
        gt_seen = _segment_sum(gvalid.to(torch.int32), torch.where(gvalid, g_lab, K), K)
        out["present"] = (det_seen + gt_seen) > 0
        return out

    return fn
