"""Fixed-shape detection-state accumulation for sharded eval loops (counterpart of
``torchmetrics_tpu/detection/sharded.py``).

Each process accumulates its shard of images into pre-allocated padded buffers on its
device (``capacity_images`` rows of ``max_detections`` / ``max_groundtruths`` boxes),
one indexed copy per leaf per step, with the cursor kept on the device; ``gather``
all-gathers every leaf over a process group on the coalesced plane
(``parallel/coalesce.py``: one collective per dtype); ``to_lists`` unpacks the
gathered buffers on the host into the list-of-dicts that
:class:`~torchmetrics_tpu_torch.detection.MeanAveragePrecision` takes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import coalesce as _coalesce
from ..utilities.checks import resolve_device
from .helpers import _to_numpy

StateDict = Dict[str, torch.Tensor]

__all__ = ["PaddedDetectionAccumulator", "pack_detection_batch"]

_LEAVES = ("det_box", "det_scores", "det_labels", "det_counts", "gt_box", "gt_labels", "gt_crowds", "gt_area",
           "gt_counts")


def pack_detection_batch(
    preds: Sequence[Dict[str, Any]],
    target: Sequence[Dict[str, Any]],
    max_detections: int,
    max_groundtruths: int,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[torch.Tensor, ...]:
    """List-of-dicts batch -> padded tensors on ``device`` (the card if None) for
    :meth:`PaddedDetectionAccumulator.update`.

    Returns ``(det_box, det_scores, det_labels, det_counts, gt_box, gt_labels,
    gt_crowds, gt_area, gt_counts)`` with per-image rows padded to the maxima and
    truncated beyond them. Built on the host, copied once per leaf.
    """
    device = resolve_device(device)
    b = len(preds)
    det_box = np.zeros((b, max_detections, 4), np.float32)
    det_scores = np.zeros((b, max_detections), np.float32)
    det_labels = np.zeros((b, max_detections), np.int32)
    det_counts = np.zeros((b,), np.int32)
    gt_box = np.zeros((b, max_groundtruths, 4), np.float32)
    gt_labels = np.zeros((b, max_groundtruths), np.int32)
    gt_crowds = np.zeros((b, max_groundtruths), np.int32)
    gt_area = np.zeros((b, max_groundtruths), np.float32)
    gt_counts = np.zeros((b,), np.int32)
    for i, (p, t) in enumerate(zip(preds, target)):
        nd = min(_to_numpy(p["labels"]).size, max_detections)
        det_counts[i] = nd
        if nd:
            det_box[i, :nd] = _to_numpy(p["boxes"]).astype(np.float32).reshape(-1, 4)[:nd]
            det_scores[i, :nd] = _to_numpy(p["scores"]).astype(np.float32).reshape(-1)[:nd]
            det_labels[i, :nd] = _to_numpy(p["labels"]).astype(np.int32).reshape(-1)[:nd]
        ng = min(_to_numpy(t["labels"]).size, max_groundtruths)
        gt_counts[i] = ng
        if ng:
            gt_box[i, :ng] = _to_numpy(t["boxes"]).astype(np.float32).reshape(-1, 4)[:ng]
            gt_labels[i, :ng] = _to_numpy(t["labels"]).astype(np.int32).reshape(-1)[:ng]
            crowd = t.get("iscrowd")
            if crowd is not None:
                gt_crowds[i, :ng] = _to_numpy(crowd).astype(np.int32).reshape(-1)[:ng]
            area = t.get("area")
            if area is not None:
                gt_area[i, :ng] = _to_numpy(area).astype(np.float32).reshape(-1)[:ng]
    return tuple(
        torch.from_numpy(x).to(device)
        for x in (det_box, det_scores, det_labels, det_counts, gt_box, gt_labels, gt_crowds, gt_area, gt_counts)
    )


def _stacked(rows: torch.Tensor) -> torch.Tensor:
    """The gather's reduction: the ranks' values, stacked on a leading axis."""
    return rows


class PaddedDetectionAccumulator:
    """Pure fixed-shape accumulator for detection metric state (see module doc).

    ``device`` (the card if None) is where ``init`` puts the state.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import PaddedDetectionAccumulator, pack_detection_batch
        >>> acc = PaddedDetectionAccumulator(4, max_detections=2, max_groundtruths=2, device="cpu")
        >>> preds = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 10.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([1])}]
        >>> target = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 9.0]]), "labels": torch.tensor([1])}]
        >>> state = acc.update(acc.init(), *pack_detection_batch(preds, target, 2, 2, device="cpu"))
        >>> int(state["n_images"]), acc.to_lists(state)[1][0]["boxes"].tolist()
        (1, [[0.0, 0.0, 10.0, 9.0]])
    """

    def __init__(
        self,
        capacity_images: int,
        max_detections: int = 100,
        max_groundtruths: int = 100,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.capacity_images = capacity_images
        self.max_detections = max_detections
        self.max_groundtruths = max_groundtruths
        self.device = resolve_device(device)

    # ------------------------------------------------------------------- pure
    def init(self) -> StateDict:
        i, d, g = self.capacity_images, self.max_detections, self.max_groundtruths
        f32, i32 = {"dtype": torch.float32, "device": self.device}, {"dtype": torch.int32, "device": self.device}
        return {
            "det_box": torch.zeros((i, d, 4), **f32),
            "det_scores": torch.zeros((i, d), **f32),
            "det_labels": torch.zeros((i, d), **i32),
            "det_counts": torch.zeros((i,), **i32),
            "gt_box": torch.zeros((i, g, 4), **f32),
            "gt_labels": torch.zeros((i, g), **i32),
            "gt_crowds": torch.zeros((i, g), **i32),
            "gt_area": torch.zeros((i, g), **f32),
            "gt_counts": torch.zeros((i,), **i32),
            "n_images": torch.zeros((), **i32),
        }

    def update(self, state: StateDict, det_box, det_scores, det_labels, det_counts,
               gt_box, gt_labels, gt_crowds, gt_area, gt_counts) -> StateDict:
        """Write one padded batch (leading axis = images) at the cursor; pure.

        As XLA's ``dynamic_update_slice`` in the JAX package, the start clamps to
        ``capacity - batch``: past the capacity the last rows are overwritten while
        ``n_images`` keeps counting. The rows' index is built on the device, so no step
        reads the cursor on the host.
        """
        batch = (det_box, det_scores, det_labels, det_counts, gt_box, gt_labels, gt_crowds, gt_area, gt_counts)
        b = det_counts.shape[0]
        if b > self.capacity_images:
            raise ValueError(f"A batch of {b} images does not fit capacity_images={self.capacity_images}")
        at = state["n_images"]
        rows = at.long().clamp(0, self.capacity_images - b) + torch.arange(b, device=at.device)
        new = dict(state)
        for key, value in zip(_LEAVES, batch):
            new[key] = state[key].index_copy(0, rows, value.to(state[key].dtype))
        new["n_images"] = at + b
        return new

    def gather(self, state: StateDict, group: Any = None) -> StateDict:
        """All-gather every leaf over the processes of ``group`` (the default group if
        None): leaves gain a leading process axis; counts stay per process so that
        ``to_lists`` can trim. One all-gather per dtype. A process without a group is a
        world of one."""
        if not dist.is_initialized():
            return {k: v[None] for k, v in state.items()}
        return _coalesce.reduce_many([(state, {k: _stacked for k in state})], group)[0]

    # ------------------------------------------------------------------- host
    def to_lists(self, state: StateDict) -> Tuple[List[Dict[str, np.ndarray]], List[Dict[str, np.ndarray]]]:
        """Gathered (or single-process) state -> the ``(preds, target)`` list-of-dicts
        that ``MeanAveragePrecision.update`` takes. On the host; trims padding."""
        host = {k: _to_numpy(v) for k, v in state.items()}
        if host["n_images"].ndim == 0:  # single-process state: add a process axis
            host = {k: v[None] for k, v in host.items()}
        preds: List[Dict[str, np.ndarray]] = []
        target: List[Dict[str, np.ndarray]] = []
        for proc in range(host["n_images"].shape[0]):
            n = int(host["n_images"][proc])
            for i in range(min(n, self.capacity_images)):
                nd = int(host["det_counts"][proc, i])
                ng = int(host["gt_counts"][proc, i])
                preds.append({
                    "boxes": host["det_box"][proc, i, :nd],
                    "scores": host["det_scores"][proc, i, :nd],
                    "labels": host["det_labels"][proc, i, :nd],
                })
                target.append({
                    "boxes": host["gt_box"][proc, i, :ng],
                    "labels": host["gt_labels"][proc, i, :ng],
                    "iscrowd": host["gt_crowds"][proc, i, :ng],
                    "area": host["gt_area"][proc, i, :ng],
                })
        return preds, target
