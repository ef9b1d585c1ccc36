"""PanopticQuality and ModifiedPanopticQuality (counterpart of
``torchmetrics_tpu/detection/panoptic_qualities.py``).

The states are four per-category sums on the metric's device: the float32 IoU sum and
the int32 true positive, false positive and false negative counts, as in the JAX
package. Each batch's statistics come from the host numpy algorithm of
``functional/detection/panoptic_qualities.py`` (float64 IoU sums, rounded once to
float32 per batch), so the states equal the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Any, Collection, Dict, Sequence, Tuple

import numpy as np
import torch

from ..functional.detection.panoptic_qualities import (
    _get_category_id_to_continuous_id,
    _get_void_color,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _preprocess_inputs,
    _validate_inputs,
)
from ..metric import HostMetric


class PanopticQuality(HostMetric):
    """Panoptic quality of panoptic segmentations.

    Inputs are ``(B, *spatial_dims, 2)`` integer tensors or arrays of
    ``(category_id, instance_id)`` pairs; stuff instance ids are ignored. They stay
    where they are: the statistics are built on the host.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import PanopticQuality
        >>> preds = torch.tensor([[[[6, 0], [0, 0], [6, 0], [6, 0]], [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]], [[0, 0], [7, 0], [6, 0], [1, 0]]]])
        >>> target = torch.tensor([[[[6, 0], [0, 1], [6, 0], [0, 1]], [[0, 1], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [1, 0]], [[0, 1], [7, 0], [1, 0], [1, 0]]]])
        >>> metric = PanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.5417)
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        return_sq_and_rq: bool = False,
        return_per_class: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        things, stuffs = _parse_categories(things, stuffs)
        self.things = things
        self.stuffs = stuffs
        self.void_color = _get_void_color(things, stuffs)
        self.cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
        self.allow_unknown_preds_category = allow_unknown_preds_category
        self.return_sq_and_rq = return_sq_and_rq
        self.return_per_class = return_per_class

        num_categories = len(things) + len(stuffs)
        self.add_state("iou_sum", default=torch.zeros(num_categories, dtype=torch.float32), dist_reduce_fx="sum")
        for name in ("true_positives", "false_positives", "false_negatives"):
            self.add_state(name, default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")

    _modified_stuffs = None  # the variant's stuffs (set by ModifiedPanopticQuality)

    def _on_device(self, args: Sequence[Any], kwargs: Dict[str, Any]) -> Tuple[tuple, dict]:
        # the segment maps are read on the host: moving them to the card first would
        # only bring them back
        return tuple(args), dict(kwargs)

    def _host_batch_state(self, preds: Any, target: Any) -> Dict[str, torch.Tensor]:
        _validate_inputs(preds, target)
        flatten_preds = _preprocess_inputs(
            self.things, self.stuffs, preds, self.void_color, self.allow_unknown_preds_category
        )
        flatten_target = _preprocess_inputs(self.things, self.stuffs, target, self.void_color, True)
        iou_sum, tp, fp, fn = _panoptic_quality_update(
            flatten_preds, flatten_target, self.cat_id_to_continuous_id, self.void_color,
            modified_metric_stuffs=self._modified_stuffs,
        )
        return {
            "iou_sum": torch.as_tensor(iou_sum.astype(np.float32), device=self.device),
            "true_positives": torch.as_tensor(tp.astype(np.int32), device=self.device),
            "false_positives": torch.as_tensor(fp.astype(np.int32), device=self.device),
            "false_negatives": torch.as_tensor(fn.astype(np.int32), device=self.device),
        }

    def _compute(self, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        pq, sq, rq, pq_avg, sq_avg, rq_avg = _panoptic_quality_compute(
            state["iou_sum"], state["true_positives"], state["false_positives"], state["false_negatives"]
        )
        if self.return_per_class:
            if self.return_sq_and_rq:
                return torch.stack([pq, sq, rq], dim=-1)
            return pq.reshape(1, -1)
        if self.return_sq_and_rq:
            return torch.stack([pq_avg, sq_avg, rq_avg])
        return pq_avg


class ModifiedPanopticQuality(PanopticQuality):
    """Modified panoptic quality: stuff classes scored by the relaxed rule (IoU above 0)
    with one true positive per target segment.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> metric = ModifiedPanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.7667)
    """

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(things, stuffs, allow_unknown_preds_category, **kwargs)
        self._modified_stuffs = self.stuffs

    def _compute(self, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _panoptic_quality_compute(
            state["iou_sum"], state["true_positives"], state["false_positives"], state["false_negatives"]
        )[3]
