"""VideoMultiMethodAssessmentFusion (counterpart of ``torchmetrics_tpu/video/vmaf.py``).

The class computes on either of two paths: the ``vmaf_torch`` wheel where it can be
imported, or the in-tree features and NuSVR fusion of a libvmaf model JSON given as
``model_path`` (``functional/video/vmaf.py``). Construction raises only where neither
exists. The scores, and with ``features=True`` every feature, are cat states.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from ..functional.video import vmaf as _vmaf
from ..functional.video.vmaf import _VMAF_FEATURE_ORDER, video_multi_method_assessment_fusion
from ..metric import HostMetric


class VideoMultiMethodAssessmentFusion(HostMetric):
    """VMAF over ``(batch, 3, frames, H, W)`` RGB videos in [0, 1].

    Args:
        features: return the elementary-feature dict alongside the score.
        model_path: a libvmaf model JSON (e.g. ``vmaf_v0.6.1.json``) for the in-tree
            fusion path where ``vmaf_torch`` is absent. The in-tree features are float
            pipelines: their scores track, but do not equal, libvmaf's fixed-point
            ``integer_*`` features.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(self, features: bool = False, model_path: Optional[str] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(features, bool):
            raise ValueError(f"Argument `features` should be a boolean, but got {features}.")
        if not _vmaf._VMAF_TORCH_AVAILABLE and model_path is None:
            raise ModuleNotFoundError(
                "vmaf metric requires either the vmaf-torch wheel (`pip install "
                "torchmetrics[video]`) or a libvmaf model JSON via `model_path=`."
            )
        self.features = features
        self.model_path = model_path
        self.add_state("vmaf_score", default=[], dist_reduce_fx="cat")
        if features:
            for key in _VMAF_FEATURE_ORDER:
                self.add_state(key, default=[], dist_reduce_fx="cat")

    def _host_batch_state(self, preds, target) -> Dict[str, torch.Tensor]:
        out = video_multi_method_assessment_fusion(preds, target, features=self.features, model_path=self.model_path)
        if self.features:
            return {"vmaf_score": out["vmaf"].reshape(-1), **{key: out[key].reshape(-1) for key in _VMAF_FEATURE_ORDER}}
        return {"vmaf_score": out.reshape(-1)}

    def _compute(self, state) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.features:
            return {"vmaf": state["vmaf_score"], **{k: state[k] for k in _VMAF_FEATURE_ORDER}}
        return state["vmaf_score"]
