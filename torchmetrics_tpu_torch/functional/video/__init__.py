"""Video functional metrics (counterpart of ``torchmetrics_tpu/functional/video``): the
in-tree elementary features and the model-file fusion path exist whatever is
installed; each path gates inside the function."""

from .vmaf import (
    VmafModel,
    calculate_luma,
    video_multi_method_assessment_fusion,
    vmaf_features,
)

__all__ = [
    "VmafModel",
    "calculate_luma",
    "video_multi_method_assessment_fusion",
    "vmaf_features",
]
