"""Video tower: metric classes (counterpart of ``torchmetrics_tpu/video``)."""

from .vmaf import VideoMultiMethodAssessmentFusion

__all__ = ["VideoMultiMethodAssessmentFusion"]
