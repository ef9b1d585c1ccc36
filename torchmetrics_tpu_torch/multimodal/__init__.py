"""Multimodal tower: metric classes (counterpart of ``torchmetrics_tpu/multimodal``)."""

from .clip_iqa import CLIPImageQualityAssessment
from .clip_score import CLIPScore
from .lve import LipVertexError

__all__ = ["CLIPImageQualityAssessment", "CLIPScore", "LipVertexError"]
