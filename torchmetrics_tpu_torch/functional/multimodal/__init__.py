"""Multimodal tower: stateless functions (counterpart of
``torchmetrics_tpu/functional/multimodal``)."""

from .clip_iqa import clip_image_quality_assessment
from .clip_score import clip_score
from .lve import lip_vertex_error

__all__ = ["clip_image_quality_assessment", "clip_score", "lip_vertex_error"]
