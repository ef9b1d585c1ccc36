"""Multimodal tower: metric classes (counterpart of ``torchmetrics_tpu/multimodal``).
Only ``LipVertexError`` so far; CLIPScore and CLIP-IQA come with the model-backed
image metrics."""

from .lve import LipVertexError

__all__ = ["LipVertexError"]
