"""Multimodal tower: stateless functions (counterpart of
``torchmetrics_tpu/functional/multimodal``). Only LVE so far; CLIPScore and CLIP-IQA
come with the model-backed image metrics."""

from .lve import lip_vertex_error

__all__ = ["lip_vertex_error"]
