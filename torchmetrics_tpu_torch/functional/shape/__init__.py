"""Functional shape metrics (counterpart of ``torchmetrics_tpu/functional/shape``)."""

from .procrustes import procrustes_disparity

__all__ = ["procrustes_disparity"]
