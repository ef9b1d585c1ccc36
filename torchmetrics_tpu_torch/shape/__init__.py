"""Shape metric classes (counterpart of ``torchmetrics_tpu/shape``)."""

from .procrustes import ProcrustesDisparity

__all__ = ["ProcrustesDisparity"]
