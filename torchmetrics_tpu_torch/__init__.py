"""PyTorch/CUDA port of ``torchmetrics_tpu`` for NVIDIA Hopper.

The JAX package ``torchmetrics_tpu`` is the reference; this package mirrors its module
paths and imports neither JAX nor anything of the JAX package. Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""

from . import classification
from .classification import *  # noqa: F401,F403
from .collections import MetricCollection
from .metric import Metric

__all__ = ["Metric", "MetricCollection", *classification.__all__]
