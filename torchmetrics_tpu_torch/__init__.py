"""PyTorch/CUDA port of ``torchmetrics_tpu`` for NVIDIA Hopper.

The JAX package ``torchmetrics_tpu`` is the reference; this package mirrors its module
paths and imports neither JAX nor anything of the JAX package. Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""

from . import (aggregation, classification, clustering, detection, image, nominal, parallel, regression, retrieval,
               segmentation, shape, wrappers)
from .aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, RunningMean, RunningSum, SumMetric
from .classification import *  # noqa: F401,F403
from .clustering import *  # noqa: F401,F403
from .collections import MetricCollection, QuarantinedMetric
from .detection import *  # noqa: F401,F403
from .image import *  # noqa: F401,F403
from .metric import CompositionalMetric, HostMetric, Metric
from .nominal import *  # noqa: F401,F403
from .regression import *  # noqa: F401,F403
from .retrieval import *  # noqa: F401,F403
from .segmentation import *  # noqa: F401,F403
from .shape import *  # noqa: F401,F403
from .wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
    MultitaskWrapper,
    Running,
)

__all__ = [
    "CatMetric", "CompositionalMetric", "HostMetric", "MaxMetric", "MeanMetric", "Metric", "MetricCollection",
    "MinMetric", "QuarantinedMetric", "RunningMean", "RunningSum", "SumMetric", *classification.__all__,
    *clustering.__all__, *detection.__all__, *image.__all__, *nominal.__all__, *regression.__all__,
    *retrieval.__all__, *segmentation.__all__, *shape.__all__,
    "BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper", "MultitaskWrapper",
    "Running",
]
