"""PyTorch/CUDA port of ``torchmetrics_tpu`` for NVIDIA Hopper.

The JAX package ``torchmetrics_tpu`` is the reference; this package mirrors its module
paths and imports neither JAX nor anything of the JAX package. Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""

from . import (aggregation, aot, audio, classification, clustering, detection, image, multimodal, nominal,
               observability, parallel, regression, retrieval, segmentation, shape, streaming, text, utilities, video,
               wrappers)
from .aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, RunningMean, RunningSum, SumMetric
from .audio import *  # noqa: F401,F403
from .classification import *  # noqa: F401,F403
from .clustering import *  # noqa: F401,F403
from .collections import MetricCollection, QuarantinedMetric
from .detection import *  # noqa: F401,F403
from .image import *  # noqa: F401,F403
# as in the JAX package, the top-level PeakSignalNoiseRatio is the compat class whose
# data_range defaults to 3.0; image.PeakSignalNoiseRatio stays strict
from .image.psnr import _CompatPeakSignalNoiseRatio as PeakSignalNoiseRatio  # noqa: E402,F811
from .metric import CompositionalMetric, HostMetric, Metric
from .multimodal import *  # noqa: F401,F403
from .reliability import ReliabilityConfig, RetryPolicy
from .nominal import *  # noqa: F401,F403
from .regression import *  # noqa: F401,F403
from .retrieval import *  # noqa: F401,F403
from .segmentation import *  # noqa: F401,F403
from .shape import *  # noqa: F401,F403
from .text import *  # noqa: F401,F403
from .video import *  # noqa: F401,F403
from .wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
    MultitaskWrapper,
    Running,
)

# folded into every AOT cache key: a new version of the package misses every old entry
__version__ = "0.1.0"

__all__ = [
    "CatMetric", "CompositionalMetric", "HostMetric", "MaxMetric", "MeanMetric", "Metric", "MetricCollection",
    "MinMetric", "QuarantinedMetric", "ReliabilityConfig", "RetryPolicy", "RunningMean", "RunningSum", "SumMetric",
    *classification.__all__,
    *audio.__all__, *clustering.__all__, *detection.__all__, *image.__all__, *nominal.__all__, *regression.__all__,
    *multimodal.__all__, *retrieval.__all__, *segmentation.__all__, *shape.__all__, *text.__all__, *video.__all__,
    "BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper", "MultitaskWrapper",
    "Running",
]
