"""Functional metrics of the port: stateless functions on tensors, computed on the
device of the tensors they are given."""

from . import (audio, classification, clustering, detection, image, multimodal, nominal, pairwise, regression,
               retrieval, segmentation, shape, text, video)
from .audio import *  # noqa: F401,F403
from .classification import *  # noqa: F401,F403
from .clustering import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .image import *  # noqa: F401,F403
from .multimodal import *  # noqa: F401,F403
from .nominal import *  # noqa: F401,F403
from .pairwise import *  # noqa: F401,F403
from .regression import *  # noqa: F401,F403
from .retrieval import *  # noqa: F401,F403
from .segmentation import *  # noqa: F401,F403
from .shape import *  # noqa: F401,F403
from .text import *  # noqa: F401,F403
from .video import *  # noqa: F401,F403

# as in the JAX package, the top-level ``peak_signal_noise_ratio`` is the compat form whose
# ``data_range`` defaults to 3.0; ``functional.image``'s stays strict
from .image.psnr import _compat_peak_signal_noise_ratio as peak_signal_noise_ratio  # noqa: E402,F811

__all__ = [*audio.__all__, *classification.__all__, *clustering.__all__, *detection.__all__, *image.__all__,
           *multimodal.__all__, *nominal.__all__, *pairwise.__all__, *regression.__all__, *retrieval.__all__,
           *segmentation.__all__, *shape.__all__, *text.__all__, *video.__all__]
