"""Functional metrics of the port: stateless functions on tensors, computed on the
device of the tensors they are given."""

from . import classification, detection, regression, retrieval, segmentation
from .classification import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .regression import *  # noqa: F401,F403
from .retrieval import *  # noqa: F401,F403
from .segmentation import *  # noqa: F401,F403

__all__ = [*classification.__all__, *detection.__all__, *regression.__all__, *retrieval.__all__,
           *segmentation.__all__]
