"""Functional metrics of the port: stateless functions on tensors, computed on the
device of the tensors they are given."""

from . import classification, clustering, detection, nominal, pairwise, regression, retrieval, segmentation, shape
from .classification import *  # noqa: F401,F403
from .clustering import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .nominal import *  # noqa: F401,F403
from .pairwise import *  # noqa: F401,F403
from .regression import *  # noqa: F401,F403
from .retrieval import *  # noqa: F401,F403
from .segmentation import *  # noqa: F401,F403
from .shape import *  # noqa: F401,F403

__all__ = [*classification.__all__, *clustering.__all__, *detection.__all__, *nominal.__all__, *pairwise.__all__,
           *regression.__all__, *retrieval.__all__, *segmentation.__all__, *shape.__all__]
