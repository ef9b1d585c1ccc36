"""Functional metrics of the port: stateless functions on tensors, computed on the
device of the tensors they are given."""

from . import classification, detection, regression
from .classification import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .regression import *  # noqa: F401,F403

__all__ = [*classification.__all__, *detection.__all__, *regression.__all__]
