"""Functional metrics of the port: stateless functions on tensors, computed on the
device of the tensors they are given."""

from . import classification, detection
from .classification import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403

__all__ = [*classification.__all__, *detection.__all__]
