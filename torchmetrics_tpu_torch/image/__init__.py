"""Image metrics (FID so far) and the InceptionV3 feature extractor."""

from ._extractors import InceptionV3Features
from .generative import FrechetInceptionDistance

__all__ = ["FrechetInceptionDistance", "InceptionV3Features"]
