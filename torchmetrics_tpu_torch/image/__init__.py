"""Image metrics (FID, KID, InceptionScore, MiFID), the InceptionV3 feature extractor
and its weight converter."""

from ._extractors import InceptionV3Features, convert_torchvision_inception_weights
from .generative import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    MemorizationInformedFrechetInceptionDistance,
)

__all__ = [
    "FrechetInceptionDistance",
    "InceptionScore",
    "InceptionV3Features",
    "KernelInceptionDistance",
    "MemorizationInformedFrechetInceptionDistance",
    "convert_torchvision_inception_weights",
]
