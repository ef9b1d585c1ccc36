"""Image metrics: the generative ones (FID, KID, InceptionScore, MiFID) with the
InceptionV3 feature extractor and its weight converter, and the tensor-math ones (PSNR,
PSNR-B, SSIM, MS-SSIM, UQI, VIF, TV, SAM, SCC, ERGAS, RASE, RMSE-SW and the
pan-sharpening D_lambda, D_s and QNR). The model-backed ones (ARNIQA, DISTS, LPIPS,
perceptual path length) are not ported yet. ``__all__`` is the JAX package's less those."""

from ._extractors import InceptionV3Features, convert_torchvision_inception_weights  # noqa: F401
from .generative import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    MemorizationInformedFrechetInceptionDistance,
)
from .metrics import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    QualityWithNoReference,
    RelativeAverageSpectralError,
    RootMeanSquaredErrorUsingSlidingWindow,
    SpatialCorrelationCoefficient,
    SpatialDistortionIndex,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    TotalVariation,
    UniversalImageQualityIndex,
    VisualInformationFidelity,
)
from .psnr import PeakSignalNoiseRatio
from .psnrb import PeakSignalNoiseRatioWithBlockedEffect
from .ssim import MultiScaleStructuralSimilarityIndexMeasure, StructuralSimilarityIndexMeasure

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "MemorizationInformedFrechetInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "QualityWithNoReference",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
