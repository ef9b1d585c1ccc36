"""Image metrics (counterpart of ``torchmetrics_tpu/image``): the generative ones (FID,
KID, InceptionScore, MiFID) with the InceptionV3 feature extractor and its weight
converter, the tensor-math ones (PSNR, PSNR-B, SSIM, MS-SSIM, UQI, VIF, TV, SAM, SCC,
ERGAS, RASE, RMSE-SW and the pan-sharpening D_lambda, D_s and QNR) and the
model-backed ones (ARNIQA on a ResNet-50, DISTS and LPIPS on their backbones,
perceptual path length). ``__all__`` is the JAX package's."""

from ._extractors import InceptionV3Features, convert_torchvision_inception_weights  # noqa: F401
from .metrics import (
    ARNIQA,
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
from .generative import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    MemorizationInformedFrechetInceptionDistance,
)
from .dists import DeepImageStructureAndTextureSimilarity
from .lpip import LearnedPerceptualImagePatchSimilarity
from .perceptual_path_length import PerceptualPathLength
from .psnr import PeakSignalNoiseRatio
from .psnrb import PeakSignalNoiseRatioWithBlockedEffect
from .ssim import MultiScaleStructuralSimilarityIndexMeasure, StructuralSimilarityIndexMeasure

__all__ = [
    "ARNIQA",
    "DeepImageStructureAndTextureSimilarity",
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PerceptualPathLength",
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
