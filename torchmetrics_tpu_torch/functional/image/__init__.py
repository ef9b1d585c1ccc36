"""Functional image metrics (counterpart of ``torchmetrics_tpu/functional/image``):
PSNR and PSNR-B, SSIM and MS-SSIM (2-D and 3-D), UQI, VIF, total variation,
sliding-window RMSE, RASE, SCC, image gradients, the pan-sharpening indices (SAM, ERGAS,
D_lambda, D_s, QNR) and the model-backed LPIPS, DISTS, ARNIQA and perceptual path
length."""

from .arniqa import arniqa
from .d_lambda import spectral_distortion_index
from .dists import deep_image_structure_and_texture_similarity
from .d_s import spatial_distortion_index
from .ergas import error_relative_global_dimensionless_synthesis
from .gradients import image_gradients
from .lpips import learned_perceptual_image_patch_similarity
from .perceptual_path_length import perceptual_path_length
from .psnr import peak_signal_noise_ratio
from .psnrb import peak_signal_noise_ratio_with_blocked_effect
from .qnr import quality_with_no_reference
from .rase import relative_average_spectral_error
from .rmse_sw import root_mean_squared_error_using_sliding_window
from .sam import spectral_angle_mapper
from .scc import spatial_correlation_coefficient
from .ssim import multiscale_structural_similarity_index_measure, structural_similarity_index_measure
from .tv import total_variation
from .uqi import universal_image_quality_index
from .vif import visual_information_fidelity

__all__ = [
    "arniqa",
    "deep_image_structure_and_texture_similarity",
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "learned_perceptual_image_patch_similarity",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "perceptual_path_length",
    "peak_signal_noise_ratio_with_blocked_effect",
    "quality_with_no_reference",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spatial_correlation_coefficient",
    "spatial_distortion_index",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
    "visual_information_fidelity",
]
