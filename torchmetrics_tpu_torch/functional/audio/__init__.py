"""Audio tower: stateless functions (counterpart of ``torchmetrics_tpu/functional/audio``)."""

from .external import (
    deep_noise_suppression_mean_opinion_score,
    non_intrusive_speech_quality_assessment,
    perceptual_evaluation_speech_quality,
    short_time_objective_intelligibility,
    speech_reverberation_modulation_energy_ratio,
)
from .pit import permutation_invariant_training, pit_permutate
from .sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from .snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)

__all__ = [
    "complex_scale_invariant_signal_noise_ratio",
    "deep_noise_suppression_mean_opinion_score",
    "non_intrusive_speech_quality_assessment",
    "perceptual_evaluation_speech_quality",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "short_time_objective_intelligibility",
    "signal_distortion_ratio",
    "signal_noise_ratio",
    "source_aggregated_signal_distortion_ratio",
    "speech_reverberation_modulation_energy_ratio",
]
