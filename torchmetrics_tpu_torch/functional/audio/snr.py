"""SNR family (counterpart of ``torchmetrics_tpu/functional/audio/snr.py``): no host
read, sums over the time axis in float64 rounded once."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor
from ...utilities.data import _jax_dtype
from .sdr import _audio_pair, _inexact_eps, _mean, _sum, scale_invariant_signal_distortion_ratio


def signal_noise_ratio(preds, target, zero_mean: bool = False) -> torch.Tensor:
    """SNR in dB: target power over residual power, per sample over the time axis.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import signal_noise_ratio
        >>> preds = torch.tensor([2.8, -1.2, 0.06, 1.3])
        >>> target = torch.tensor([3.0, -0.5, 0.1, 1.0])
        >>> signal_noise_ratio(preds, target)
        tensor(12.1764)
    """
    preds, target = _audio_pair(preds, target)
    eps = _inexact_eps(preds)
    if zero_mean:
        target = target - _mean(target)
        preds = preds - _mean(preds)
    noise = target - preds
    snr_value = (_sum(target**2, -1) + eps) / (_sum(noise**2, -1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds, target) -> torch.Tensor:
    """SI-SNR: SI-SDR with zero-mean normalization.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import scale_invariant_signal_noise_ratio
        >>> preds = torch.tensor([2.8, -1.2, 0.06, 1.3])
        >>> target = torch.tensor([3.0, -0.5, 0.1, 1.0])
        >>> scale_invariant_signal_noise_ratio(preds, target)
        tensor(12.5348)
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)


def _real_pair(x: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its ``(..., 2)`` real and imaginary parts."""
    return torch.view_as_real(x.resolve_conj()) if x.is_complex() else x


def complex_scale_invariant_signal_noise_ratio(preds, target, zero_mean: bool = False) -> torch.Tensor:
    """C-SI-SNR over complex STFT inputs ``(..., freq, time, 2)`` (or a complex dtype).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import complex_scale_invariant_signal_noise_ratio
        >>> t = torch.arange(48.0).reshape(4, 12)
        >>> preds = torch.stack([torch.sin(t), torch.cos(t)], dim=-1)[None]
        >>> target = torch.stack([torch.cos(t), torch.sin(t)], dim=-1)[None]
        >>> complex_scale_invariant_signal_noise_ratio(preds, target)
        tensor([-52.5751])
    """
    preds = _real_pair(_jax_dtype(_as_tensor(preds)))
    target = _real_pair(_jax_dtype(_as_tensor(target)))
    if (preds.ndim < 3 or preds.shape[-1] != 2) or (target.ndim < 3 or target.shape[-1] != 2):
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            f" but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    preds = preds.reshape(*preds.shape[:-3], -1)
    target = target.reshape(*target.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=zero_mean)
