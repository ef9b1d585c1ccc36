"""Speech-to-Reverberation Modulation energy Ratio (counterpart of
``torchmetrics_tpu/functional/audio/srmr.py``).

The gammatone ERB filterbank is Slaney's design (Apple TR #35, 1993: four cascaded
biquads per channel and a gain) and the 8-channel Q=2 modulation filterbank a bank of
bandpass biquads, as in the JAX package. Their IIR recursions run as there: scipy's
``lfilter`` in float64 on the host, since a recursion is sequential over time and
torch has no ``lfilter``. Everything between and after them runs in float64 on the
device of the input: the Hilbert envelope (one FFT each way, the FFT length rounded up
to a multiple of 16), the Hamming-windowed frame energies (a strided ``conv1d`` of the
squared bands with the squared window) and their normalisation. The k90 cut and the
scores are the JAX package's numpy over the ``(batch, filters, 8)`` mean energies.

An update reads the device three times (the normalised waveforms before the ERB
filterbank, the envelopes before the modulation filterbank, the mean energies) and
copies to it ten times (the bands, the eight modulation outputs, the scores); each
copy waits for the device as a read does.
"""

from __future__ import annotations

from math import ceil, pi
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...utilities.checks import _as_tensor
from ...utilities.data import _device_constant

_EAR_Q = 9.26449  # Glasberg and Moore parameters
_MIN_BW = 24.7


def _centre_freqs(fs: int, num_freqs: int, cutoff: float) -> np.ndarray:
    """ERB-spaced centre frequencies from ``cutoff`` to fs/2, HIGHEST first (Slaney's
    ERBSpace)."""
    low, high = cutoff, fs / 2.0
    c = _EAR_Q * _MIN_BW
    return -c + np.exp(
        np.arange(1, num_freqs + 1) * (-np.log(high + c) + np.log(low + c)) / num_freqs
    ) * (high + c)


def _erb_bandwidths(cfs: np.ndarray, order: float = 1.0) -> np.ndarray:
    return ((cfs / _EAR_Q) ** order + _MIN_BW**order) ** (1.0 / order)


def _make_erb_filters(fs: int, cfs: np.ndarray) -> np.ndarray:
    """Slaney's 4th-order gammatone as four cascaded biquads: (N, 10) rows of
    [A0, A11, A12, A13, A14, A2, B0, B1, B2, gain]."""
    t = 1.0 / fs
    b = 1.019 * 2 * pi * _erb_bandwidths(cfs)
    arg = 2 * cfs * pi * t
    vec = np.exp(2j * arg)

    a0 = t
    a2 = 0.0
    b0 = 1.0
    b1 = -2 * np.cos(arg) / np.exp(b * t)
    b2 = np.exp(-2 * b * t)

    rt_pos = np.sqrt(3 + 2**1.5)
    rt_neg = np.sqrt(3 - 2**1.5)

    common = -t * np.exp(-(b * t))
    k11 = np.cos(arg) + rt_pos * np.sin(arg)
    k12 = np.cos(arg) - rt_pos * np.sin(arg)
    k13 = np.cos(arg) + rt_neg * np.sin(arg)
    k14 = np.cos(arg) - rt_neg * np.sin(arg)
    a11, a12, a13, a14 = common * k11, common * k12, common * k13, common * k14

    gain_arg = np.exp(1j * arg - b * t)
    gain = np.abs(
        (vec * t - gain_arg * t * k12)
        * (vec * t - gain_arg * t * k11)
        * (vec * t - gain_arg * t * k14)
        * (vec * t - gain_arg * t * k13)
        / (-2 / np.exp(2 * b * t) - 2 * vec + 2 * (1 + vec) / np.exp(b * t)) ** 4
    )
    n = cfs.shape[0]
    return np.column_stack([
        np.full(n, a0), a11, a12, a13, a14, np.full(n, a2),
        np.full(n, b0), b1, b2, gain,
    ])


def _erb_filterbank(wave: np.ndarray, coefs: np.ndarray) -> np.ndarray:
    """(B, T) x (N, 10) -> (B, N, T) on the host: four cascaded biquads per channel."""
    from scipy.signal import lfilter

    out = np.empty((wave.shape[0], coefs.shape[0], wave.shape[1]), np.float64)
    for ch in range(coefs.shape[0]):
        a0, a11, a12, a13, a14, a2, b0, b1, b2, gain = coefs[ch]
        den = [b0, b1, b2]
        y = lfilter([a0, a11, a2], den, wave, axis=-1)
        y = lfilter([a0, a12, a2], den, y, axis=-1)
        y = lfilter([a0, a13, a2], den, y, axis=-1)
        y = lfilter([a0, a14, a2], den, y, axis=-1)
        out[:, ch] = y / gain
    return out


def _hilbert_envelope(x: torch.Tensor) -> torch.Tensor:
    """|analytic signal| over the last axis, FFT length rounded up to a multiple of 16
    (the rounding changes values slightly and is kept, as in the JAX package)."""
    t = x.shape[-1]
    n = ceil(t / 16) * 16 if t % 16 else t
    x_fft = torch.fft.fft(x, n=n, dim=-1)
    h = torch.zeros(n, dtype=torch.float64, device=x.device)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[0] = 1
        h[1 : (n + 1) // 2] = 2
    return torch.fft.ifft(x_fft * h, dim=-1)[..., :t].abs()


def _modulation_filterbank(min_cf: float, max_cf: float, n: int, fs: float, q: float):
    """Geometric centre frequencies, 2nd-order bandpass biquads (b, a) and the lower
    3 dB cutoffs (SRMRToolbox design)."""
    spacing = (max_cf / min_cf) ** (1.0 / (n - 1))
    cfs = min_cf * spacing ** np.arange(n)
    w0 = 2 * pi * cfs / fs
    w = np.tan(w0 / 2)
    b0 = w / q
    bs = np.stack([b0, np.zeros(n), -b0], axis=1)
    aas = np.stack([1 + b0 + w**2, 2 * w**2 - 2, 1 - b0 + w**2], axis=1)
    low_cut = cfs - b0 * fs / (2 * pi)
    return cfs, bs, aas, low_cut


def _squared_hamming(n: int) -> np.ndarray:
    """The squared periodic Hamming window of ``n`` samples."""
    return np.hamming(n + 1)[:-1] ** 2


def _frame_energy(x: torch.Tensor, w_length: int, w_inc: int, num_frames: int) -> torch.Tensor:
    """Hamming-windowed squared frame energies over the last axis: the frames start
    every ``w_inc`` samples, ``num_frames`` of them, as one strided ``conv1d`` of the
    squared signal with the squared periodic window (zeros past the end, as the JAX
    package pads)."""
    t = x.shape[-1]
    if t < w_length:
        x = F.pad(x, (0, w_length - t))
    window = _device_constant(_squared_hamming, x.device, w_length)
    lead = x.shape[:-1]
    energy = F.conv1d(x.reshape(-1, 1, x.shape[-1]) ** 2, window.reshape(1, 1, -1), stride=w_inc)
    return energy[:, 0, :max(num_frames, 0)].reshape(*lead, -1)


def _normalize_energy(energy: torch.Tensor, drange: float = 30.0) -> torch.Tensor:
    """Clamp into a 30 dB dynamic range below the peak mean-over-filters energy."""
    peak = energy.mean(dim=1, keepdim=True).amax(dim=(2, 3), keepdim=True)
    floor = peak * 10.0 ** (-drange / 10.0)
    return torch.minimum(torch.maximum(energy, floor), peak)


def _srmr_arg_validate(
    fs: int, n_cochlear_filters: int, low_freq: float, min_cf: float,
    max_cf: Optional[float], norm: bool, fast: bool,
) -> None:
    if not (isinstance(fs, int) and fs > 0):
        raise ValueError(f"Expected argument `fs` to be a positive int, but got {fs}")
    if not (isinstance(n_cochlear_filters, int) and n_cochlear_filters > 0):
        raise ValueError(
            f"Expected argument `n_cochlear_filters` to be a positive int, but got {n_cochlear_filters}"
        )
    if not ((isinstance(low_freq, (float, int))) and low_freq > 0):
        raise ValueError(f"Expected argument `low_freq` to be a positive float, but got {low_freq}")
    if not ((isinstance(min_cf, (float, int))) and min_cf > 0):
        raise ValueError(f"Expected argument `min_cf` to be a positive float, but got {min_cf}")
    if max_cf is not None and not ((isinstance(max_cf, (float, int))) and max_cf > 0):
        raise ValueError(f"Expected argument `max_cf` to be a positive float, but got {max_cf}")
    if not isinstance(norm, bool):
        raise ValueError("Expected argument `norm` to be a bool value")
    if not isinstance(fast, bool):
        raise ValueError("Expected argument `fast` to be a bool value")


def _srmr_scores(avg_energy: np.ndarray, erbs: np.ndarray, cutoffs: np.ndarray) -> np.ndarray:
    """Per-sample SRMR from the ``(B, N, 8)`` mean energies: the k90 bandwidth picks the
    last modulation band of the denominator."""
    num_batch = avg_energy.shape[0]
    total_energy = avg_energy.reshape(num_batch, -1).sum(-1)
    ac_energy = avg_energy.sum(2)  # (B, N)
    ac_perc = ac_energy * 100 / total_energy[:, None]
    ac_perc_cumsum = ac_perc[:, ::-1].cumsum(-1)
    k90_idx = ((ac_perc_cumsum > 90).cumsum(-1) == 1).argmax(-1)  # first idx past 90%
    bw = erbs[k90_idx]  # (B,)

    scores = np.empty(num_batch)
    for bi in range(num_batch):
        if cutoffs[4] <= bw[bi] < cutoffs[5]:
            kstar = 5
        elif cutoffs[5] <= bw[bi] < cutoffs[6]:
            kstar = 6
        elif cutoffs[6] <= bw[bi] < cutoffs[7]:
            kstar = 7
        elif cutoffs[7] <= bw[bi]:
            kstar = 8
        else:
            raise ValueError("Something wrong with the cutoffs compared to bw values.")
        scores[bi] = avg_energy[bi, :, :4].sum() / avg_energy[bi, :, 4:kstar].sum()
    return scores


def speech_reverberation_modulation_energy_ratio(
    preds,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = None,
    norm: bool = False,
    fast: bool = False,
) -> torch.Tensor:
    """SRMR: ratio of low (below about 20 Hz) to high modulation-band energy of the
    gammatone envelope; higher means less reverberant or degraded speech. float32 on
    the input's device. ``fast=True`` (the gammatonegram shortcut) is not implemented.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import speech_reverberation_modulation_energy_ratio
        >>> wave = torch.sin(torch.arange(8000, dtype=torch.float64) / 8) * torch.cos(torch.arange(8000) / 500)
        >>> speech_reverberation_modulation_energy_ratio(wave, 8000)
        tensor([72.4991])
    """
    _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
    if fast:
        raise NotImplementedError(
            "`fast=True` (the gammatonegram approximation) is not implemented; the "
            "reference itself marks it inconsistent with SRMRToolbox. Use fast=False."
        )
    arr = _as_tensor(preds)
    shape = arr.shape
    x = arr.reshape(1, -1) if arr.ndim == 1 else arr.reshape(-1, shape[-1])
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64) / torch.iinfo(arr.dtype).max
    x = x.to(torch.float64)
    # into [-1, 1] where a sample exceeds it, as the JAX package normalises
    max_vals = x.abs().amax(dim=-1, keepdim=True)
    x = x / torch.where(max_vals > 1, max_vals, torch.ones_like(max_vals))
    t = x.shape[-1]

    cfs = _centre_freqs(fs, n_cochlear_filters, low_freq)
    bands = _erb_filterbank(x.detach().cpu().numpy(), _make_erb_filters(fs, cfs))
    gt_env = _hilbert_envelope(torch.from_numpy(bands).to(arr.device))  # (B, N, T)
    mfs = float(fs)
    w_length = ceil(0.256 * mfs)
    w_inc = ceil(0.064 * mfs)
    if max_cf is None:
        max_cf = 30 if norm else 128
    _, mod_b, mod_a, cutoffs = _modulation_filterbank(min_cf, float(max_cf), 8, mfs, q=2)

    from scipy.signal import lfilter

    num_frames = int(1 + (t - w_length) // w_inc)
    env_host = gt_env.cpu().numpy()
    energy = torch.stack([
        _frame_energy(torch.from_numpy(lfilter(mod_b[k], mod_a[k], env_host, axis=-1)).to(arr.device),
                      w_length, w_inc, num_frames)
        for k in range(8)
    ], dim=2)  # (B, N, 8, F)
    if norm:
        energy = _normalize_energy(energy)
    avg_energy = energy.mean(dim=-1).cpu().numpy()  # (B, N, 8)
    scores = _srmr_scores(avg_energy, _erb_bandwidths(cfs)[::-1], cutoffs)
    out = scores.reshape(shape[:-1]) if arr.ndim > 1 else scores
    return torch.as_tensor(out, dtype=torch.float32, device=arr.device)
