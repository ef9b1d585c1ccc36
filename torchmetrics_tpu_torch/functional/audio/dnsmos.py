"""DNSMOS, Deep Noise Suppression Mean Opinion Score (counterpart of
``torchmetrics_tpu/functional/audio/dnsmos.py``).

The librosa-equivalent features run in float64 torch ops on the device of the input:
the periodic Hann window, ``center=True`` constant padding, the Slaney mel filterbank
(built in numpy, as in the JAX package) and ``power_to_db`` with a per-sample maximum
reference and an 80 dB floor. The models are the DNS-Challenge ONNX files, run by
onnxruntime on the host; ``infer_fns`` replaces them by two callables, which receive
the model's float32 input on the input's device and may return a tensor or an array.
The published polynomial calibration runs in float64 on the device. A resample for
``fs != 16000`` is scipy's ``resample_poly`` on the host, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...utilities.checks import _as_tensor, resolve_device
from ...utilities.data import _device_constant
from ...utilities.imports import _module_available

_ONNXRUNTIME_AVAILABLE = _module_available("onnxruntime")

SAMPLING_RATE = 16000
INPUT_LENGTH = 9.01
DNSMOS_DIR = "~/.torchmetrics/DNSMOS"

_POLY = {  # calibration polynomials (ascending powers) of mos_sig, mos_bak and mos_ovr
    True: ([-0.24348726, 1.19576786, 0.02751166, -0.01019296], [0.96883132, -0.1644611, 0.44276479, -0.04976499],
           [-0.11236046, 1.18058466, 0.005101, -0.00533021]),
    False: ([0.0052439, 1.22083953, -0.08397278], [-0.39604546, 1.60915514, -0.13166888],
            [0.04602535, 1.11546468, -0.06766283]),
}


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(log_region, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-style (librosa-default) triangular mel filterbank, slaney-normalized, as
    a float64 ``(n_mels, 1 + n_fft // 2)`` numpy array. The bins are ``rfftfreq``'s, so
    an odd ``n_fft`` (DNSMOS uses 321) puts them where librosa puts them."""
    fmax = fmax or sr / 2.0
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return weights * enorm[:, None]


def _periodic_hann(n_fft: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)


def _frames(x: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor) -> torch.Tensor:
    """``(B, T)`` padded signals -> ``(B, frames, n_fft)`` windowed frames."""
    return x.unfold(-1, n_fft, hop_length) * window


def _stft_power(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """|STFT|^2 with librosa's defaults: periodic Hann of ``win_length = n_fft``,
    ``center=True`` constant padding; (B, T) -> (B, 1 + n_fft // 2, frames)."""
    window = _device_constant(_periodic_hann, audio.device, n_fft)
    x =torch.nn.functional.pad(audio, (n_fft // 2, n_fft // 2))
    spec = torch.fft.rfft(_frames(x, n_fft, hop_length, window), dim=-1)
    return spec.abs().transpose(1, 2) ** 2


def _power_to_db(s: torch.Tensor, amin: float = 1e-10, top_db: float = 80.0) -> torch.Tensor:
    """``librosa.power_to_db`` with ``ref=np.max`` (each sample's maximum)."""
    dims = tuple(range(1, s.ndim))
    ref = s.amax(dim=dims, keepdim=True).clamp(min=amin)
    log_spec = 10.0 * torch.log10(s.clamp(min=amin)) - 10.0 * torch.log10(ref)
    return torch.maximum(log_spec, log_spec.amax(dim=dims, keepdim=True) - top_db)


def _audio_melspec(audio: torch.Tensor, n_mels: int = 120, frame_size: int = 320, hop_length: int = 160,
                   sr: int = 16000, to_db: bool = True) -> torch.Tensor:
    """Mel power spectrogram (``n_fft = frame_size + 1``) as ``(..., frames, n_mels)``
    float32, optionally ``(power_to_db(ref=max) + 40) / 40``."""
    shape = audio.shape
    x = audio.reshape(-1, shape[-1]).to(torch.float64)
    n_fft = frame_size + 1
    power = _stft_power(x, n_fft, hop_length)  # (B, bins, frames)
    fb = _device_constant(mel_filterbank, x.device, sr, n_fft, n_mels)
    mel = torch.matmul(fb, power).transpose(1, 2)  # (B, frames, n_mels)
    if to_db:
        mel = (_power_to_db(mel) + 40) / 40
    return mel.reshape(*shape[:-1], *mel.shape[1:]).to(torch.float32)


_SESSION_CACHE: dict = {}


def _load_session(path: str, num_threads: Optional[int] = None, cache_session: bool = True) -> Callable:
    """An onnxruntime session on the host, as a callable of the model's input."""
    path = os.path.expanduser(path)
    key = (path, num_threads)
    if cache_session and key in _SESSION_CACHE:
        return _SESSION_CACHE[key]
    if not os.path.exists(path):
        raise ModuleNotFoundError(
            f"DNSMOS model file {path!r} not found and this environment has no network "
            "egress to download it. Fetch the DNS-Challenge ONNX models offline into "
            f"{DNSMOS_DIR}, or pass `infer_fns=(p808_fn, sig_bak_ovr_fn)`."
        )
    import onnxruntime as ort

    opts = ort.SessionOptions()
    if num_threads is not None:
        opts.inter_op_num_threads = num_threads
        opts.intra_op_num_threads = num_threads
    sess = ort.InferenceSession(path, providers=["CPUExecutionProvider"], sess_options=opts)

    def run(features: torch.Tensor) -> np.ndarray:
        return sess.run(None, {"input_1": features.detach().cpu().numpy()})[0]

    if cache_session:
        _SESSION_CACHE[key] = run
    return run


def _polyval(coefs, x: torch.Tensor) -> torch.Tensor:
    """``np.polynomial.Polynomial(coefs)(x)`` by the same Horner steps."""
    out = torch.full_like(x, coefs[-1])
    for c in coefs[-2::-1]:
        out = c + out * x
    return out


def _polyfit_val(mos: torch.Tensor, personalized: bool) -> torch.Tensor:
    """Raw model outputs -> calibrated MOS by the published DNSMOS polynomial fits."""
    p_sig, p_bak, p_ovr = _POLY[personalized]
    return torch.stack([mos[..., 0], _polyval(p_sig, mos[..., 1]), _polyval(p_bak, mos[..., 2]),
                        _polyval(p_ovr, mos[..., 3])], dim=-1)


def deep_noise_suppression_mean_opinion_score(
    preds,
    fs: int,
    personalized: bool,
    device: Optional[str] = None,
    num_threads: Optional[int] = None,
    cache_session: bool = True,
    infer_fns: Optional[Tuple[Callable, Callable]] = None,
) -> torch.Tensor:
    """DNSMOS values ``[..., 4]`` = [p808_mos, mos_sig, mos_bak, mos_ovr], float32.

    ``infer_fns=(p808_fn, sig_bak_ovr_fn)`` replaces onnxruntime: each callable maps the
    model's input to its raw scores (p808: melspec ``(B, frames, 120)`` -> ``(B, 1)``;
    sig_bak_ovr: raw audio ``(B, T)`` -> ``(B, 3)``). ``device`` places input that is
    not a tensor yet (a tensor is moved there); by default input is made on CUDA and a
    tensor stays where it is.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import deep_noise_suppression_mean_opinion_score
        >>> p808 = lambda mel: mel.mean(dim=(1, 2))[:, None]
        >>> sig_bak_ovr = lambda audio: audio.abs().mean(1, keepdim=True).repeat(1, 3) + 3
        >>> wave = torch.sin(torch.arange(16000.0) / 7)
        >>> deep_noise_suppression_mean_opinion_score(wave, 16000, False, device="cpu", infer_fns=(p808, sig_bak_ovr))
        tensor([-0.7991,  3.3344,  3.7145,  3.2077])
    """
    audio = _as_tensor(preds) if device is None else torch.as_tensor(preds).to(resolve_device(device))
    if infer_fns is not None:
        p808_run, sbo_run = infer_fns
    else:
        if not _ONNXRUNTIME_AVAILABLE:
            raise ModuleNotFoundError(
                "DNSMOS metric requires that onnxruntime is installed."
                " Install as `pip install onnxruntime`, or pass `infer_fns`."
            )
        sbo_run = _load_session(
            f"{DNSMOS_DIR}/{'p' if personalized else ''}DNSMOS/sig_bak_ovr.onnx", num_threads, cache_session
        )
        p808_run = _load_session(f"{DNSMOS_DIR}/DNSMOS/model_v8.onnx", num_threads, cache_session)

    audio = audio.to(torch.float32)
    if fs != SAMPLING_RATE:
        from scipy.signal import resample_poly

        g = np.gcd(int(fs), SAMPLING_RATE)
        host = audio.detach().cpu().numpy().astype(np.float64)
        audio = torch.as_tensor(resample_poly(host, SAMPLING_RATE // g, int(fs) // g, axis=-1).astype(np.float32),
                                device=audio.device)
    len_samples = int(INPUT_LENGTH * SAMPLING_RATE)
    while audio.shape[-1] < len_samples:
        audio = torch.cat([audio, audio], dim=-1)
    num_hops = int(np.floor(audio.shape[-1] / SAMPLING_RATE) - INPUT_LENGTH) + 1

    moss = []
    for idx in range(num_hops):
        seg = audio[..., int(idx * SAMPLING_RATE) : int((idx + INPUT_LENGTH) * SAMPLING_RATE)]
        if seg.shape[-1] < len_samples:
            continue
        shape = seg.shape
        seg = seg.reshape(-1, shape[-1])
        raw = torch.as_tensor(p808_run(_audio_melspec(seg[..., :-160])), device=audio.device)
        sbo = torch.as_tensor(sbo_run(seg), device=audio.device)
        mos = torch.cat([raw, sbo], dim=-1).to(torch.float64)
        moss.append(_polyfit_val(mos, personalized).reshape(*shape[:-1], 4))
    return torch.stack(moss, dim=-1).mean(dim=-1).to(torch.float32)
