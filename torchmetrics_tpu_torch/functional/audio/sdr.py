"""SDR family (counterpart of ``torchmetrics_tpu/functional/audio/sdr.py``).

SI-SDR and SA-SDR keep the JAX package's dtypes (float64 input rounds to float32, as
``jnp.asarray`` rounds it with 64-bit types off) and its ``eps``; their sums over the
time axis accumulate in float64 and round once, so the card and the CPU agree whatever
the order of the additions.

Full SDR runs in float64 on the device of its inputs. The JAX package solves each
sample's Toeplitz system on the host with scipy's Levinson recursion; here the
``(L, L)`` symmetric Toeplitz matrix is one gather of ``r_0`` at ``|i - j|`` and the
systems are solved in batches by ``torch.linalg.solve_ex``, whose error flags stay on
the device. The batch goes in chunks whose matrices stay under 256 MiB. A call then
reads the flags back once, to raise where scipy raises for the JAX package: a system
with a non-finite entry raises ``ValueError`` and a singular one (a silent target)
``numpy.linalg.LinAlgError``, for the first such system in row order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.data import _jax_dtype

_SOLVE_BYTES = 2**28  # the gathered matrices of one chunk of systems


def _inexact_eps(x: torch.Tensor) -> float:
    """``jnp.finfo(x.dtype).eps``, which refuses integer and bool dtypes."""
    if not (x.is_floating_point() or x.is_complex()):
        raise ValueError(f"data type {x.dtype} not inexact")
    return torch.finfo(x.dtype).eps


def _sum(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """A sum over ``dim`` accumulated in float64 and rounded once to ``x``'s dtype."""
    return x.sum(dim, keepdim=keepdim, dtype=torch.float64).to(x.dtype)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the time axis (kept), accumulated in float64 and rounded once."""
    return x.mean(-1, keepdim=True, dtype=torch.float64).to(x.dtype)


def _audio_pair(preds, target) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both inputs as tensors in the JAX package's dtypes, shapes checked."""
    preds, target = _jax_dtype(_as_tensor(preds)), _jax_dtype(_as_tensor(target))
    _check_same_shape(preds, target)
    return preds, target


def _sdr_solve(preds, target, filter_length: int = 512, zero_mean: bool = False,
               load_diag: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDR in dB in float64 before its rounding to float32, and a flag per system, both
    on the inputs' device: the solver's ``info`` (0 where the solve succeeded, else
    the LU's singular pivot), or -1 where the system's matrix or right-hand side holds
    a NaN or an infinity."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float64), target.to(torch.float64)
    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    target = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True).clamp(min=1e-6)
    preds = preds / torch.linalg.vector_norm(preds, dim=-1, keepdim=True).clamp(min=1e-6)

    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft, dim=-1)[..., :filter_length]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :filter_length]
    if load_diag is not None:
        r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)

    length = r_0.shape[-1]
    flat_r, flat_b = r_0.reshape(-1, length), b.reshape(-1, length)
    lags = torch.arange(length, device=r_0.device)
    toeplitz = (lags[:, None] - lags[None, :]).abs()
    chunk = max(1, _SOLVE_BYTES // (length * length * 8))
    coh, info = [], []
    for start in range(0, flat_r.shape[0], chunk):
        part_r, part_b = flat_r[start:start + chunk], flat_b[start:start + chunk]
        sol, flags = torch.linalg.solve_ex(part_r[:, toeplitz], part_b[:, :, None])
        coh.append((part_b * sol[..., 0]).sum(-1))
        finite = torch.isfinite(part_r).all(-1) & torch.isfinite(part_b).all(-1)
        info.append(torch.where(finite, flags, -1))
    coh_all = torch.cat(coh).reshape(r_0.shape[:-1])
    return 10.0 * torch.log10(coh_all / (1 - coh_all)), torch.cat(info).reshape(r_0.shape[:-1])


def _raise_as_scipy(flags: torch.Tensor) -> None:
    """Raise what scipy's ``solve_toeplitz`` raises on the first failed system, in row
    order, as the JAX package solves them. One read of the flags on the host."""
    if bool((flags == 0).all()):
        return
    first = next(code for code in flags.reshape(-1).tolist() if code != 0)
    if first < 0:
        raise ValueError("array must not contain infs or NaNs")
    raise np.linalg.LinAlgError("Singular principal minor")


def signal_distortion_ratio(
    preds,
    target,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> torch.Tensor:
    """SDR in dB via the optimal linear distortion filter (fast-bss-eval semantics), in
    float64 and rounded to float32. ``use_cg_iter`` is accepted and ignored: the solve
    is always direct. Raises as scipy does where a system cannot be solved: ``ValueError``
    on NaN or infinite input, ``numpy.linalg.LinAlgError`` on a silent target.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import signal_distortion_ratio
        >>> preds = torch.sin(torch.arange(800, dtype=torch.float32) / 20)
        >>> target = torch.sin(torch.arange(800, dtype=torch.float32) / 20 + 0.1)
        >>> signal_distortion_ratio(preds, target, filter_length=16)
        tensor(31.7806)
    """
    sdr, flags = _sdr_solve(preds, target, filter_length, zero_mean, load_diag)
    _raise_as_scipy(flags)
    return sdr.to(torch.float32)


def scale_invariant_signal_distortion_ratio(preds, target, zero_mean: bool = False) -> torch.Tensor:
    """SI-SDR in dB (scale-invariant projection residual).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import scale_invariant_signal_distortion_ratio
        >>> preds = torch.tensor([2.8, -1.2, 0.06, 1.3])
        >>> target = torch.tensor([3.0, -0.5, 0.1, 1.0])
        >>> scale_invariant_signal_distortion_ratio(preds, target)
        tensor(12.2167)
    """
    preds, target = _audio_pair(preds, target)
    eps = _inexact_eps(preds)
    if zero_mean:
        target = target - _mean(target)
        preds = preds - _mean(preds)
    alpha = (_sum(preds * target, -1, keepdim=True) + eps) / (_sum(target**2, -1, keepdim=True) + eps)
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (_sum(target_scaled**2, -1) + eps) / (_sum(noise**2, -1) + eps)
    return 10 * torch.log10(val)


def source_aggregated_signal_distortion_ratio(
    preds, target, scale_invariant: bool = True, zero_mean: bool = False
) -> torch.Tensor:
    """SA-SDR over ``(..., spk, time)``: one dB ratio over all speakers jointly.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import source_aggregated_signal_distortion_ratio
        >>> t = torch.arange(100.0)
        >>> preds = torch.stack([torch.sin(t / 9), torch.cos(t / 7)])[None]
        >>> target = torch.stack([torch.sin(t / 10), torch.cos(t / 8)])[None]
        >>> source_aggregated_signal_distortion_ratio(preds, target)
        tensor([-0.4277])
    """
    preds, target = _audio_pair(preds, target)
    if preds.ndim < 2:
        raise RuntimeError(f"The preds and target should have the shape (..., spk, time), but {preds.shape} found")
    eps = _inexact_eps(preds)
    if zero_mean:
        target = target - _mean(target)
        preds = preds - _mean(preds)
    if scale_invariant:
        alpha = (_sum(preds * target, (-2, -1), keepdim=True) + eps) / (_sum(target**2, (-2, -1), keepdim=True) + eps)
        target = alpha * target
    distortion = target - preds
    val = (_sum(target**2, (-2, -1)) + eps) / (_sum(distortion**2, (-2, -1)) + eps)
    return 10 * torch.log10(val)
