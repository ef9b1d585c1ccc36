"""Visual Information Fidelity (counterpart of ``torchmetrics_tpu/functional/image/vif.py``).

Four scales with gaussian windows of 17, 9, 5 and 3 taps (sigma n / 5): a valid
convolution and ``[:, :, ::2, ::2]`` down-sample between scales, the three masks in the
JAX package's order and ``log10`` sums (float64, rounded once a scale). The channels
are stacked into the batch axis, each channel alone as in the JAX package's loop, and
each scale's five moment images go through one convolution."""

from __future__ import annotations

import torch

from .utils import _jax_tensor, conv2d


def _filter(win_size: float, sigma: float, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """The 2-D gaussian window, computed in float64 and rounded once (the card's and the
    CPU's weights then agree; see ``utils._gaussian``)."""
    coords = torch.arange(int(win_size), dtype=torch.float64, device=device) - (win_size - 1) / 2
    g = coords**2
    g = torch.exp(-(g[None, :] + g[:, None]) / (2.0 * sigma**2))
    return (g / g.sum()).to(dtype)


def _vif_per_channel(preds: torch.Tensor, target: torch.Tensor, sigma_n_sq: float) -> torch.Tensor:
    """VIF of single-channel images ``(N, H, W)``: one score an image."""
    dtype = preds.dtype
    preds = preds[:, None]
    target = target[:, None]
    n_img = preds.shape[0]
    eps = float(torch.tensor(1e-10, dtype=dtype))  # the JAX package's float32 constants
    sigma_n_sq = float(torch.tensor(sigma_n_sq, dtype=dtype))
    zero = torch.zeros((), dtype=dtype, device=preds.device)
    preds_vif = torch.zeros(n_img, dtype=dtype, device=preds.device)
    target_vif = torch.zeros(n_img, dtype=dtype, device=preds.device)
    for scale in range(4):
        n = 2.0 ** (4 - scale) + 1
        kernel = _filter(n, n / 5, dtype=dtype, device=preds.device)[None, None, :]
        if scale > 0:
            target, preds = conv2d(torch.cat([target, preds]), kernel)[:, :, ::2, ::2].split(n_img)
        moments = torch.cat([target, preds, target**2, preds**2, target * preds])
        mu_target, mu_preds, target_sq, preds_sq, target_preds = conv2d(moments, kernel).split(n_img)
        del moments
        mu_target_sq = mu_target**2
        mu_preds_sq = mu_preds**2
        mu_target_preds = mu_target * mu_preds
        sigma_target_sq = torch.clamp(target_sq - mu_target_sq, min=0.0)
        sigma_preds_sq = torch.clamp(preds_sq - mu_preds_sq, min=0.0)
        sigma_target_preds = target_preds - mu_target_preds

        g = sigma_target_preds / (sigma_target_sq + eps)
        sigma_v_sq = sigma_preds_sq - g * sigma_target_preds

        mask = sigma_target_sq < eps
        g = torch.where(mask, zero, g)
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        sigma_target_sq = torch.where(mask, zero, sigma_target_sq)
        mask = sigma_preds_sq < eps
        g = torch.where(mask, zero, g)
        sigma_v_sq = torch.where(mask, zero, sigma_v_sq)
        mask = g < 0
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        g = torch.where(mask, zero, g)
        sigma_v_sq = torch.clamp(sigma_v_sq, min=eps)

        preds_term = torch.log10(1.0 + (g**2.0) * sigma_target_sq / (sigma_v_sq + sigma_n_sq))
        target_term = torch.log10(1.0 + sigma_target_sq / sigma_n_sq)
        preds_vif = preds_vif + preds_term.sum((1, 2, 3), dtype=torch.float64).to(dtype)
        target_vif = target_vif + target_term.sum((1, 2, 3), dtype=torch.float64).to(dtype)
    return preds_vif / target_vif


def _vif_scores(preds: torch.Tensor, target: torch.Tensor, sigma_n_sq: float) -> torch.Tensor:
    """One score an image: the channels' VIF, averaged over the channels."""
    batch, channels = preds.shape[:2]
    per_channel = _vif_per_channel(preds.transpose(0, 1).reshape(batch * channels, *preds.shape[2:]),
                                   target.transpose(0, 1).reshape(batch * channels, *target.shape[2:]), sigma_n_sq)
    per_channel = per_channel.reshape(channels, batch)
    return per_channel.mean(0) if channels > 1 else per_channel[0]


def _check_vif_size(preds: torch.Tensor, target: torch.Tensor) -> None:
    """VIF's four dyadic scales need images of at least 41x41."""
    if preds.shape[-2] < 41 or preds.shape[-1] < 41:
        raise ValueError(f"Invalid size of preds. Expected at least 41x41, but got {preds.shape[-2]}x{preds.shape[-1]}!")
    if target.shape[-2] < 41 or target.shape[-1] < 41:
        raise ValueError(
            f"Invalid size of target. Expected at least 41x41, but got {target.shape[-2]}x{target.shape[-1]}!"
        )


def visual_information_fidelity(preds, target, sigma_n_sq: float = 2.0, reduction: str = "mean") -> torch.Tensor:
    """VIF: the information the distorted image keeps of the reference. Inputs must be
    at least 41x41 (four dyadic scales).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import visual_information_fidelity
        >>> preds = (torch.arange(3 * 48 * 48, dtype=torch.float32).reshape(1, 3, 48, 48) * 37 % 97) / 97
        >>> target = (torch.arange(3 * 48 * 48, dtype=torch.float32).reshape(1, 3, 48, 48) * 31 % 89) / 89
        >>> visual_information_fidelity(preds, target)
        tensor(0.0013)
    """
    preds = _jax_tensor(preds).to(torch.float32)
    target = _jax_tensor(target).to(torch.float32)
    _check_vif_size(preds, target)
    if reduction not in ("mean", "none"):
        raise ValueError(f"Argument `reduction` must be one of ['mean', 'none'], got {reduction}")
    score = _vif_scores(preds, target, sigma_n_sq)
    return torch.mean(score) if reduction == "mean" else score
