"""Perceptual Path Length (counterpart of
``torchmetrics_tpu/functional/image/perceptual_path_length.py``).

PPL probes a latent-space generator: interpolate latent pairs epsilon apart, generate
both endpoints, and score the perceptual distance / epsilon^2 with quantile filtering.
The similarity network is LPIPS (converted weights required offline) or any callable
``(img1, img2) -> (N,)``; the generator is the user's (an ``nn.Module`` or any object
with ``sample(num_samples)`` and ``__call__(z[, labels])``). Everything runs on
``device`` (CUDA when None): the latents, the generator's images, the resize (the
antialiased bilinear of ``jax.image.resize``), the similarity and the quantile filter,
whose mask stays on the device. Conditional labels are drawn from
``np.random.default_rng(seed)`` as the JAX package draws them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from ...utilities.checks import resolve_device
from ...utilities.data import _jax_dtype
from ._resize import resize_bilinear_antialias
from .utils import _ieee_float32


class GeneratorType:
    """Protocol for PPL generators: ``sample(num_samples) -> (N, z)`` latents and a
    forward producing images scaled to [0, 255]; ``num_classes`` when conditional."""

    @property
    def num_classes(self) -> int:
        raise NotImplementedError

    def sample(self, num_samples: int):
        raise NotImplementedError


def _validate_generator_model(generator, conditional: bool = False) -> None:
    if not hasattr(generator, "sample"):
        raise NotImplementedError(
            "The generator must have a `sample` method with signature `sample(num_samples: int) -> Tensor` where the"
            " returned tensor has shape `(num_samples, z_size)`."
        )
    if not callable(generator.sample):
        raise ValueError("The generator's `sample` method must be callable.")
    if conditional and not hasattr(generator, "num_classes"):
        raise AttributeError("The generator must have a `num_classes` attribute when `conditional=True`.")
    if conditional and not isinstance(generator.num_classes, int):
        raise ValueError("The generator's `num_classes` attribute must be an integer when `conditional=True`.")


def _perceptual_path_length_validate_arguments(
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 128,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
) -> None:
    if not (isinstance(num_samples, int) and num_samples > 0):
        raise ValueError(f"Argument `num_samples` must be a positive integer, but got {num_samples}.")
    if not isinstance(conditional, bool):
        raise ValueError(f"Argument `conditional` must be a boolean, but got {conditional}.")
    if not (isinstance(batch_size, int) and batch_size > 0):
        raise ValueError(f"Argument `batch_size` must be a positive integer, but got {batch_size}.")
    if interpolation_method not in ["lerp", "slerp_any", "slerp_unit"]:
        raise ValueError(
            f"Argument `interpolation_method` must be one of 'lerp', 'slerp_any', 'slerp_unit',"
            f"got {interpolation_method}."
        )
    if not (isinstance(epsilon, float) and epsilon > 0):
        raise ValueError(f"Argument `epsilon` must be a positive float, but got {epsilon}.")
    if resize is not None and not (isinstance(resize, int) and resize > 0):
        raise ValueError(f"Argument `resize` must be a positive integer or `None`, but got {resize}.")
    if lower_discard is not None and not (isinstance(lower_discard, float) and 0 <= lower_discard <= 1):
        raise ValueError(
            f"Argument `lower_discard` must be a float between 0 and 1 or `None`, but got {lower_discard}."
        )
    if upper_discard is not None and not (isinstance(upper_discard, float) and 0 <= upper_discard <= 1):
        raise ValueError(
            f"Argument `upper_discard` must be a float between 0 and 1 or `None`, but got {upper_discard}."
        )


def _interpolate(latents1: torch.Tensor, latents2: torch.Tensor, epsilon: float = 1e-4,
                 interpolation_method: str = "lerp") -> torch.Tensor:
    """Step of size epsilon along the latent path (torch-fidelity noise semantics)."""
    eps = 1e-7
    if latents1.shape != latents2.shape:
        raise ValueError("Latents must have the same shape.")
    if interpolation_method == "lerp":
        return latents1 + (latents2 - latents1) * epsilon
    if interpolation_method == "slerp_any":
        raw_norm1 = torch.linalg.vector_norm(latents1, dim=-1, keepdim=True)
        raw_norm2 = torch.linalg.vector_norm(latents2, dim=-1, keepdim=True)
        l1n = latents1 / raw_norm1.clamp(min=eps)
        l2n = latents2 / raw_norm2.clamp(min=eps)
        d = (l1n * l2n).sum(dim=-1, keepdim=True)
        # degenerate (zero-norm) or collinear pairs fall back to lerp
        mask = (raw_norm1 < eps) | (raw_norm2 < eps) | (d > 1 - eps) | (d < -1 + eps)
        omega = torch.arccos(d.clamp(-1, 1))
        denom = torch.sin(omega).clamp(min=eps)
        out = (torch.sin((1 - epsilon) * omega) / denom) * latents1 + (torch.sin(epsilon * omega) / denom) * latents2
        return torch.where(mask, _interpolate(latents1, latents2, epsilon, "lerp"), out)
    if interpolation_method == "slerp_unit":
        out = _interpolate(latents1, latents2, epsilon, "slerp_any")
        return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp(min=eps)
    raise ValueError(
        f"Interpolation method {interpolation_method} not supported. Choose from 'lerp', 'slerp_any', 'slerp_unit'."
    )


def _similarity(sim_net: Union[Callable, str], sim_net_weights_path: Optional[str], device: torch.device) -> Callable:
    if callable(sim_net) and not isinstance(sim_net, str):
        return sim_net
    if sim_net in ("alex", "vgg", "squeeze"):
        from .lpips import _cached_network

        if sim_net_weights_path is None:
            raise ModuleNotFoundError(
                "PPL's default LPIPS similarity needs converted pretrained weights, which cannot "
                "be downloaded in an air-gapped environment. Convert them offline with "
                "`convert_lpips_weights` and pass `sim_net_weights_path`, or pass a custom "
                "similarity callable as `sim_net`."
            )
        return _cached_network(sim_net, True, sim_net_weights_path, device)
    raise ValueError(f"sim_net must be a callable or one of 'alex', 'vgg', 'squeeze', got {sim_net}")


def _device_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """A generator's output as ``jnp.asarray`` gives it (float64 rounds to float32), on
    ``device``."""
    return _jax_dtype(torch.as_tensor(value, device=device))


def perceptual_path_length(
    generator,
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 64,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    sim_net: Union[Callable, str] = "vgg",
    sim_net_weights_path: Optional[str] = None,
    seed: int = 0,
    device: Optional[Any] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""PPL = E[D(G(I(z1,z2,t)), G(I(z1,z2,t+eps))) / eps^2] with quantile filtering.

    ``sim_net`` is a net-type string (LPIPS; converted weights required offline via
    ``sim_net_weights_path``) or any callable ``(img1, img2) -> (N,)`` over images in
    [-1, 1]. Runs on ``device`` (CUDA when None); conditional labels (int64) come from
    ``np.random.default_rng(seed)``.
    """
    device = resolve_device(device)
    _perceptual_path_length_validate_arguments(
        num_samples, conditional, batch_size, interpolation_method, epsilon, resize, lower_discard, upper_discard
    )
    _validate_generator_model(generator, conditional)
    net = _similarity(sim_net, sim_net_weights_path, device)

    with torch.no_grad():
        latent1 = _device_tensor(generator.sample(num_samples), device)
        latent2 = _device_tensor(generator.sample(num_samples), device)
        latent2 = _interpolate(latent1, latent2, epsilon, interpolation_method=interpolation_method)
        if conditional:
            labels = torch.as_tensor(np.random.default_rng(seed).integers(0, generator.num_classes, num_samples),
                                     device=device)

        distances = []
        for batch_idx in range(math.ceil(num_samples / batch_size)):
            sl = slice(batch_idx * batch_size, (batch_idx + 1) * batch_size)
            z = torch.cat([latent1[sl], latent2[sl]], dim=0)
            if conditional:
                outputs = _device_tensor(generator(z, torch.cat([labels[sl], labels[sl]], dim=0)), device)
            else:
                outputs = _device_tensor(generator(z), device)
            out1, out2 = torch.chunk(outputs, 2, dim=0)
            # generator domain [0, 255] -> similarity domain [-1, 1]
            out1 = 2 * (out1 / 255) - 1
            out2 = 2 * (out2 / 255) - 1
            if resize is not None:
                with _ieee_float32():
                    out1 = resize_bilinear_antialias(out1, (resize, resize))
                    out2 = resize_bilinear_antialias(out2, (resize, resize))
            distances.append(_device_tensor(net(out1, out2), device) / epsilon**2)
        dist = torch.cat(distances)
    mean, std = _quantile_filtered_stats(dist, lower_discard, upper_discard)
    return mean, std, dist


def _quantile_filtered_stats(dist: torch.Tensor, lower_discard: Optional[float],
                             upper_discard: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and (unbiased) std of the distances between the two quantiles (linear, as
    ``jnp.quantile``), by a mask on the device: no host read."""
    lower = torch.quantile(dist, lower_discard) if lower_discard is not None else dist.min()
    upper = torch.quantile(dist, upper_discard) if upper_discard is not None else dist.max()
    keep = (dist >= lower) & (dist <= upper)
    count = keep.sum().to(dist.dtype)
    mean = torch.where(keep, dist, 0).sum() / count
    std = torch.sqrt((torch.where(keep, dist - mean, 0) ** 2).sum() / (count - 1))
    return mean, std
