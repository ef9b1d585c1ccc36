"""Frechet Inception Distance (counterpart of ``torchmetrics_tpu/image/generative.py``,
``FrechetInceptionDistance`` only; KID, IS and MiFID are not ported yet).

The state is the feature sum, the feature cross-product sum and the sample count, for
real and for fake images, accumulated in float32 on the metric's device. The final
Gaussian algebra runs in numpy float64 on the host.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ..metric import Metric
from ._extractors import resolve_feature_extractor

_SIDES = ("real", "fake")


def _extract_features(extractor: Any, imgs: torch.Tensor, quantize: bool) -> torch.Tensor:
    """Run the extractor; one that advertises ``accepts_normalize`` quantizes [0, 1]
    floats to uint8 levels itself, for any other the metric does it here."""
    if getattr(extractor, "accepts_normalize", False):
        return extractor(imgs, normalize=quantize)
    if quantize:
        imgs = (imgs * 255).to(torch.uint8)
    return extractor(imgs)


def _compute_fid(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """Frechet distance between two Gaussians (eigenvalue form, f64 host)."""
    a = float(((mu1 - mu2) ** 2).sum())
    b = float(np.trace(sigma1) + np.trace(sigma2))
    eigvals = np.linalg.eigvals(sigma1 @ sigma2)
    c = float(np.sqrt(eigvals.astype(np.complex128)).real.sum())
    return a + b - 2 * c


class FrechetInceptionDistance(Metric):
    """FID. ``feature`` is the int 2048 (the in-tree InceptionV3; converted weights
    required) or any callable ``imgs -> (N, F)``, e.g. ``InceptionV3Features(...)``.

    ``update(imgs, real)`` takes raw NCHW images, which go through the extractor inside
    the update; with ``normalize=True`` float images in [0, 1] are quantized to uint8
    levels first.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance
        >>> def tiny_extractor(imgs):
        ...     return imgs.reshape(imgs.shape[0], -1)[:, :8].float()
        >>> metric = FrechetInceptionDistance(feature=tiny_extractor, normalize=True, device="cpu")
        >>> imgs_real = (torch.arange(2 * 3 * 16 * 16, dtype=torch.float32).reshape(2, 3, 16, 16) * 37 % 97) / 97
        >>> imgs_fake = (torch.arange(2 * 3 * 16 * 16, dtype=torch.float32).reshape(2, 3, 16, 16) * 31 % 89) / 89
        >>> metric.update(imgs_real, real=True)
        >>> metric.update(imgs_fake, real=False)
        >>> round(float(metric.compute()), 4)
        1.4741
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[int, Any] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        input_img_size: Tuple[int, int, int] = (3, 299, 299),
        feature_extractor_weights_path: Optional[str] = None,
        antialias: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.antialias = antialias
        self.inception, num_features, self.used_custom_model = resolve_feature_extractor(
            feature, normalize, input_img_size,
            weights_path=feature_extractor_weights_path, antialias=antialias, device=self.device,
        )
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        self.num_features = num_features
        for side in _SIDES:
            self.add_state(f"{side}_features_sum", torch.zeros(num_features), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_cov_sum", torch.zeros(num_features, num_features), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_num_samples", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _batch_state(self, imgs: torch.Tensor, real: bool):
        features = _extract_features(self.inception, imgs, self.normalize and not self.used_custom_model)
        f = features.float().to(self.device)
        # full f32 product: torch.matmul does not use TF32 unless a caller enables it
        stats = {
            "features_sum": f.sum(dim=0),
            "features_cov_sum": f.T @ f,
            "features_num_samples": torch.tensor(f.shape[0], dtype=torch.int32, device=self.device),
        }
        this, other = _SIDES if bool(real) else _SIDES[::-1]
        out = {f"{this}_{k}": v for k, v in stats.items()}
        out.update({f"{other}_{k}": torch.zeros_like(v) for k, v in stats.items()})
        return out

    def _compute(self, state):
        n_real = int(state["real_features_num_samples"])
        n_fake = int(state["fake_features_num_samples"])
        if n_real < 2 or n_fake < 2:
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")
        host = {k: state[k].double().cpu().numpy() for k in ("real_features_sum", "fake_features_sum",
                                                            "real_features_cov_sum", "fake_features_cov_sum")}
        mean_real = host["real_features_sum"] / n_real
        mean_fake = host["fake_features_sum"] / n_fake
        cov_real = (host["real_features_cov_sum"] - n_real * np.outer(mean_real, mean_real)) / (n_real - 1)
        cov_fake = (host["fake_features_cov_sum"] - n_fake * np.outer(mean_fake, mean_fake)) / (n_fake - 1)
        value = _compute_fid(mean_real, cov_real, mean_fake, cov_fake)
        return torch.tensor(value, dtype=torch.float32, device=self.device)

    def reset(self) -> None:
        keep = {}
        if not self.reset_real_features:
            keep = {k: v for k, v in self._state.items() if k.startswith("real_")}
        super().reset()
        self._state.update(keep)

    def to(self, device: Union[str, torch.device]) -> "FrechetInceptionDistance":
        super().to(device)
        if isinstance(self.inception, torch.nn.Module):
            self.inception.to(self.device)
        return self
