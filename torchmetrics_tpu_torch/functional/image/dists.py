"""DISTS, Deep Image Structure and Texture Similarity (counterpart of
``torchmetrics_tpu/functional/image/dists.py``; Ding et al., 2020).

The VGG16 trunk of LPIPS's spec with L2 pooling in place of its max pools (the
``hanning(5)[1:-1]`` 3x3 window, depthwise, stride 2, pad 1, ``sqrt(x + 1e-12)``; the
batch folded into the channels as every depthwise window of the port), tapped at the
five relu stages plus the raw input; per-channel texture (mean) and structure
(covariance) similarities weighted by the learned alpha and beta. The spatial means are
float64 sums rounded once: ``E[xy] - E[x] E[y]`` cancels, and a float32 sum's order
would then decide the last bits. Convolutions are cuDNN's with TF32 off, in the
backward too.

Weights load from the JAX package's own pickle (``convert_dists_weights`` writes the
same bytes). ``pretrained=False`` draws LPIPS's VGG backbone and ``alpha``, ``beta`` ~
``0.1 + 0.01 N(0, 1)`` from ``torch.Generator(seed)``, not from ``jax.random`` as the
JAX package does (a divergence kept on purpose).
"""

from __future__ import annotations

import functools
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .lpips import _VGG_SPEC, _Leaf, _conv, _random_backbone
from .utils import _conv as _grouped_conv
from .utils import _image_device, _mean64, conv2d_full

_DISTS_CHNS = (3, 64, 128, 256, 512, 512)
_DISTS_TAPS = (4, 9, 16, 23, 30)  # vgg16.features indices after relu{1_2,2_2,3_3,4_3,5_3}
_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _l2pool_window(filter_size: int = 5) -> np.ndarray:
    a = np.hanning(filter_size)[1:-1]
    g = a[:, None] * a[None, :]
    return (g / g.sum()).astype(np.float32)


def _l2pool(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Stride 2, pad 1 (``(filter_size - 2) // 2`` of the 5-tap hanning)."""
    channels = x.shape[1]
    out = _grouped_conv(functools.partial(conv2d_full, stride=2, padding=1), x**2,
                        window.expand(channels, 1, *window.shape[-2:]), channels)
    return torch.sqrt(out + 1e-12)


class DISTSNetwork(nn.Module):
    """DISTS scorer with learned per-channel alpha/beta weights: ``(N, 3, H, W)`` pairs
    in ``[0, 1]`` give ``(N,)`` distances."""

    def __init__(self, pretrained: bool = True, weights_path: Optional[str] = None, seed: int = 0) -> None:
        super().__init__()
        if pretrained:
            if weights_path is None:
                raise ModuleNotFoundError(
                    "Pretrained DISTS weights (VGG backbone + alpha/beta) are not bundled and "
                    "cannot be downloaded in an air-gapped environment. Convert them offline with "
                    "`convert_dists_weights` and pass `weights_path`, or use `pretrained=False`."
                )
            with open(weights_path, "rb") as f:
                payload = pickle.load(f)
            backbone = payload["backbone"]
            alpha, beta = (torch.from_numpy(np.array(payload[k], np.float32)) for k in ("alpha", "beta"))
        else:
            generator = torch.Generator().manual_seed(seed)
            backbone = _random_backbone(_VGG_SPEC, generator)
            total = sum(_DISTS_CHNS)
            alpha, beta = (0.1 + 0.01 * torch.randn(total, generator=generator) for _ in range(2))
        self.backbone = nn.ModuleList([_Leaf(p) for p in backbone])
        self.register_buffer("alpha", alpha.reshape(1, -1))
        self.register_buffer("beta", beta.reshape(1, -1))
        self.register_buffer("mean", torch.as_tensor(_MEAN)[None, :, None, None])
        self.register_buffer("std", torch.as_tensor(_STD)[None, :, None, None])
        self.register_buffer("window", torch.as_tensor(_l2pool_window())[None, None])
        self.eval()

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """VGG16 stages with L2 pooling: ``[input, relu1_2, ..., relu5_3]``."""
        feats = [x]
        h = (x - self.mean) / self.std
        for idx, layer in enumerate(_VGG_SPEC):
            kind = layer[0]
            if kind == "conv":
                p = self.backbone[idx]
                h = _conv(h, p.w, p.b, layer[4], layer[5])
            elif kind == "relu":
                h = F.relu(h)
            elif kind == "maxpool":
                h = _l2pool(h, self.window)
            if idx + 1 in _DISTS_TAPS:
                feats.append(h)
        return feats

    def forward(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        device = self.alpha.device
        x = torch.as_tensor(preds, device=device).to(torch.float32)
        y = torch.as_tensor(target, device=device).to(torch.float32)
        n = x.shape[0]
        feats = self._features(torch.cat([x, y]))
        c1 = c2 = 1e-6
        w_sum = self.alpha.sum() + self.beta.sum()
        splits = np.cumsum(_DISTS_CHNS)[:-1].tolist()
        alphas = torch.tensor_split(self.alpha / w_sum, splits, dim=1)
        betas = torch.tensor_split(self.beta / w_sum, splits, dim=1)
        dist1 = torch.zeros(n, device=device)
        dist2 = torch.zeros(n, device=device)
        for k, f in enumerate(feats):
            f0, f1 = f[:n], f[n:]
            x_mean, y_mean = _mean64(f0, (2, 3)), _mean64(f1, (2, 3))
            s1 = (2 * x_mean * y_mean + c1) / (x_mean**2 + y_mean**2 + c1)
            dist1 = dist1 + (alphas[k] * s1).sum(dim=1)
            x_var = _mean64((f0 - x_mean[:, :, None, None]) ** 2, (2, 3))
            y_var = _mean64((f1 - y_mean[:, :, None, None]) ** 2, (2, 3))
            xy_cov = _mean64(f0 * f1, (2, 3)) - x_mean * y_mean
            s2 = (2 * xy_cov + c2) / (x_var + y_var + c2)
            dist2 = dist2 + (betas[k] * s2).sum(dim=1)
        return 1 - (dist1 + dist2)


def convert_dists_weights(vgg_features_state_dict: Dict, dists_state_dict: Dict, out_path: str) -> None:
    """Convert torchvision vgg16 ``features`` + the reference's ``dists_models/weights.pt``
    (alpha/beta) into the pickle ``DISTSNetwork`` loads, the JAX package's format byte
    for byte."""
    backbone = []
    for idx, layer in enumerate(_VGG_SPEC):
        if layer[0] == "conv":
            backbone.append({
                "w": np.asarray(vgg_features_state_dict[f"{idx}.weight"]),
                "b": np.asarray(vgg_features_state_dict[f"{idx}.bias"]),
            })
        else:
            backbone.append({})
    with open(out_path, "wb") as f:
        pickle.dump({
            "backbone": backbone,
            "alpha": np.asarray(dists_state_dict["alpha"]).reshape(-1),
            "beta": np.asarray(dists_state_dict["beta"]).reshape(-1),
        }, f)


_NET_CACHE: Dict[Tuple, DISTSNetwork] = {}


def deep_image_structure_and_texture_similarity(
    preds, target, reduction: Optional[str] = None,
    weights_path: Optional[str] = None, pretrained: bool = True,
) -> torch.Tensor:
    """DISTS between two NCHW image batches in [0, 1], on the images' device (CUDA for
    host values); the network is cached per configuration and device."""
    device = _image_device(preds)
    preds = torch.as_tensor(preds, device=device)
    target = torch.as_tensor(target, device=device)
    key = (pretrained, weights_path, device)
    if key not in _NET_CACHE:
        _NET_CACHE[key] = DISTSNetwork(pretrained=pretrained, weights_path=weights_path).to(device)
    scores = _NET_CACHE[key](preds, target)
    if reduction == "sum":
        return scores.sum()
    if reduction == "mean":
        return scores.mean()
    if reduction is None or reduction == "none":
        return scores
    raise ValueError(f"Argument `reduction` must be one of ('sum', 'mean', 'none', None), but got {reduction}")
