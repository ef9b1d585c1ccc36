"""ARNIQA, no-reference image quality (counterpart of
``torchmetrics_tpu/functional/image/arniqa.py``).

The whole model is in the port: the ResNet-50 encoder (``image/_resnet.py``) on the
image and on its antialiased bilinear half-scale copy, ImageNet normalisation, the
L2-normalised features (norms clipped at 1e-12) concatenated and fed to a linear
regressor, the score rescaled to [0, 1] by the regressor dataset's MOS range. It runs on
the images' device (CUDA for host values), convolutions and products with TF32 off.
Only the trained weights are external: ``encoder_weights``/``regressor_weights`` (a
path, a state dict or a module) or the torch-hub cache the reference downloads into
(``$TORCH_HOME/hub/checkpoints/ARNIQA.pth`` and ``regressor_<dataset>.pth``); with
neither the call gates with the JAX package's error. A ``scorer`` callable bypasses the
model. Loaded weights are cached per source and device.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ...utilities.data import _jax_dtype
from ._resize import resize_bilinear_antialias
from .utils import _ieee_float32, _image_device

_REGRESSOR_DATASETS = {"kadid10k": (1.0, 5.0), "koniq10k": (1.0, 100.0)}
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _hub_checkpoint(name: str) -> Optional[str]:
    base = os.path.expanduser(os.environ.get("TORCH_HOME", "~/.cache/torch"))
    path = os.path.join(base, "hub", "checkpoints", name)
    return path if os.path.exists(path) else None


_PARAM_CACHE: Dict = {}


def _to_state_dict(source: Any) -> Dict:
    if isinstance(source, (str, os.PathLike)):
        source = torch.load(source, map_location="cpu", weights_only=False)
    if hasattr(source, "state_dict"):
        source = source.state_dict()
    return dict(source)


def _load_arniqa_params(
    regressor_dataset: str,
    encoder_weights: Optional[Any],
    regressor_weights: Optional[Any],
    device: torch.device,
) -> Tuple[torch.nn.Module, torch.Tensor, torch.Tensor]:
    """The encoder on ``device`` and the regressor's ``(1, 4096)`` weight and ``(1,)``
    bias there; cached for path sources, the hub cache's resolved paths included, so a
    change of ``TORCH_HOME`` reaches another checkpoint or the gate."""
    from ...image._resnet import convert_resnet50_state_dict, resnet50_from_state_dict

    if encoder_weights is None:
        encoder_weights = _hub_checkpoint("ARNIQA.pth")
    if regressor_weights is None:
        regressor_weights = _hub_checkpoint(f"regressor_{regressor_dataset}.pth")
    if encoder_weights is None or regressor_weights is None:
        raise ModuleNotFoundError(
            "ARNIQA's pretrained weights are not in the torch-hub cache and this "
            "environment has no network egress to download them. Fetch ARNIQA.pth and "
            f"regressor_{regressor_dataset}.pth offline into ~/.cache/torch/hub/checkpoints, "
            "pass `encoder_weights`/`regressor_weights`, or pass a custom `scorer` callable."
        )
    sources = (encoder_weights, regressor_weights)
    hashable = all(isinstance(w, (str, os.PathLike)) for w in sources)
    cache_key = (regressor_dataset, *map(os.fspath, sources), device) if hashable else None
    if cache_key is not None and cache_key in _PARAM_CACHE:
        return _PARAM_CACHE[cache_key]
    enc_sd = _to_state_dict(encoder_weights)
    reg_sd = _to_state_dict(regressor_weights)
    # published checkpoint: keys prefixed "model.", SimCLR projector dropped
    enc_sd = {k.replace("model.", ""): v for k, v in enc_sd.items() if "projector" not in k}
    model = resnet50_from_state_dict(convert_resnet50_state_dict(enc_sd), device)

    def tensor(value: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(value, np.float32)).to(device)

    w = tensor(reg_sd.get("weight", reg_sd.get("weights"))).reshape(1, -1)
    b = tensor(reg_sd.get("bias", reg_sd.get("biases"))).reshape(1)
    out = (model, w, b)
    if cache_key is not None:
        _PARAM_CACHE[cache_key] = out
    return out


def _arniqa_forward(
    img: torch.Tensor,
    model: torch.nn.Module,
    w: torch.Tensor,
    b: torch.Tensor,
    regressor_dataset: str,
    normalize: bool,
) -> torch.Tensor:
    h, width = img.shape[-2:]
    with _ieee_float32():
        img_ds = resize_bilinear_antialias(img, (h // 2, width // 2))
        if normalize:
            mean = torch.as_tensor(_IMAGENET_MEAN, device=img.device)[None, :, None, None]
            std = torch.as_tensor(_IMAGENET_STD, device=img.device)[None, :, None, None]
            img = (img - mean) / std
            img_ds = (img_ds - mean) / std
        f_full = model(img)
        f_half = model(img_ds)
        f_full = f_full / torch.linalg.vector_norm(f_full, dim=1, keepdim=True).clamp(min=1e-12)
        f_half = f_half / torch.linalg.vector_norm(f_half, dim=1, keepdim=True).clamp(min=1e-12)
        score = torch.cat([f_full, f_half], dim=1) @ w.T + b
    lo, hi = _REGRESSOR_DATASETS[regressor_dataset]
    return ((score - lo) / (hi - lo)).reshape(-1)


def arniqa(
    img,
    regressor_dataset: str = "koniq10k",
    reduction: str = "mean",
    normalize: bool = True,
    autocast: bool = False,
    scorer: Optional[Callable] = None,
    encoder_weights: Optional[Any] = None,
    regressor_weights: Optional[Any] = None,
) -> torch.Tensor:
    """ARNIQA quality score in [0, 1] for ``(N, 3, H, W)`` images (NCHW, [0, 1]
    when ``normalize=True``, else already ImageNet-normalised).

    ``scorer`` (``imgs -> (N,)``) bypasses the in-tree model; otherwise weights
    resolve from ``encoder_weights``/``regressor_weights`` (path, state_dict or
    module) or the torch-hub cache. ``autocast`` is accepted and unused, as in the JAX
    package.
    """
    if not isinstance(normalize, bool):
        raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
    if regressor_dataset not in _REGRESSOR_DATASETS:
        raise ValueError(
            f"Argument `regressor_dataset` must be one of ('kadid10k', 'koniq10k'), but got {regressor_dataset}"
        )
    if reduction not in ("mean", "sum", "none", None):
        raise ValueError(f"Argument `reduction` must be one of ('mean', 'sum', 'none', None), but got {reduction}")
    device = _image_device(img)
    img = _jax_dtype(torch.as_tensor(img, device=device))
    if img.ndim == 3:
        img = img[None]
    if scorer is not None:
        scores = _jax_dtype(torch.as_tensor(scorer(img), device=device))
    else:
        model, w, b = _load_arniqa_params(regressor_dataset, encoder_weights, regressor_weights, device)
        scores = _arniqa_forward(img, model, w, b, regressor_dataset, normalize)
    if reduction == "mean":
        return scores.mean()
    if reduction == "sum":
        return scores.sum()
    return scores
