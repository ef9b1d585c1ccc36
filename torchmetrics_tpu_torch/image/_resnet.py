"""ResNet-50 feature trunk as an ``nn.Module`` (counterpart of
``torchmetrics_tpu/image/_resnet.py``), ARNIQA's encoder.

torchvision's ``resnet50`` layer for layer and by its parameter names: conv1 7x7/2, a
3x3/2 max pool padded with -inf, layers [3, 4, 6, 3] of expansion-4 bottlenecks with
the stride on the 3x3 conv, and a global mean over the last map. BatchNorm runs in
eval mode with eps 1e-5, folded as the JAX package folds it (``x * inv + (bias - mean *
inv)``, ``inv = weight / sqrt(var + eps)``). The convolutions are cuDNN's with TF32 off
for the forward (``functional/image/utils.py`` ``_ieee_float32``).

``convert_resnet50_state_dict`` takes torchvision's keys or the ``nn.Sequential``-indexed
keys of the published ARNIQA checkpoint and gives this module's ``state_dict``;
``resnet50_params_from_jax`` loads the JAX package's parameter tree (numpy arrays).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..functional.image.utils import _ieee_float32

_LAYERS = (3, 4, 6, 3)
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d, eps: float = 1e-5) -> torch.Tensor:
    inv = bn.weight / torch.sqrt(bn.running_var + eps)
    return x * inv[None, :, None, None] + (bn.bias - bn.running_mean * inv)[None, :, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, with a 1x1 projection where the shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                                            nn.BatchNorm2d(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_bn(F.conv2d(x, self.conv1.weight), self.bn1))
        out = F.relu(_bn(F.conv2d(out, self.conv2.weight, stride=self.stride, padding=1), self.bn2))
        out = _bn(F.conv2d(out, self.conv3.weight), self.bn3)
        if self.downsample is not None:
            x = _bn(F.conv2d(x, self.downsample[0].weight, stride=self.stride), self.downsample[1])
        return F.relu(out + x)


class ResNet50Features(nn.Module):
    """``(N, 3, H, W) -> (N, 2048)`` globally averaged trunk features (no ``fc``)."""

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), _LAYERS), start=1):
            stride = 1 if li == 1 else 2
            layer = [Bottleneck(inplanes, planes, stride)]
            inplanes = planes * 4
            layer += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{li}", nn.Sequential(*layer))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _ieee_float32():
            x = F.relu(_bn(F.conv2d(x, self.conv1.weight, stride=2, padding=3), self.bn1))
            x = F.max_pool2d(x, 3, 2, padding=1)
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            return x.mean(dim=(2, 3))


def convert_resnet50_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` with torchvision's names, or with the names an
    ``nn.Sequential``-wrapped encoder gives (``0`` conv1, ``1`` bn1, ``4..7``
    layer1..4), as ``ResNet50Features``'s ``state_dict`` (float32; ``fc`` and any other
    extra key dropped; a missing ``num_batches_tracked`` is 0)."""
    arrs = {k: v for k, v in sd.items()}
    if any(k.startswith("0.") for k in arrs):
        remap = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4"}
        arrs = {".".join([remap.get(k.split(".")[0], k.split(".")[0]), *k.split(".")[1:]]): v
                for k, v in arrs.items()}
    out: Dict[str, torch.Tensor] = {}
    with torch.device("meta"):
        layout = ResNet50Features().state_dict()
    for key, default in layout.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.tensor(np.asarray(arrs.get(key, 0)), dtype=torch.long)
        else:
            out[key] = torch.from_numpy(np.array(arrs[key], np.float32)).reshape(default.shape)
    return out


def resnet50_params_from_jax(params: Mapping[str, Any]) -> ResNet50Features:
    """The JAX package's ResNet-50 parameter tree (``convert_resnet50_state_dict``'s
    output there, leaves as numpy arrays) loaded into a ``ResNet50Features`` on the CPU."""
    sd: Dict[str, Any] = {"conv1.weight": params["conv1"]}
    sd.update({f"bn1.{k}": params["bn1"][k] for k in _BN_KEYS})
    for li in range(1, len(_LAYERS) + 1):
        for bi, block in enumerate(params[f"layer{li}"]):
            pre = f"layer{li}.{bi}"
            for j in (1, 2, 3):
                sd[f"{pre}.conv{j}.weight"] = block[f"conv{j}"]
                sd.update({f"{pre}.bn{j}.{k}": block[f"bn{j}"][k] for k in _BN_KEYS})
            if "downsample_conv" in block:
                sd[f"{pre}.downsample.0.weight"] = block["downsample_conv"]
                sd.update({f"{pre}.downsample.1.{k}": block["downsample_bn"][k] for k in _BN_KEYS})
    return resnet50_from_state_dict(convert_resnet50_state_dict(sd), torch.device("cpu"))


def resnet50_from_state_dict(sd: Mapping[str, torch.Tensor], device: torch.device) -> ResNet50Features:
    """A frozen ``ResNet50Features`` on ``device`` holding ``sd`` (no random
    initialisation)."""
    with torch.device("meta"):
        model = ResNet50Features()
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    return model.eval().requires_grad_(False)
