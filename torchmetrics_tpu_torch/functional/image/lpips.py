"""LPIPS (counterpart of ``torchmetrics_tpu/functional/image/lpips.py``; Zhang et al.,
CVPR 2018).

The backbone feature stacks (AlexNet, VGG16 and SqueezeNet-1.1 trunks) are the JAX
package's declarative layer specs, run by one interpreter: scaling layer, backbone taps,
unit normalisation with eps inside the square root, squared difference, 1x1 heads,
spatial mean and the sum over taps. ``LPIPSNetwork`` is an ``nn.Module``; its
convolutions are cuDNN's with TF32 off in the forward and in the backward
(``utils.conv2d_full``), its max pools ``VALID`` windows, and the two images of a pair
go through the backbone as one batch. A gradient reaches the inputs through autograd.

Weights load from the JAX package's own pickle (``convert_lpips_weights`` there and
here write the same bytes, numpy arrays), so a converted file serves both packages.
``pretrained=False`` draws the JAX package's shapes and scale laws from
``torch.Generator(seed)``: not the JAX package's draws, which come from
``jax.random`` (a divergence kept on purpose; parity is tested on shared weights).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .utils import _image_device, conv2d_full

# torchvision `features` layer specs: (kind, *args). Conv = (c_in, c_out, k, stride, pad)
_ALEX_SPEC = [
    ("conv", 3, 64, 11, 4, 2), ("relu",), ("maxpool", 3, 2),
    ("conv", 64, 192, 5, 1, 2), ("relu",), ("maxpool", 3, 2),
    ("conv", 192, 384, 3, 1, 1), ("relu",),
    ("conv", 384, 256, 3, 1, 1), ("relu",),
    ("conv", 256, 256, 3, 1, 1), ("relu",),
]
_ALEX_TAPS = (2, 5, 8, 10, 12)  # slice end indices -> relu1..relu5
_ALEX_CHNS = (64, 192, 384, 256, 256)

_VGG_SPEC = (
    [("conv", 3, 64, 3, 1, 1), ("relu",), ("conv", 64, 64, 3, 1, 1), ("relu",), ("maxpool", 2, 2)]
    + [("conv", 64, 128, 3, 1, 1), ("relu",), ("conv", 128, 128, 3, 1, 1), ("relu",), ("maxpool", 2, 2)]
    + [("conv", 128, 256, 3, 1, 1), ("relu",), ("conv", 256, 256, 3, 1, 1), ("relu",),
       ("conv", 256, 256, 3, 1, 1), ("relu",), ("maxpool", 2, 2)]
    + [("conv", 256, 512, 3, 1, 1), ("relu",), ("conv", 512, 512, 3, 1, 1), ("relu",),
       ("conv", 512, 512, 3, 1, 1), ("relu",), ("maxpool", 2, 2)]
    + [("conv", 512, 512, 3, 1, 1), ("relu",), ("conv", 512, 512, 3, 1, 1), ("relu",),
       ("conv", 512, 512, 3, 1, 1), ("relu",)]
)
_VGG_TAPS = (4, 9, 16, 23, 30)
_VGG_CHNS = (64, 128, 256, 512, 512)

_SQUEEZE_SPEC = (
    [("conv", 3, 64, 3, 2, 0), ("relu",), ("maxpool", 3, 2),
     ("fire", 64, 16, 64, 64), ("fire", 128, 16, 64, 64), ("maxpool", 3, 2),
     ("fire", 128, 32, 128, 128), ("fire", 256, 32, 128, 128), ("maxpool", 3, 2),
     ("fire", 256, 48, 192, 192), ("fire", 384, 48, 192, 192),
     ("fire", 384, 64, 256, 256), ("fire", 512, 64, 256, 256)]
)
_SQUEEZE_TAPS = (2, 5, 8, 10, 11, 12, 13)
_SQUEEZE_CHNS = (64, 128, 256, 384, 384, 512, 512)

_NETS = {
    "alex": (_ALEX_SPEC, _ALEX_TAPS, _ALEX_CHNS),
    "vgg": (_VGG_SPEC, _VGG_TAPS, _VGG_CHNS),
    "squeeze": (_SQUEEZE_SPEC, _SQUEEZE_TAPS, _SQUEEZE_CHNS),
}

_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


class _Leaf(nn.Module):
    """One layer's arrays as float32 buffers, named as in the pickle (``w``, ``b``,
    ``sq_w``, ...)."""

    def __init__(self, arrays: Mapping[str, Any]) -> None:
        super().__init__()
        for name, value in arrays.items():
            self.register_buffer(name, torch.from_numpy(np.array(value, np.float32)))


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    return conv2d_full(x, w, b, stride=stride, padding=pad)


def _backbone_forward(spec: Sequence[tuple], params: nn.ModuleList, taps: Sequence[int],
                      x: torch.Tensor) -> List[torch.Tensor]:
    """The outputs of ``spec`` at ``taps`` (a tap is the number of layers run)."""
    feats = []
    for idx, layer in enumerate(spec):
        kind, p = layer[0], params[idx]
        if kind == "conv":
            x = _conv(x, p.w, p.b, layer[4], layer[5])
        elif kind == "relu":
            x = F.relu(x)
        elif kind == "maxpool":
            x = F.max_pool2d(x, layer[1], layer[2])
        elif kind == "fire":
            s = F.relu(_conv(x, p.sq_w, p.sq_b, 1, 0))
            x = torch.cat([F.relu(_conv(s, p.e1_w, p.e1_b, 1, 0)), F.relu(_conv(s, p.e3_w, p.e3_b, 1, 1))], dim=1)
        if idx + 1 in taps:
            feats.append(x)
    return feats


def _normalize_tensor(feat: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return feat / torch.sqrt(eps + torch.sum(feat**2, dim=1, keepdim=True))


def _random_backbone(spec: Sequence[tuple], generator: torch.Generator) -> List[Dict[str, torch.Tensor]]:
    """The JAX package's scale laws: weights ``N(0, 1) / sqrt(fan_in)``, zero biases."""

    def normal(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    backbone: List[Dict[str, torch.Tensor]] = []
    for layer in spec:
        if layer[0] == "conv":
            _, c_in, c_out, k, _, _ = layer
            backbone.append({"w": normal(c_out, c_in, k, k) / np.sqrt(c_in * k * k), "b": torch.zeros(c_out)})
        elif layer[0] == "fire":
            _, c_in, sq, e1, e3 = layer
            backbone.append({
                "sq_w": normal(sq, c_in, 1, 1) / np.sqrt(c_in), "sq_b": torch.zeros(sq),
                "e1_w": normal(e1, sq, 1, 1) / np.sqrt(sq), "e1_b": torch.zeros(e1),
                "e3_w": normal(e3, sq, 3, 3) / np.sqrt(sq * 9), "e3_b": torch.zeros(e3),
            })
        else:
            backbone.append({})
    return backbone


class LPIPSNetwork(nn.Module):
    """LPIPS scorer: scaling layer -> backbone taps -> unit-normalise -> squared diff ->
    1x1 linear heads -> spatial average -> layer sum. ``(N, 3, H, W)`` pairs in
    ``[-1, 1]`` (``normalize=True``: in ``[0, 1]``) give ``(N,)`` distances."""

    def __init__(
        self,
        net_type: str = "alex",
        pretrained: bool = True,
        weights_path: Optional[str] = None,
        seed: int = 0,
    ) -> None:
        super().__init__()
        if net_type not in _NETS:
            raise ValueError(f"Argument `net_type` must be one of {list(_NETS)}, but got {net_type}")
        self.net_type = net_type
        self.spec, self.taps, self.chns = _NETS[net_type]
        if pretrained:
            if weights_path is None:
                raise ModuleNotFoundError(
                    "Pretrained LPIPS weights are not bundled and cannot be downloaded in an "
                    "air-gapped environment. Convert them offline with "
                    "`convert_lpips_weights` and pass `weights_path`, or use `pretrained=False` "
                    "(random backbone — machinery only)."
                )
            with open(weights_path, "rb") as f:
                payload = pickle.load(f)
            backbone, lins = payload["backbone"], payload["lins"]
        else:
            generator = torch.Generator().manual_seed(seed)
            backbone = _random_backbone(self.spec, generator)
            lins = [{"w": torch.randn((1, c, 1, 1), generator=generator).abs() / np.sqrt(c)} for c in self.chns]
        self.backbone = nn.ModuleList([_Leaf(p) for p in backbone])
        self.lins = nn.ModuleList([_Leaf(p) for p in lins])
        self.register_buffer("shift", torch.as_tensor(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.as_tensor(_SCALE)[None, :, None, None])
        self.eval()

    def forward(self, img1: torch.Tensor, img2: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        img1 = torch.as_tensor(img1, device=self.shift.device).to(torch.float32)
        img2 = torch.as_tensor(img2, device=self.shift.device).to(torch.float32)
        if normalize:  # inputs in [0, 1] -> [-1, 1]
            img1 = 2 * img1 - 1
            img2 = 2 * img2 - 1
        n = img1.shape[0]
        feats = _backbone_forward(self.spec, self.backbone, self.taps, (torch.cat([img1, img2]) - self.shift) / self.scale)
        res = torch.zeros(n, device=img1.device)
        for f, lin in zip(feats, self.lins):
            diff = (_normalize_tensor(f[:n]) - _normalize_tensor(f[n:])) ** 2
            res = res + conv2d_full(diff, lin.w).mean(dim=(2, 3))[:, 0]
        return res


def convert_lpips_weights(backbone_state_dict: Dict, lpips_state_dict: Dict, net_type: str, out_path: str) -> None:
    """Convert torchvision ``<net>.features`` + reference ``lpips_models/<net>.pth``
    state_dicts into the pickle ``LPIPSNetwork`` loads, the JAX package's format byte
    for byte (numpy arrays)."""
    spec, _, chns = _NETS[net_type]
    backbone = []
    tv_idx = 0
    for layer in spec:
        if layer[0] == "conv":
            backbone.append({
                "w": np.asarray(backbone_state_dict[f"{tv_idx}.weight"]),
                "b": np.asarray(backbone_state_dict[f"{tv_idx}.bias"]),
            })
        elif layer[0] == "fire":
            backbone.append({
                "sq_w": np.asarray(backbone_state_dict[f"{tv_idx}.squeeze.weight"]),
                "sq_b": np.asarray(backbone_state_dict[f"{tv_idx}.squeeze.bias"]),
                "e1_w": np.asarray(backbone_state_dict[f"{tv_idx}.expand1x1.weight"]),
                "e1_b": np.asarray(backbone_state_dict[f"{tv_idx}.expand1x1.bias"]),
                "e3_w": np.asarray(backbone_state_dict[f"{tv_idx}.expand3x3.weight"]),
                "e3_b": np.asarray(backbone_state_dict[f"{tv_idx}.expand3x3.bias"]),
            })
        else:
            backbone.append({})
        if layer[0] in ("conv", "relu", "maxpool", "fire"):
            tv_idx += 1
    lins = [{"w": np.asarray(lpips_state_dict[f"lin{i}.model.1.weight"])} for i in range(len(chns))]
    with open(out_path, "wb") as f:
        pickle.dump({"backbone": backbone, "lins": lins}, f)


_NET_CACHE: Dict[Tuple, LPIPSNetwork] = {}


def _cached_network(net_type: str, pretrained: bool, weights_path: Optional[str], device: torch.device) -> LPIPSNetwork:
    """One network per configuration and device: building one reads its weights."""
    key = (net_type, pretrained, weights_path, device)
    if key not in _NET_CACHE:
        _NET_CACHE[key] = LPIPSNetwork(net_type, pretrained=pretrained, weights_path=weights_path).to(device)
    return _NET_CACHE[key]


def learned_perceptual_image_patch_similarity(
    img1,
    img2,
    net_type: str = "alex",
    reduction: str = "mean",
    normalize: bool = False,
    weights_path: Optional[str] = None,
    pretrained: bool = True,
) -> torch.Tensor:
    """One-shot LPIPS between two image batches (see ``LPIPSNetwork``) on the images'
    device (CUDA for host values). The network is cached per configuration and
    device."""
    device = _image_device(img1)
    img1 = torch.as_tensor(img1, device=device)
    img2 = torch.as_tensor(img2, device=device)
    loss = _cached_network(net_type, pretrained, weights_path, device)(img1, img2, normalize=normalize)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"Argument `reduction` must be one of ['mean', 'sum'], but got {reduction}")
