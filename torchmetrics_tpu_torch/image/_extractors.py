"""InceptionV3 pool3 feature extractor (counterpart of
``torchmetrics_tpu/image/_extractors.py``).

The trunk is an ``nn.Module`` with the JAX package's block structure (``_inception_a``
to ``_inception_e`` and ``_inception_forward``). BatchNorm is folded into the conv
weights once at load, in float32, and the folded weights are then cast to the trunk's
dtype once. Every 1x7 and 7x1 conv (26 per forward, Mixed_6b-6e and Mixed_7a) runs the
hand-written ``sepconv7`` kernel; every other conv is ``F.conv2d``, as the JAX package
leaves those to XLA's ``lax.conv``.

Parameters load from the pickle that ``convert_torchvision_inception_weights`` (below;
the JAX package's converter writes the same file) makes from a torchvision
``inception_v3`` state dict (raw ``{w, scale, bias, mean, var}`` or folded ``{w, b}``
leaves, numpy arrays), from such a pytree directly (``from_numpy_params``), or from a
random init seeded with ``seed``.
"""

from __future__ import annotations

import contextlib
import math
import pickle
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..functional.image._resize import resize_bilinear_antialias, resize_bilinear_tf1
from ..kernels.sepconv import sepconv7, sepconv7_rows
from ..utilities.checks import resolve_device
from ..utilities.data import _batched

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SEP_AXIS = {(1, 7): "W", (7, 1): "H"}  # the kernel's axis for each separable kernel shape
_BN_EPS = 1e-3

Params = Dict[str, Any]


def _fold_bn(params: Params) -> Params:
    """Fold inference BN into the conv weights: ``relu(conv(x, w)*inv + s)`` ==
    ``relu(conv(x, w*inv) + s)``, computed in float32 (numpy, on the host)."""

    def fold(p):
        if isinstance(p, dict) and "b" in p:  # already folded
            return {"w": np.asarray(p["w"], np.float32), "b": np.asarray(p["b"], np.float32)}
        if isinstance(p, dict) and "w" in p:
            inv = (np.asarray(p["scale"], np.float32) / np.sqrt(np.asarray(p["var"], np.float32) + _BN_EPS))
            inv = inv.astype(np.float32)
            w = np.asarray(p["w"], np.float32) * inv[:, None, None, None]
            b = (np.asarray(p["bias"], np.float32) - np.asarray(p["mean"], np.float32) * inv).astype(np.float32)
            return {"w": w, "b": b}
        return {k: fold(v) for k, v in p.items()}

    return fold(params)


class BasicConv2d(nn.Module):
    """Conv with BN folded into ``(w, b)``, then ReLU. A stride-1 "SAME" 1x7 or 7x1 conv
    runs the ``sepconv7`` kernel; any other conv runs ``F.conv2d``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, stride: int = 1, valid: bool = False) -> None:
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)
        self.stride = stride
        self.padding: Union[str, int] = 0 if valid else "same"
        same_stride1 = stride == 1 and not valid
        self.sep_axis = _SEP_AXIS.get(tuple(w.shape[2:])) if same_stride1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sep_axis is not None:
            # under the serving engine's vmap the rows fold into one launch (sepconv7_rows);
            # outside it the direct call, whose CPU reference FlopCounterMode sees (the
            # op's dispatch would hide it)
            conv = sepconv7_rows if _batched(x) else sepconv7
            y = conv(x, self.w.flatten(2), self.sep_axis)
        else:
            y = F.conv2d(x, self.w, stride=self.stride, padding=self.padding)
        return F.relu(y + self.b[None, :, None, None])


def _convs(p: Params, to: Callable[[np.ndarray], torch.Tensor], strided=(), valid=()) -> nn.ModuleDict:
    """One ``BasicConv2d`` per leaf of a block's folded params; ``strided`` convs are
    stride 2 "VALID", ``valid`` convs stride 1 "VALID", the rest stride 1 "SAME"."""
    return nn.ModuleDict({
        k: BasicConv2d(to(v["w"]), to(v["b"]), stride=2 if k in strided else 1, valid=k in strided or k in valid)
        for k, v in p.items()
    })


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avgpool(x: torch.Tensor) -> torch.Tensor:
    # count_include_pad semantics (torchvision inception): a constant 1/9 divisor
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, p: Params, to) -> None:
        super().__init__()
        self.c = _convs(p, to)

    def forward(self, x):
        c = self.c
        b1 = c["b1"](x)
        b5 = c["b5_2"](c["b5_1"](x))
        b3 = c["b3_3"](c["b3_2"](c["b3_1"](x)))
        bp = c["pool"](_avgpool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, p: Params, to) -> None:
        super().__init__()
        self.c = _convs(p, to, strided=("b3", "b3d_3"))

    def forward(self, x):
        c = self.c
        b3 = c["b3"](x)
        b3d = c["b3d_3"](c["b3d_2"](c["b3d_1"](x)))
        return torch.cat([b3, b3d, _maxpool(x)], dim=1)


class InceptionC(nn.Module):
    """Mixed_6b-6e: three 1x7 and three 7x1 convs at 17x17, all run by ``sepconv7``."""

    def __init__(self, p: Params, to) -> None:
        super().__init__()
        self.c = _convs(p, to)

    def forward(self, x):
        c = self.c
        b1 = c["b1"](x)
        b7 = c["b7_3"](c["b7_2"](c["b7_1"](x)))
        b7d = x
        for key in ("b7d_1", "b7d_2", "b7d_3", "b7d_4", "b7d_5"):
            b7d = c[key](b7d)
        bp = c["pool"](_avgpool(x))
        return torch.cat([b1, b7, b7d, bp], dim=1)


class InceptionD(nn.Module):
    """Mixed_7a: one 1x7 and one 7x1 conv at 17x17, run by ``sepconv7``."""

    def __init__(self, p: Params, to) -> None:
        super().__init__()
        self.c = _convs(p, to, strided=("b3_2", "b7_4"))

    def forward(self, x):
        c = self.c
        b3 = c["b3_2"](c["b3_1"](x))
        b7 = x
        for key in ("b7_1", "b7_2", "b7_3", "b7_4"):
            b7 = c[key](b7)
        return torch.cat([b3, b7, _maxpool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, p: Params, to) -> None:
        super().__init__()
        self.c = _convs(p, to)

    def forward(self, x):
        c = self.c
        b1 = c["b1"](x)
        b3 = c["b3_1"](x)
        b3 = torch.cat([c["b3_2a"](b3), c["b3_2b"](b3)], dim=1)
        b3d = c["b3d_2"](c["b3d_1"](x))
        b3d = torch.cat([c["b3d_3a"](b3d), c["b3d_3b"](b3d)], dim=1)
        bp = c["pool"](_avgpool(x))
        return torch.cat([b1, b3, b3d, bp], dim=1)


_BLOCKS = (
    ("mixed_a1", InceptionA), ("mixed_a2", InceptionA), ("mixed_a3", InceptionA),
    ("mixed_b", InceptionB),
    ("mixed_c1", InceptionC), ("mixed_c2", InceptionC), ("mixed_c3", InceptionC), ("mixed_c4", InceptionC),
    ("mixed_d", InceptionD),
    ("mixed_e1", InceptionE), ("mixed_e2", InceptionE),
)
_STEM = ("stem1", "stem2", "stem3", "stem4", "stem5")


class InceptionV3Features(nn.Module):
    """InceptionV3 pool3 features ``(N, 2048)`` in float32.

    ``compute_dtype``: ``"float32"`` (the parity trunk, the counterpart of
    ``Precision.HIGHEST``: cuDNN's convs run with TF32 off, and ``sepconv7`` splits each
    operand into two TF32 parts to keep f32 accuracy) or ``"bfloat16"``; the global average pool
    accumulates in float32 either way. ``resize_antialias`` picks the resize fork for
    inputs that are not 299x299. ``device=None`` means ``"cuda"``.

    Input: NCHW images, integers on the 0-255 scale or floats in [0, 1]; with
    ``normalize=True`` floats are first quantized to uint8 levels.
    """

    num_features = 2048
    accepts_normalize = True

    def __init__(
        self,
        weights_path: Optional[str] = None,
        seed: int = 0,
        compute_dtype: str = "float32",
        resize_antialias: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        if weights_path is not None:
            with open(weights_path, "rb") as f:  # a pickle convert_torchvision_inception_weights wrote
                params = pickle.load(f)
        else:
            params = self._random_params(seed)
        self._build(params, compute_dtype, resize_antialias, dev)

    @classmethod
    def from_numpy_params(
        cls,
        params: Params,
        compute_dtype: str = "float32",
        resize_antialias: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "InceptionV3Features":
        """Build the trunk from a JAX-package parameter pytree of numpy arrays, raw
        (``{w, scale, bias, mean, var}``) or BN-folded (``{w, b}``)."""
        extractor = cls.__new__(cls)
        nn.Module.__init__(extractor)
        extractor._build(params, compute_dtype, resize_antialias, resolve_device(device))
        return extractor

    def _build(self, params: Params, compute_dtype: str, resize_antialias: bool, dev: torch.device) -> None:
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        self.compute_dtype = _DTYPES[compute_dtype]
        self.resize_antialias = resize_antialias
        folded = _fold_bn(params)

        def to(a: np.ndarray) -> torch.Tensor:  # folded in f32, cast to the trunk dtype once
            return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device=dev, dtype=self.compute_dtype)

        self.stem = _convs(
            {k: folded[k] for k in _STEM}, to, strided=("stem1",), valid=("stem2", "stem4", "stem5")
        )
        self.blocks = nn.ModuleDict({name: block(folded[name], to) for name, block in _BLOCKS})

    @property
    def device(self) -> torch.device:
        return self.stem["stem1"].w.device

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        # torch-fidelity trunk normalization: (x - 128)/128 on the 0-255 scale
        x = (x - 128.0) / 128.0
        s = self.stem
        x = _maxpool(s["stem3"](s["stem2"](s["stem1"](x))))
        x = _maxpool(s["stem5"](s["stem4"](x)))
        for block in self.blocks.values():
            x = block(x)
        return x.float().mean(dim=(2, 3))  # global average pool, f32 accumulation

    def forward(self, imgs: Any, normalize: bool = False) -> torch.Tensor:
        imgs = torch.as_tensor(imgs, device=self.device)
        if normalize:  # [0,1] floats quantize to uint8 levels
            imgs = (imgs * 255).to(torch.uint8)
        # integers are on the 0-255 scale already; floats in [0, 1] are scaled up
        imgs = imgs.float() * 255.0 if imgs.is_floating_point() else imgs.float()
        if tuple(imgs.shape[-2:]) != (299, 299):
            # resize in f32 whatever the trunk dtype: resize parity keeps FID comparable
            resize = resize_bilinear_antialias if self.resize_antialias else resize_bilinear_tf1
            imgs = resize(imgs, (299, 299))
        precision = (
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
            if self.compute_dtype == torch.float32
            else contextlib.nullcontext()
        )
        with torch.no_grad(), precision:
            return self._trunk(imgs.to(self.compute_dtype))

    # ---------------------------------------------------------------- params

    @staticmethod
    def _random_params(seed: int) -> Params:
        """Random raw params (identity BN) with the trunk's shapes, from ``torch.Generator``.
        The draws differ from the JAX package's ``jax.random`` init for the same seed."""
        gen = torch.Generator().manual_seed(seed)

        def cp(c_in, c_out, kh, kw):
            w = torch.randn((c_out, c_in, kh, kw), generator=gen) / math.sqrt(c_in * kh * kw)
            ones, zeros = np.ones(c_out, np.float32), np.zeros(c_out, np.float32)
            return {"w": w.numpy(), "scale": ones, "bias": zeros, "mean": zeros, "var": ones}

        def block_a(c_in, pool_features):
            return {
                "b1": cp(c_in, 64, 1, 1), "b5_1": cp(c_in, 48, 1, 1), "b5_2": cp(48, 64, 5, 5),
                "b3_1": cp(c_in, 64, 1, 1), "b3_2": cp(64, 96, 3, 3), "b3_3": cp(96, 96, 3, 3),
                "pool": cp(c_in, pool_features, 1, 1),
            }

        def block_c(c_in, c7):
            return {
                "b1": cp(c_in, 192, 1, 1),
                "b7_1": cp(c_in, c7, 1, 1), "b7_2": cp(c7, c7, 1, 7), "b7_3": cp(c7, 192, 7, 1),
                "b7d_1": cp(c_in, c7, 1, 1), "b7d_2": cp(c7, c7, 7, 1), "b7d_3": cp(c7, c7, 1, 7),
                "b7d_4": cp(c7, c7, 7, 1), "b7d_5": cp(c7, 192, 1, 7),
                "pool": cp(c_in, 192, 1, 1),
            }

        def block_e(c_in):
            return {
                "b1": cp(c_in, 320, 1, 1),
                "b3_1": cp(c_in, 384, 1, 1), "b3_2a": cp(384, 384, 1, 3), "b3_2b": cp(384, 384, 3, 1),
                "b3d_1": cp(c_in, 448, 1, 1), "b3d_2": cp(448, 384, 3, 3),
                "b3d_3a": cp(384, 384, 1, 3), "b3d_3b": cp(384, 384, 3, 1),
                "pool": cp(c_in, 192, 1, 1),
            }

        return {
            "stem1": cp(3, 32, 3, 3), "stem2": cp(32, 32, 3, 3), "stem3": cp(32, 64, 3, 3),
            "stem4": cp(64, 80, 1, 1), "stem5": cp(80, 192, 3, 3),
            "mixed_a1": block_a(192, 32), "mixed_a2": block_a(256, 64), "mixed_a3": block_a(288, 64),
            "mixed_b": {
                "b3": cp(288, 384, 3, 3), "b3d_1": cp(288, 64, 1, 1),
                "b3d_2": cp(64, 96, 3, 3), "b3d_3": cp(96, 96, 3, 3),
            },
            "mixed_c1": block_c(768, 128), "mixed_c2": block_c(768, 160),
            "mixed_c3": block_c(768, 160), "mixed_c4": block_c(768, 192),
            "mixed_d": {
                "b3_1": cp(768, 192, 1, 1), "b3_2": cp(192, 320, 3, 3),
                "b7_1": cp(768, 192, 1, 1), "b7_2": cp(192, 192, 1, 7),
                "b7_3": cp(192, 192, 7, 1), "b7_4": cp(192, 192, 3, 3),
            },
            "mixed_e1": block_e(1280), "mixed_e2": block_e(2048),
        }


def convert_torchvision_inception_weights(state_dict: Dict[str, Any], out_path: str) -> None:
    """Convert a torchvision ``inception_v3`` state dict (tensors or numpy arrays) into
    the pickle of numpy arrays that ``InceptionV3Features(weights_path=...)`` loads. It
    needs numpy and pickle only; run it where the torchvision weights are."""

    def conv(prefix):
        return {
            "w": np.asarray(state_dict[f"{prefix}.conv.weight"]),
            "scale": np.asarray(state_dict[f"{prefix}.bn.weight"]),
            "bias": np.asarray(state_dict[f"{prefix}.bn.bias"]),
            "mean": np.asarray(state_dict[f"{prefix}.bn.running_mean"]),
            "var": np.asarray(state_dict[f"{prefix}.bn.running_var"]),
        }

    params = {
        "stem1": conv("Conv2d_1a_3x3"),
        "stem2": conv("Conv2d_2a_3x3"),
        "stem3": conv("Conv2d_2b_3x3"),
        "stem4": conv("Conv2d_3b_1x1"),
        "stem5": conv("Conv2d_4a_3x3"),
    }
    for i, name in enumerate(("Mixed_5b", "Mixed_5c", "Mixed_5d"), start=1):
        params[f"mixed_a{i}"] = {
            "b1": conv(f"{name}.branch1x1"),
            "b5_1": conv(f"{name}.branch5x5_1"),
            "b5_2": conv(f"{name}.branch5x5_2"),
            "b3_1": conv(f"{name}.branch3x3dbl_1"),
            "b3_2": conv(f"{name}.branch3x3dbl_2"),
            "b3_3": conv(f"{name}.branch3x3dbl_3"),
            "pool": conv(f"{name}.branch_pool"),
        }
    params["mixed_b"] = {
        "b3": conv("Mixed_6a.branch3x3"),
        "b3d_1": conv("Mixed_6a.branch3x3dbl_1"),
        "b3d_2": conv("Mixed_6a.branch3x3dbl_2"),
        "b3d_3": conv("Mixed_6a.branch3x3dbl_3"),
    }
    for i, name in enumerate(("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"), start=1):
        params[f"mixed_c{i}"] = {
            "b1": conv(f"{name}.branch1x1"),
            "b7_1": conv(f"{name}.branch7x7_1"),
            "b7_2": conv(f"{name}.branch7x7_2"),
            "b7_3": conv(f"{name}.branch7x7_3"),
            "b7d_1": conv(f"{name}.branch7x7dbl_1"),
            "b7d_2": conv(f"{name}.branch7x7dbl_2"),
            "b7d_3": conv(f"{name}.branch7x7dbl_3"),
            "b7d_4": conv(f"{name}.branch7x7dbl_4"),
            "b7d_5": conv(f"{name}.branch7x7dbl_5"),
            "pool": conv(f"{name}.branch_pool"),
        }
    params["mixed_d"] = {
        "b3_1": conv("Mixed_7a.branch3x3_1"),
        "b3_2": conv("Mixed_7a.branch3x3_2"),
        "b7_1": conv("Mixed_7a.branch7x7x3_1"),
        "b7_2": conv("Mixed_7a.branch7x7x3_2"),
        "b7_3": conv("Mixed_7a.branch7x7x3_3"),
        "b7_4": conv("Mixed_7a.branch7x7x3_4"),
    }
    for i, name in enumerate(("Mixed_7b", "Mixed_7c"), start=1):
        params[f"mixed_e{i}"] = {
            "b1": conv(f"{name}.branch1x1"),
            "b3_1": conv(f"{name}.branch3x3_1"),
            "b3_2a": conv(f"{name}.branch3x3_2a"),
            "b3_2b": conv(f"{name}.branch3x3_2b"),
            "b3d_1": conv(f"{name}.branch3x3dbl_1"),
            "b3d_2": conv(f"{name}.branch3x3dbl_2"),
            "b3d_3a": conv(f"{name}.branch3x3dbl_3a"),
            "b3d_3b": conv(f"{name}.branch3x3dbl_3b"),
            "pool": conv(f"{name}.branch_pool"),
        }
    with open(out_path, "wb") as f:
        pickle.dump(params, f)


def resolve_feature_extractor(
    feature: Any,
    normalize: bool,
    input_img_size: Tuple[int, int, int] = (3, 299, 299),
    weights_path: Optional[str] = None,
    antialias: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Callable, int, bool]:
    """``feature: int | callable`` resolution: the int 2048 selects the in-tree
    InceptionV3 (converted weights required), any callable is used as-is.
    Returns (extractor, num_features, used_custom)."""
    if isinstance(feature, int):
        if feature != 2048:
            raise ValueError(
                "The in-tree InceptionV3 extractor exposes the 2048-d pool3 features; "
                f"got feature={feature}. Pass a custom callable for other dimensions."
            )
        if weights_path is None:
            raise ModuleNotFoundError(
                "The integer `feature` selector needs converted InceptionV3 weights. Convert them offline "
                "with `torchmetrics_tpu_torch.image.convert_torchvision_inception_weights` and pass "
                "`feature_extractor_weights_path`, "
                "or pass an extractor callable (e.g. `InceptionV3Features()` for random-weight throughput tests)."
            )
        return InceptionV3Features(weights_path, resize_antialias=antialias, device=device), 2048, False
    if callable(feature):
        num_features = getattr(feature, "num_features", None)
        if num_features is None:
            dtype = torch.float32 if normalize else torch.uint8
            num_features = int(feature(torch.zeros((1, *input_img_size), dtype=dtype, device=device)).shape[-1])
        return feature, int(num_features), True
    raise TypeError("Got unknown input to argument `feature`")
