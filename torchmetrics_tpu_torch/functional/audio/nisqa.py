"""NISQA v2.0, Non-Intrusive Speech Quality Assessment (counterpart of
``torchmetrics_tpu/functional/audio/nisqa.py``).

- The amplitude mel spectrogram in float64 torch ops on the device of the input:
  librosa semantics, a centred reflect-padded STFT with a ``win_length``-sample Hann
  window zero-padded to ``n_fft``, the Slaney mel filterbank and a per-sample
  ``amplitude_to_db`` with an 80 dB floor.
- Overlapping spectrogram segments, zero-padded to ``ms_max_segments``.
- The model as an ``nn.Module`` whose parameter names are the published checkpoint's
  ``model_state_dict`` keys, so ``torch.load(path, weights_only=True)`` of one
  ``nisqa.tar`` feeds both packages: a per-window adaptive CNN (conv, batch norm and
  ReLU six times, adaptive max pools), a self-attention encoder over the windows and
  five attention-pooling heads giving [MOS, noisiness, discontinuity, coloration,
  loudness]. It runs on the valid windows only (the JAX package runs the padding too
  and masks it out of the attention and the pooling, which gives the same values) and
  with TF32 off in cuDNN and cuBLAS for the call.

Only the trained checkpoint is external: it is read from
``~/.torchmetrics/NISQA/nisqa.tar`` or an explicit ``checkpoint_path``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...utilities.checks import _as_tensor
from ..image.utils import _ieee_float32, _pad, conv2d
from ...utilities.data import _device_constant
from .dnsmos import mel_filterbank

NISQA_DIR = "~/.torchmetrics/NISQA"
_HEADS = 5


def _centred_hann(n_fft: int, win: int) -> np.ndarray:
    """A periodic Hann window of ``win`` samples centred in ``n_fft`` zeros."""
    window = np.zeros(n_fft)
    start = (n_fft - win) // 2
    window[start : start + win] = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
    return window


def _melspec_amplitude(y: torch.Tensor, sr: int, args: Dict[str, Any]) -> torch.Tensor:
    """(B, T) -> (B, n_mels, frames) float32 amplitude mel spectrogram, librosa
    semantics: power 1, hann(win_length) centred in n_fft, reflect padding, Slaney mel
    with its norm and the ``ms_fmax`` cap, per-sample ``amplitude_to_db(ref=1.0,
    amin=1e-4, top_db=80)``."""
    n_fft = int(args["ms_n_fft"])
    hop = int(sr * args["ms_hop_length"])
    win = int(sr * args["ms_win_length"])
    pad = n_fft // 2
    x = _pad(y.to(torch.float64), ((pad, pad),), "reflect")
    frames = x.unfold(-1, n_fft, hop) * _device_constant(_centred_hann, x.device, n_fft, win)
    mag = torch.fft.rfft(frames, dim=-1).abs().transpose(1, 2)  # (B, bins, F)
    fb = _device_constant(mel_filterbank, x.device, sr, n_fft, int(args["ms_n_mels"]), 0.0, args["ms_fmax"])
    mel = torch.matmul(fb, mag)  # amplitude (power 1)
    db = 20.0 * torch.log10(mel.clamp(min=1e-4))
    floor = db.amax(dim=(1, 2), keepdim=True) - 80.0
    return torch.maximum(db, floor).to(torch.float32)


def _segment_specs(spec: torch.Tensor, args: Dict[str, Any]) -> Tuple[torch.Tensor, int]:
    """(B, n_mels, frames) -> ((B, max_segments, n_mels, seg_length) overlapping windows,
    zero past the valid ones; the number of valid windows)."""
    seg_length = int(args["ms_seg_length"])
    seg_hop = int(args["ms_seg_hop_length"])
    max_length = int(args["ms_max_segments"])
    n_wins = spec.shape[2] - (seg_length - 1)
    if n_wins < 1:
        raise RuntimeError("Input signal is too short.")
    windows = spec.unfold(2, seg_length, seg_hop).transpose(1, 2)  # (B, W, n_mels, seg)
    n_wins = math.ceil(n_wins / seg_hop)
    if max_length < n_wins:
        raise RuntimeError("Maximum number of mel spectrogram windows exceeded. Use shorter audio.")
    out = spec.new_zeros((spec.shape[0], max_length, spec.shape[1], seg_length))
    out[:, :n_wins] = windows
    return out, n_wins


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, layer.weight.T) + layer.bias


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * norm.weight + norm.bias


class _AdaptCNN(nn.Module):
    """Conv, batch norm (running statistics, folded as the JAX package folds them) and
    ReLU six times with adaptive max pools: ``(N, 1, n_mels, seg)`` -> ``(N, c_out_3 *
    pool_3[0])``."""

    def __init__(self, args: Dict[str, Any]) -> None:
        super().__init__()
        kernel = tuple(args["cnn_kernel_size"])
        c1, c2, c3 = int(args["cnn_c_out_1"]), int(args["cnn_c_out_2"]), int(args["cnn_c_out_3"])
        self.pad = (1, 0) if kernel[0] == 1 else (1, 1)
        self.pools = [tuple(args["cnn_pool_1"]), tuple(args["cnn_pool_2"]), tuple(args["cnn_pool_3"])]
        shapes = [(1, c1, kernel), (c1, c2, kernel), (c2, c3, kernel), (c3, c3, kernel), (c3, c3, kernel),
                  (c3, c3, (kernel[0], self.pools[2][1]))]
        for i, (cin, cout, size) in enumerate(shapes, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, size))
            setattr(self, f"bn{i}", nn.BatchNorm2d(cout))

    def _block(self, i: int, x: torch.Tensor, pad) -> torch.Tensor:
        conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
        x = torch.nn.functional.pad(x, (pad[1], pad[1], pad[0], pad[0]))
        out = conv2d(x, conv.weight) + conv.bias[None, :, None, None]
        inv = bn.weight / torch.sqrt(bn.running_var + 1e-5)
        out = out * inv[None, :, None, None] + (bn.bias - bn.running_mean * inv)[None, :, None, None]
        return out.clamp(min=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = torch.nn.functional.adaptive_max_pool2d
        x = pool(self._block(1, x, self.pad), self.pools[0])
        x = pool(self._block(2, x, self.pad), self.pools[1])
        x = self._block(4, self._block(3, x, self.pad), self.pad)
        x = pool(x, self.pools[2])
        x = self._block(6, self._block(5, x, self.pad), (1, 0))  # kernel (k, pool_3[1]) collapses the width
        return x.reshape(x.shape[0], -1)


class _Framewise(nn.Module):
    def __init__(self, args: Dict[str, Any]) -> None:
        super().__init__()
        self.model = _AdaptCNN(args)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, hidden: int) -> None:
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, hidden)
        self.linear2 = nn.Linear(hidden, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.nhead = nhead

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        """Multi-head self-attention over (B, L, E) in the packed in_proj layout, the
        scores scaled after the product, as in the JAX package."""
        b, length, e = x.shape
        head = e // self.nhead
        qkv = torch.matmul(x, self.self_attn.in_proj_weight.T) + self.self_attn.in_proj_bias
        q, k, v = (t.reshape(b, length, self.nhead, head).transpose(1, 2) for t in qkv.split(e, dim=-1))
        scores = torch.matmul(q, k.transpose(2, 3)) / math.sqrt(head)
        out = torch.matmul(scores.softmax(dim=-1), v).transpose(1, 2).reshape(b, length, e)
        return _linear(self.self_attn.out_proj, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _layer_norm(self.norm1, x + self._attention(x))
        ff = _linear(self.linear2, _linear(self.linear1, x).clamp(min=0))
        return _layer_norm(self.norm2, x + ff)


class _SelfAttention(nn.Module):
    def __init__(self, args: Dict[str, Any], input_size: int) -> None:
        super().__init__()
        d_model = int(args["td_sa_d_model"])
        self.linear = nn.Linear(input_size, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.layers = nn.ModuleList(
            _SelfAttentionLayer(d_model, int(args["td_sa_nhead"]), int(args["td_sa_h"]))
            for _ in range(int(args["td_sa_num_layers"]))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _layer_norm(self.norm1, _linear(self.linear, x))
        for layer in self.layers:
            x = layer(x)
        return x


class _TimeDependency(nn.Module):
    def __init__(self, args: Dict[str, Any], input_size: int) -> None:
        super().__init__()
        self.model = _SelfAttention(args, input_size)


class _PoolAttFF(nn.Module):
    """Attention pooling head: (B, L, d_model) -> (B, 1)."""

    def __init__(self, d_model: int, hidden: int) -> None:
        super().__init__()
        self.linear1 = nn.Linear(d_model, hidden)
        self.linear2 = nn.Linear(hidden, 1)
        self.linear3 = nn.Linear(d_model, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = _linear(self.linear2, _linear(self.linear1, x).clamp(min=0))[..., 0].softmax(dim=-1)
        pooled = torch.matmul(att[:, None, :], x)[:, 0]
        return _linear(self.linear3, pooled)


class _Pooling(nn.Module):
    def __init__(self, d_model: int, hidden: int) -> None:
        super().__init__()
        self.model = _PoolAttFF(d_model, hidden)


class NISQAModel(nn.Module):
    """NISQA-DIM over ``(B, max_segments, n_mels, seg)`` segments and the number of
    valid windows: ``(B, 5)`` [mos, noi, dis, col, loud]. Built from a checkpoint's
    ``args``; its ``state_dict`` keys are the published ``model_state_dict``'s."""

    def __init__(self, args: Dict[str, Any]) -> None:
        super().__init__()
        self.cnn = _Framewise(args)
        features = int(args["cnn_c_out_3"]) * int(tuple(args["cnn_pool_3"])[0])
        self.time_dependency = _TimeDependency(args, features)
        d_model = int(args["td_sa_d_model"])
        self.pool_layers = nn.ModuleList(_Pooling(d_model, int(args["pool_att_h"])) for _ in range(_HEADS))

    @torch.no_grad()
    def forward(self, segments: torch.Tensor, n_wins: int) -> torch.Tensor:
        with _ieee_float32():
            b = segments.shape[0]
            valid = segments[:, :n_wins]
            feats = self.cnn.model(valid.reshape(b * n_wins, 1, *valid.shape[2:])).reshape(b, n_wins, -1)
            enc = self.time_dependency.model(feats)
            return torch.cat([pool.model(enc) for pool in self.pool_layers], dim=1)


def nisqa_state_dict_from_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's NISQA parameter tree (arrays as numpy) as this module's state
    dict: one entry per leaf, the batch-norm statistics included (``num_batches_tracked``
    is 0, which the model does not read)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, value) -> None:
        sd[key] = torch.from_numpy(np.array(value))

    for i in range(1, 7):
        p = params["cnn"][f"conv{i}"]
        put(f"cnn.model.conv{i}.weight", p["w"])
        put(f"cnn.model.conv{i}.bias", p["b"])
        for name, key in (("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            put(f"cnn.model.bn{i}.{name}", p[key])
        sd[f"cnn.model.bn{i}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    td = params["td"]
    for name in ("linear", "norm1"):
        put(f"time_dependency.model.{name}.weight", td[name]["w"])
        put(f"time_dependency.model.{name}.bias", td[name]["b"])
    for i, layer in enumerate(td["layers"]):
        pre = f"time_dependency.model.layers.{i}"
        put(f"{pre}.self_attn.in_proj_weight", layer["self_attn"]["in_w"])
        put(f"{pre}.self_attn.in_proj_bias", layer["self_attn"]["in_b"])
        put(f"{pre}.self_attn.out_proj.weight", layer["self_attn"]["out_w"])
        put(f"{pre}.self_attn.out_proj.bias", layer["self_attn"]["out_b"])
        for name in ("linear1", "linear2", "norm1", "norm2"):
            put(f"{pre}.{name}.weight", layer[name]["w"])
            put(f"{pre}.{name}.bias", layer[name]["b"])
    for i, head in enumerate(params["pool"]):
        for name in ("linear1", "linear2", "linear3"):
            put(f"pool_layers.{i}.model.{name}.weight", head[name]["w"])
            put(f"pool_layers.{i}.model.{name}.bias", head[name]["b"])
    return sd


def resolve_checkpoint_path(checkpoint_path: Optional[str]) -> str:
    """Where the nisqa.tar checkpoint lives."""
    return os.path.expanduser(checkpoint_path or os.path.join(NISQA_DIR, "nisqa.tar"))


def ensure_checkpoint_exists(checkpoint_path: Optional[str]) -> str:
    """The construction- and load-time gate (one copy of the error text)."""
    path = resolve_checkpoint_path(checkpoint_path)
    if not os.path.exists(path):
        raise ModuleNotFoundError(
            f"NISQA checkpoint {path!r} not found and this environment has no network "
            "egress to download it. Fetch the published nisqa.tar offline into "
            f"{NISQA_DIR} or pass `checkpoint_path=`."
        )
    return path


_MODEL_CACHE: Dict[Tuple[str, str], Tuple[NISQAModel, Dict[str, Any]]] = {}


def _load_nisqa_checkpoint(checkpoint_path: Optional[str], device: torch.device) -> Tuple[NISQAModel, Dict[str, Any]]:
    """The model of a checkpoint on ``device`` and its args, cached by path and device.
    Every parameter and statistic of the model must be in the checkpoint's
    ``model_state_dict``; keys the model does not hold are ignored, as the JAX
    package's converter ignores them."""
    path = ensure_checkpoint_exists(checkpoint_path)
    key = (path, str(device))
    if key not in _MODEL_CACHE:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        args = dict(ckpt["args"])
        model = NISQAModel(args)
        missing, _ = model.load_state_dict(ckpt["model_state_dict"], strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing:
            raise KeyError(f"NISQA checkpoint {path!r} lacks {missing}")
        _MODEL_CACHE[key] = (model.eval().to(device), args)
    return _MODEL_CACHE[key]


def non_intrusive_speech_quality_assessment(preds, fs: int, checkpoint_path: Optional[str] = None) -> torch.Tensor:
    """NISQA scores ``(..., 5)`` = [MOS, noisiness, discontinuity, coloration, loudness],
    float32 on the input's device. ``checkpoint_path`` loads the published ``nisqa.tar``
    from a custom location."""
    if not isinstance(fs, int) or fs <= 0:
        raise ValueError(f"Argument `fs` expected to be a positive integer, but got {fs}")
    arr = _as_tensor(preds).to(torch.float32)
    model, args = _load_nisqa_checkpoint(checkpoint_path, arr.device)
    x = arr.reshape(-1, arr.shape[-1])
    segments, n_wins = _segment_specs(_melspec_amplitude(x, fs, args), args)
    return model(segments, n_wins).reshape(*arr.shape[:-1], _HEADS)
