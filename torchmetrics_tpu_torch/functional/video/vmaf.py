"""VMAF, Video Multi-Method Assessment Fusion (counterpart of
``torchmetrics_tpu/functional/video/vmaf.py``).

Three paths, in the JAX package's order: the ``vmaf_torch`` wheel where it can be
imported (its own model), else a libvmaf-format model JSON given as ``model_path``
(the in-tree features below and a NuSVR fusion), else the JAX package's
``ModuleNotFoundError``. ``vmaf_features`` computes the features without a model.

The features are the JAX package's float pipelines over ``(B*F, H, W)`` luma frames,
on the device of the input:

- motion and motion2: the mean absolute difference of consecutive frames blurred by
  libvmaf's 5-tap filter; ``motion2[i] = min(motion[i], motion[i + 1])``;
- vif_scale0..3: Visual Information Fidelity with gaussian windows of 17, 9, 5 and 3
  taps (sd N/5), ``sigma_nsq = 2``, a blur and ``[::2, ::2]`` between scales;
- adm2 and adm_scale0..3: libvmaf's float ADM over a 4-level db2 DWT (band sizes
  ``(n + 1) // 2``, reflect-101 on the left edge and symmetric on the right), the
  1-degree decoupling, the Watson CSF steps, the 3 x 3 / 30 contrast mask, the 10%
  border crop, cube-root pooling and the ``(area / 32) ** (1 / 3)`` stabiliser.

The separable blurs are depthwise ``conv2d`` calls in float64 with edge padding, each
pass rounded once to float32. The DWT is the 4-tap form the JAX package's dense ``(n/2, n)`` matrices hold: each output
is four products of a gathered, reflected input, added in float32 by elementwise ops
(the same bits on the card and on the CPU), where the matrices do ``n`` multiply-adds an
output. The 3 x 3 mask sum is nine shifted slices added in order. Sums over a frame
accumulate in float64 and round once. The NuSVR runs in float64 on the device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...utilities.checks import _as_tensor
from ...utilities.data import _device_constant, _jax_dtype
from ...utilities.imports import _module_available
from ..image.utils import conv2d

_VMAF_TORCH_AVAILABLE = _module_available("vmaf_torch")

# libvmaf motion_tools FILTER_5 (gaussian, sd ~1.08)
_MOTION_FILTER = np.array([0.054488685, 0.244201342, 0.402619947, 0.244201342, 0.054488685], np.float32)

# Daubechies-2 (db2) analysis filters (orthonormal)
_DB2_LO = np.array([0.482962913144690, 0.836516303737469, 0.224143868041857, -0.129409522550921], np.float32)
_DB2_HI = np.array([-0.129409522550921, -0.224143868041857, 0.836516303737469, -0.482962913144690], np.float32)


def calculate_luma(video) -> torch.Tensor:
    """(B, 3, F, H, W) RGB in [0, 1] -> (B, F, H, W) luma in [0, 255].

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.video import calculate_luma
        >>> calculate_luma(torch.ones(1, 3, 1, 1, 2))
        tensor([[[[255., 255.]]]])
    """
    video = _jax_dtype(_as_tensor(video))
    r, g, b = video[:, 0], video[:, 1], video[:, 2]
    return (0.299 * r + 0.587 * g + 0.114 * b) * 255.0


def _conv2d_sep(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable 2-D convolution of (N, H, W) float32 frames with a symmetric 1-D tap
    vector (float32 values held in float64), edge-replicated like libvmaf's convolution
    boundary handling. Each pass adds its exact float64 products in float64 and rounds
    once to float32, so the order of the additions (cuDNN's, the CPU's) does not show in
    the result: VIF's variances at the coarse scales are small differences of such sums."""
    k = taps.shape[0]
    pad = k // 2
    x = F.pad(x[:, None], (0, 0, pad, pad), mode="replicate").to(torch.float64)
    x = conv2d(x, taps.reshape(1, 1, k, 1)).to(torch.float32)
    x = F.pad(x, (pad, pad, 0, 0), mode="replicate").to(torch.float64)
    return conv2d(x, taps.reshape(1, 1, 1, k)).to(torch.float32)[:, 0]


def _gaussian_taps(n: int, sd: float) -> np.ndarray:
    x = np.arange(n) - (n - 1) / 2.0
    w = np.exp(-(x**2) / (2 * sd * sd))
    return (w / w.sum()).astype(np.float32)


def _blur_taps(kind: str, n: int) -> np.ndarray:
    """A blur's float32 taps held in float64: libvmaf's motion filter, or VIF's
    ``n``-tap gaussian of sd ``n / 5``."""
    return (_MOTION_FILTER if kind == "motion" else _gaussian_taps(n, n / 5.0)).astype(np.float64)


def _frame_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last two axes, accumulated in float64 and rounded once."""
    return x.sum((-1, -2), dtype=torch.float64).to(x.dtype)


def motion_features(ref_luma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, F, H, W) -> (motion, motion2), each (B, F). Frame 0 scores 0."""
    b, f, h, w = ref_luma.shape
    taps = _device_constant(_blur_taps, ref_luma.device, "motion", 5)
    blurred = _conv2d_sep(ref_luma.reshape(b * f, h, w), taps).reshape(b, f, h, w)
    sad = (blurred[:, 1:] - blurred[:, :-1]).abs().mean((-1, -2), dtype=torch.float64).to(blurred.dtype)
    zero = sad.new_zeros((b, 1))
    motion = torch.cat([zero, sad], dim=1)  # motion[i] = sad(i-1, i)
    nxt = torch.cat([sad, torch.full_like(zero, float("inf"))], dim=1)
    motion2 = torch.minimum(motion, nxt)
    return motion, torch.cat([zero, motion2[:, 1:]], dim=1)


def vif_features(ref_luma: torch.Tensor, dist_luma: torch.Tensor, sigma_nsq: float = 2.0) -> Dict[str, torch.Tensor]:
    """Per-scale VIF (B, F) for scales 0..3 (vifp_mscale float formulation)."""
    b, f, h, w = ref_luma.shape
    ref = ref_luma.reshape(b * f, h, w).to(torch.float32)
    dist = dist_luma.reshape(b * f, h, w).to(torch.float32)
    out = {}
    for scale in range(4):
        n = 2 ** (4 - scale) + 1  # 17, 9, 5, 3
        taps = _device_constant(_blur_taps, ref.device, "gaussian", n)
        if scale > 0:
            ref = _conv2d_sep(ref, taps)[:, ::2, ::2]
            dist = _conv2d_sep(dist, taps)[:, ::2, ::2]
        mu1 = _conv2d_sep(ref, taps)
        mu2 = _conv2d_sep(dist, taps)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = (_conv2d_sep(ref * ref, taps) - mu1_sq).clamp(min=0)
        sigma2_sq = (_conv2d_sep(dist * dist, taps) - mu2_sq).clamp(min=0)
        sigma12 = _conv2d_sep(ref * dist, taps) - mu1_mu2
        g = sigma12 / (sigma1_sq + 1e-10)
        sv_sq = sigma2_sq - g * sigma12
        zero = torch.zeros_like(g)
        g = torch.where(sigma1_sq < 1e-10, zero, g)
        sv_sq = torch.where(sigma1_sq < 1e-10, sigma2_sq, sv_sq)
        sv_sq = torch.where(sigma2_sq < 1e-10, zero, sv_sq)
        g = torch.where(sigma2_sq < 1e-10, zero, g)
        sv_sq = torch.where(g < 0, sigma2_sq, sv_sq)
        g = g.clamp(min=0)
        sv_sq = sv_sq.clamp(min=1e-10)
        num = _frame_sum(torch.log2(1 + g * g * sigma1_sq / (sv_sq + sigma_nsq)))
        den = _frame_sum(torch.log2(1 + sigma1_sq / sigma_nsq))
        out[f"vif_scale{scale}"] = (num / den.clamp(min=1e-10)).reshape(b, f)
    return out


# Watson JPEG2000-book CSF model (libvmaf adm_tools ``dwt_quant_step``):
# log10(T/a) = k*(log10(f/(g*f0)))^2, quantizer step Q = 2*T/amplitude.
_ADM_CSF_A, _ADM_CSF_K, _ADM_CSF_F0 = 0.495, 0.466, 0.401
_ADM_CSF_G = (1.501, 1.0, 0.534, 1.0)  # orientation gains (LL, H/V, D, -)
# db2 basis-function amplitudes per (level, orientation)
_ADM_BASIS_AMP = (
    (0.62171, 0.67234, 0.67234, 0.72709),
    (0.34537, 0.41317, 0.41317, 0.49428),
    (0.18004, 0.22727, 0.22727, 0.28688),
    (0.091401, 0.11792, 0.11792, 0.15214),
)
_ADM_NORM_VIEW_DIST, _ADM_REF_DISPLAY_HEIGHT = 3.0, 1080


def _adm_rfactors(scale: int) -> Tuple[float, float]:
    """(rfactor_hv, rfactor_d): inverse Watson quantizer steps for the detail
    orientations at ``scale`` (0-based), at libvmaf's default 3H/1080 viewing."""

    def quant_step(theta: int) -> float:
        r = _ADM_NORM_VIEW_DIST * _ADM_REF_DISPLAY_HEIGHT * np.pi / 180.0
        temp = np.log10((2.0 ** (scale + 1)) * _ADM_CSF_F0 * _ADM_CSF_G[theta] / r)
        t = _ADM_CSF_A * (10.0 ** (_ADM_CSF_K * temp * temp))
        return 2.0 * t / _ADM_BASIS_AMP[scale][theta]

    return 1.0 / quant_step(1), 1.0 / quant_step(2)


def _dwt_source(n: int) -> np.ndarray:
    """The input index under each of the ``2 m + 2`` positions ``-1 .. 2 m`` that one
    db2 pass of ``n`` samples reads (``m = (n + 1) // 2``; output ``i`` reads positions
    ``2 i - 1 .. 2 i + 2``): reflect-101 on the left edge, then symmetric (edge-inclusive)
    reflection on the right, the two tests in the JAX package's order."""
    m = (n + 1) // 2
    out = []
    for ind in range(-1, 2 * m + 1):
        if ind < 0:
            ind = -ind
        if ind >= n:
            ind = 2 * n - ind - 1
        out.append(ind % n)  # at n = 1 the JAX package's matrix index -1 wraps to the last column
    return np.asarray(out)


def _dwt_pass(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) of one db2 pass along ``dim``: four products of the gathered input,
    added in the taps' order."""
    n = x.shape[dim]
    m = (n + 1) // 2
    xp = x.index_select(dim, _device_constant(_dwt_source, x.device, n))
    every_second = [slice(None)] * x.ndim
    every_second[dim] = slice(None, None, 2)
    taps = [xp.narrow(dim, k, 2 * m - 1)[tuple(every_second)] for k in range(4)]
    out = []
    for weights in (_DB2_LO, _DB2_HI):
        acc = taps[0] * float(weights[0])
        for k in range(1, 4):
            acc = acc + taps[k] * float(weights[k])
        out.append(acc)
    return out[0], out[1]


def _dwt2_db2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One libvmaf-convention db2 DWT level of (N, H, W) -> (A, H, V, D), band sizes
    ``(dim + 1) // 2``: the rows' pass, then the columns'."""
    lo_r, hi_r = _dwt_pass(x, 1)
    a, v = _dwt_pass(lo_r, 2)
    h, d = _dwt_pass(hi_r, 2)
    return a, h, v, d


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3 x 3 sums of an edge-padded (N, H, W) map: nine shifted slices added in order."""
    hh, ww = x.shape[-2:]
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    out = None
    for i in range(3):
        for j in range(3):
            part = xp[:, i:i + hh, j:j + ww]
            out = part if out is None else out + part
    return out


def _cube_sum(x: torch.Tensor) -> torch.Tensor:
    return _frame_sum(x * x * x)


def adm_features(ref_luma: torch.Tensor, dist_luma: torch.Tensor) -> Dict[str, torch.Tensor]:
    """libvmaf float-ADM per scale and the combined adm2, (B, F) each. Identity scores
    exactly 1: T == O makes the additive component, hence the mask, 0 and num == den."""
    b, f, h, w = ref_luma.shape
    o = ref_luma.reshape(b * f, h, w).to(torch.float32)
    t = dist_luma.reshape(b * f, h, w).to(torch.float32)
    num_scales, eps = 4, 1e-30
    cos_1deg_sq = float(np.cos(np.deg2rad(1.0)) ** 2)
    nums, dens = [], []
    for scale in range(num_scales):
        o_a, o_h, o_v, o_d = _dwt2_db2(o)
        t_a, t_h, t_v, t_d = _dwt2_db2(t)
        o, t = o_a, t_a
        # decoupling: restored R = clip(T/O, 0, 1) * O, except within 1 degree of equal
        # orientation, where the distortion counts as purely additive
        ot_dp = o_h * t_h + o_v * t_v
        o_mag_sq = o_h * o_h + o_v * o_v + eps
        t_mag_sq = t_h * t_h + t_v * t_v + eps
        angle_ok = (ot_dp >= 0) & (ot_dp * ot_dp >= cos_1deg_sq * o_mag_sq * t_mag_sq)
        rests = []
        for o_s, t_s in ((o_h, t_h), (o_v, t_v), (o_d, t_d)):
            k = (t_s / (o_s + torch.where(o_s >= 0, eps, -eps))).clamp(0.0, 1.0)
            rests.append(torch.where(angle_ok, t_s, k * o_s))
        rf_hv, rf_d = _adm_rfactors(scale)
        rf = (rf_hv, rf_hv, rf_d)
        o_bands = (o_h, o_v, o_d)
        t_bands = (t_h, t_v, t_d)
        # contrast masking: the 3 x 3 sum of the CSF-weighted additive impairment T - R
        # over the three orientations, / 30
        mask = _box3(sum(((t_s - r_s) * rfi).abs() for t_s, r_s, rfi in zip(t_bands, rests, rf)) / 30.0)
        # libvmaf border crop: left = int(w * 0.1 - 0.5), interior [left, w - left)
        hh, ww = o_h.shape[-2:]
        ch = max(int(hh * 0.1 - 0.5), 0)
        cw = max(int(ww * 0.1 - 0.5), 0)
        sl = (slice(None), slice(ch, hh - ch), slice(cw, ww - cw))
        num_s = sum(_cube_sum((((r * rfi).abs() - mask).clamp(min=0))[sl]) for r, rfi in zip(rests, rf)) ** (1 / 3)
        den_s = sum(_cube_sum((x * rfi).abs()[sl]) for x, rfi in zip(o_bands, rf)) ** (1 / 3)
        # libvmaf per-scale stabiliser: cbrt(interior_area / 32) on both sides
        extra = (((hh - 2 * ch) * (ww - 2 * cw)) / 32.0) ** (1 / 3)
        nums.append(num_s + extra)
        dens.append(den_s + extra)
    out = {f"adm_scale{scale}": (nums[scale] / dens[scale]).reshape(b, f) for scale in range(num_scales)}
    out["adm2"] = (sum(nums) / sum(dens)).reshape(b, f)
    return out


class VmafModel:
    """NuSVR fusion model in the libvmaf JSON layout, evaluated in float64 on the
    features' device.

    Expected schema (the ``model_dict`` of a libvmaf ``.json`` model, e.g.
    ``vmaf_v0.6.1.json``): ``feature_names``, ``norm_type`` 'linear_rescale' with
    ``slopes``/``intercepts`` (first entry the score, the rest per feature), RBF
    ``gamma``, ``rho``, ``sv_coef`` (n_sv,), ``support_vectors`` (n_sv, n_features),
    optional ``score_clip`` and polynomial ``score_transform``.
    """

    def __init__(self, blob: Dict) -> None:
        d = blob.get("model_dict", blob)
        self.feature_names = list(d["feature_names"])
        self.slopes = np.asarray(d["slopes"], np.float64)
        self.intercepts = np.asarray(d["intercepts"], np.float64)
        model = d.get("model", d)
        self.gamma = float(model["gamma"])
        self.rho = float(model["rho"])
        self.sv_coef = np.asarray(model["sv_coef"], np.float64).reshape(-1)
        self.support_vectors = np.asarray(model["support_vectors"], np.float64)
        self.score_clip = d.get("score_clip")
        self.score_transform = d.get("score_transform")

    @classmethod
    def from_file(cls, path: str) -> "VmafModel":
        with open(os.path.expanduser(path)) as fh:
            return cls(json.load(fh))

    def predict(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        """features: name -> (...,) tensors. Returns the fused score, float64, same shape."""
        x = torch.stack([_as_tensor(features[name]).to(torch.float64) for name in self.feature_names], dim=-1)
        shape = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        dev = {"dtype": torch.float64, "device": x.device}
        slopes, intercepts = torch.as_tensor(self.slopes, **dev), torch.as_tensor(self.intercepts, **dev)
        x = slopes[1:] * x + intercepts[1:]  # linear_rescale normalization
        d2 = ((x[:, None, :] - torch.as_tensor(self.support_vectors, **dev)[None]) ** 2).sum(-1)
        y = (torch.as_tensor(self.sv_coef, **dev)[None, :] * torch.exp(-self.gamma * d2)).sum(-1) - self.rho
        y = (y - intercepts[0]) / slopes[0]  # denormalize the score
        if self.score_transform:
            p = self.score_transform
            y2 = p.get("p0", 0.0) + p.get("p1", 0.0) * y + p.get("p2", 0.0) * y**2
            if p.get("out_gte_in", False):
                y2 = torch.maximum(y2, y)
            y = y2
        if self.score_clip:
            y = y.clamp(self.score_clip[0], self.score_clip[1])
        return y.reshape(shape)


def _canonical_feature_key(name: str) -> str:
    """A model file's feature name as the feature dict's key: libvmaf's
    ``VMAF_feature_<name>_score`` (sometimes quoted) and vmaf-torch's ``integer_<name>``
    both resolve to ``integer_<name>``."""
    key = name.strip().strip("'\"")
    if key.startswith("VMAF_feature_") and key.endswith("_score"):
        key = key[len("VMAF_feature_") : -len("_score")]
    if not key.startswith("integer_"):
        key = f"integer_{key}"
    return key


_VMAF_FEATURE_ORDER = (
    "integer_motion2", "integer_motion",
    "integer_adm2",
    "integer_adm_scale0", "integer_adm_scale1", "integer_adm_scale2", "integer_adm_scale3",
    "integer_vif_scale0", "integer_vif_scale1", "integer_vif_scale2", "integer_vif_scale3",
)


def vmaf_features(preds, target) -> Dict[str, torch.Tensor]:
    """All elementary features, (B, F) each, under the reference's key names (float
    pipelines; the ``integer_`` prefix is kept for the names' sake)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if preds.ndim != 5 or target.ndim != 5 or preds.shape[1] != 3:
        raise ValueError(
            f"Expected (batch, 3, frames, height, width) videos, got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    ref = calculate_luma(target)
    dist = calculate_luma(preds)
    motion, motion2 = motion_features(ref)
    out = {"integer_motion": motion, "integer_motion2": motion2}
    for key, val in vif_features(ref, dist).items():
        out[f"integer_{key}"] = val
    for key, val in adm_features(ref, dist).items():
        out[f"integer_{key}"] = val
    return out


def video_multi_method_assessment_fusion(
    preds,
    target,
    features: bool = False,
    model_path: Optional[str] = None,
) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """VMAF score (B, F) as float32, with the elementary feature dict when
    ``features``. ``model_path``, a libvmaf-format model JSON, drives the in-tree
    features and NuSVR where ``vmaf_torch`` is absent."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if _VMAF_TORCH_AVAILABLE and model_path is None:
        return _vmaf_torch_callback(preds, target, features)
    if model_path is None:
        raise ModuleNotFoundError(
            "vmaf-torch is not installed and no `model_path` was given. Install "
            "vmaf-torch (`pip install torchmetrics[video]`) for the reference path, or "
            "pass `model_path=` pointing at a libvmaf model JSON (e.g. vmaf_v0.6.1.json) "
            "to fuse the in-tree elementary features. `vmaf_features(preds, target)` "
            "computes the features without any model."
        )
    feats = vmaf_features(preds, target)
    model = VmafModel.from_file(model_path)
    score = model.predict({name: feats[_canonical_feature_key(name)] for name in model.feature_names})
    score = score.to(torch.float32)
    if features:
        return {"vmaf": score, **feats}
    return score


def _vmaf_torch_callback(preds: torch.Tensor, target: torch.Tensor, features: bool):
    """Through vmaf_torch (the reference's only path), on the inputs' device."""
    from vmaf_torch import VMAF

    vmaf = VMAF().to(preds.device)
    ref = calculate_luma(target).unsqueeze(1)
    dist = calculate_luma(preds).unsqueeze(1)
    scores, tables = [], []
    for i in range(ref.shape[0]):
        r, d = ref[i].transpose(0, 1), dist[i].transpose(0, 1)  # (F, 1, H, W)
        scores.append(vmaf.compute_vmaf_score(r, d).flatten())
        if features:
            tables.append(vmaf.table(r, d))
    out_score = torch.stack(scores).to(torch.float32)
    if not features:
        return out_score
    out = {"vmaf": out_score}
    for key in _VMAF_FEATURE_ORDER:
        columns = [t[key].to_numpy() if hasattr(t[key], "to_numpy") else np.asarray(t[key]) for t in tables]
        out[key] = torch.as_tensor(np.stack(columns), dtype=torch.float32, device=preds.device)
    return out
