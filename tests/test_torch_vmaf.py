"""The port's VMAF against the JAX package, on the CPU: ``calculate_luma``, the motion,
VIF and ADM features (the DWT too), the NuSVR fusion of a libvmaf-format model file,
``video_multi_method_assessment_fusion`` on each of its three paths,
``VideoMultiMethodAssessmentFusion``, and the exports of ``video`` and
``functional.video``.

The same numpy inputs, made from a seed, go through the JAX package and the port
(``device="cpu"``): videos of 2 x 3 frames of 36 x 44 RGB (two batches), smooth
textures whose distorted copies are blurred, noisy and shifted. The model file holds
libvmaf v0.6.1's feature list and seeded support vectors, rescaling and transform.

Tolerances, with ``u = 2**-24``:

- luma bit for bit;
- motion, ADM and VIF at scale 0 within ``32 u`` of their magnitude (at least 1): the
  blurs and DWT products are summed in another order (the port adds each blur's float64
  products and rounds once, JAX adds float32 products), and the features are float32
  sums over a frame (the worst seen: 22 u, ADM at scale 3);
- VIF at scales 1 to 3 within 1e-3: there the local variances are small differences of
  blurred luma squares (up to 255 ** 2), which JAX's float32 blur rounds to about 1e-2
  (the worst seen: 3.4e-4);
- the fused score within 1e-3 relative of the JAX package's on the same features (the
  SVR's exponentials of the rescaled features), and the SVR on the same float64
  features within 1e-12 relative.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu_torch import functional as port_fn

jax_vmaf = importlib.import_module("torchmetrics_tpu.functional.video.vmaf")
port_vmaf = importlib.import_module("torchmetrics_tpu_torch.functional.video.vmaf")

CPU = {"device": "cpu"}
U = 2.0**-24
_RNG = np.random.default_rng(1517)
V061_FEATURES = ["VMAF_feature_adm2_score", "VMAF_feature_motion2_score", "VMAF_feature_vif_scale0_score",
                 "VMAF_feature_vif_scale1_score", "VMAF_feature_vif_scale2_score", "VMAF_feature_vif_scale3_score"]


def _videos(rng, batch: int = 2, frames: int = 3, h: int = 36, w: int = 44):
    """(preds, target): smooth RGB textures moving one pixel a frame; the predictions
    blurred along the rows, noisy and shifted by a pixel."""
    yy, xx = np.mgrid[0:h, 0:w + frames].astype(np.float32)
    phase = rng.random((batch, 3, 1, 1, 1)).astype(np.float32) * 6
    wide = 0.5 + 0.25 * np.sin(xx / 5 + phase) * np.cos(yy / 7 + phase) + 0.1 * rng.random((batch, 3, 1, h, w + frames))
    target = np.stack([wide[..., 0, :, f:f + w] for f in range(frames)], axis=2).astype(np.float32)
    blurred = (target + np.roll(target, 1, -1) + np.roll(target, -1, -1)) / 3
    preds = np.roll(blurred, 1, -2) + 0.02 * rng.standard_normal(target.shape)
    return np.clip(preds, 0, 1).astype(np.float32), np.clip(target, 0, 1)


VIDEOS = [_videos(_RNG) for _ in range(2)]


def _model_blob(seed: int = 0, support_vectors: int = 24) -> dict:
    """A libvmaf-format NuSVR model: v0.6.1's six features, seeded support vectors,
    rescaling, a polynomial score transform and a clip to [0, 100]."""
    rng = np.random.default_rng(seed)
    n = len(V061_FEATURES)
    return {"model_dict": {
        "feature_names": V061_FEATURES, "norm_type": "linear_rescale",
        "slopes": [0.012] + list(rng.uniform(0.5, 3.0, n)), "intercepts": [-0.3] + list(rng.uniform(-2, 0, n)),
        "model": {"gamma": 0.04, "rho": -0.4, "sv_coef": list(rng.uniform(-0.02, 0.02, support_vectors)),
                  "support_vectors": rng.uniform(-1, 1, (support_vectors, n)).tolist()},
        "score_transform": {"p0": 1.7, "p1": 1.72, "p2": -0.007, "out_gte_in": True},
        "score_clip": [0.0, 100.0],
    }}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("vmaf") / "vmaf_seeded.json"
    path.write_text(json.dumps(_model_blob()))
    return str(path)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _close(port, ref, units: float = 32, context: str = "", atol: float = 0.0) -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    p64, r64 = p.astype(np.float64), r.astype(np.float64)
    tol = np.maximum(units * U * np.maximum(np.abs(r64), 1.0), atol)
    assert np.all(np.abs(p64 - r64) <= tol), f"{context}: {p} against {r}"


def _hold_features(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, value in want.items():
        coarse_vif = key.startswith("integer_vif_scale") and not key.endswith("0")
        _close(got[key], value, context=key, atol=1e-3 if coarse_vif else 0.0)


@functools.lru_cache(maxsize=None)
def _jax_features():
    return jax.jit(jax_fn.vmaf_features)


def test_luma_is_the_jax_packages_bit_for_bit():
    preds, _ = VIDEOS[0]
    np.testing.assert_array_equal(port_fn.calculate_luma(*_t(preds)).numpy(), np.asarray(jax_fn.calculate_luma(preds)))


@pytest.mark.parametrize("batch", [0, 1])
def test_features_match_the_jax_package(batch):
    preds, target = VIDEOS[batch]
    _hold_features(port_fn.vmaf_features(*_t(preds, target)), _jax_features()(preds, target))


def test_identity_scores_one_and_a_static_video_no_motion():
    _, target = VIDEOS[0]
    static = np.repeat(target[:, :, :1], 3, axis=2)
    got = port_fn.vmaf_features(*_t(static, static))
    want = _jax_features()(static, static)
    for key, value in got.items():
        if key.startswith("integer_motion"):
            assert not value.any(), key
        else:
            np.testing.assert_allclose(value.numpy(), 1.0, rtol=0, atol=4 * U, err_msg=key)
        _close(value, want[key], context=key)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9, 36, 45])
def test_dwt_reads_the_dense_matrices_taps(n):
    """The port's 4-tap pass, applied to the identity, is the JAX package's dense
    ``(m, n)`` matrix (taps that land on one reflected sample add in float32 here,
    in float64 there: within one unit)."""
    lo, hi = port_vmaf._dwt_pass(torch.eye(n)[None], 1)
    want_lo, want_hi = jax_vmaf._dwt_mats_1d(n)
    _close(lo[0], want_lo, units=1, context="lo")
    _close(hi[0], want_hi, units=1, context="hi")


def test_dwt_level_matches_the_jax_packages_dense_form():
    """A band value is 16 products whose absolute sum is at most ``(sum |tap|) ** 2 =
    2.8`` times the largest luma; the detail bands cancel most of it, so the bound is
    ``8 u`` of that sum, not of the value (the worst seen: 3.9 u of it)."""
    x = np.asarray(jax_fn.calculate_luma(VIDEOS[0][1])).reshape(-1, 36, 44)
    scale = float(np.abs(jax_vmaf._DB2_LO).sum()) ** 2 * float(np.abs(x).max())
    for got, want in zip(port_vmaf._dwt2_db2(torch.from_numpy(x)), jax_vmaf._dwt2_db2(x)):
        _close(got, want, units=0, atol=8 * U * scale)


def test_svr_matches_the_jax_package_on_the_same_features():
    features = {name: _RNG.uniform(0, 1, (2, 5)) for name in V061_FEATURES}
    jax_model, port_model = jax_vmaf.VmafModel(_model_blob()), port_vmaf.VmafModel(_model_blob())
    want = jax_model.predict(features)
    got = port_model.predict({k: torch.from_numpy(v) for k, v in features.items()})
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    plain = _model_blob()["model_dict"]  # a blob without "model_dict" nor transform and clip
    plain = {**{k: v for k, v in plain.items() if k not in ("score_transform", "score_clip", "model")},
             **plain["model"]}
    np.testing.assert_allclose(port_vmaf.VmafModel(plain).predict({k: torch.from_numpy(v) for k, v in features.items()})
                               .numpy(), jax_vmaf.VmafModel(plain).predict(features), rtol=1e-12)


@pytest.mark.parametrize("name", ["VMAF_feature_adm2_score", "'VMAF_feature_vif_scale0_score'", "integer_motion2",
                                  "motion", ' "adm_scale3" ', "VMAF_feature_motion2"])
def test_feature_names_map_as_in_the_jax_package(name):
    assert port_vmaf._canonical_feature_key(name) == jax_vmaf._canonical_feature_key(name)


@pytest.mark.parametrize("features", [False, True])
def test_fusion_through_a_model_file_matches_the_jax_package(features, model_path):
    preds, target = VIDEOS[0]
    want = jax_fn.video_multi_method_assessment_fusion(preds, target, features=features, model_path=model_path)
    got = port_fn.video_multi_method_assessment_fusion(*_t(preds, target), features=features, model_path=model_path)
    if features:
        assert list(got) == list(want)
        _close(got["vmaf"], want["vmaf"], units=0, atol=1e-3 * float(np.abs(want["vmaf"]).max()), context="vmaf")
        _hold_features({k: v for k, v in got.items() if k != "vmaf"}, {k: v for k, v in want.items() if k != "vmaf"})
    else:
        assert got.dtype == torch.float32 and got.shape == (2, 3)
        _close(got, want, units=0, atol=1e-3 * float(np.abs(want).max()), context="vmaf")


def test_gates_are_the_jax_packages(monkeypatch):
    preds, target = VIDEOS[0]
    for module in (jax_vmaf, port_vmaf):
        monkeypatch.setattr(module, "_VMAF_TORCH_AVAILABLE", False)
    monkeypatch.setattr(importlib.import_module("torchmetrics_tpu.video.vmaf"), "_VMAF_TORCH_AVAILABLE", False)
    for jax_call, port_call in (
        (lambda: jax_fn.video_multi_method_assessment_fusion(preds, target),
         lambda: port_fn.video_multi_method_assessment_fusion(*_t(preds, target))),
        (lambda: jtm.video.VideoMultiMethodAssessmentFusion(),
         lambda: ttm.video.VideoMultiMethodAssessmentFusion(**CPU)),
    ):
        with pytest.raises(ModuleNotFoundError) as jax_err:
            jax_call()
        with pytest.raises(ModuleNotFoundError) as port_err:
            port_call()
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as jax_err:
        jax_fn.vmaf_features(preds[:, :2], target[:, :2])
    with pytest.raises(ValueError) as port_err:
        port_fn.vmaf_features(*_t(preds[:, :2], target[:, :2]))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="boolean"):
        ttm.video.VideoMultiMethodAssessmentFusion(features=1, model_path="x.json", **CPU)


def _fake_vmaf_torch(log: list) -> types.ModuleType:
    """A stand-in for the vmaf_torch wheel: its score is a frame's mean absolute luma
    difference, its table each feature as that score plus the feature's index."""
    module = types.ModuleType("vmaf_torch")

    class VMAF(torch.nn.Module):
        def compute_vmaf_score(self, ref, dist):
            log.append(tuple(ref.shape))
            return (ref - dist).abs().mean(dim=(1, 2, 3))

        def table(self, ref, dist):
            score = self.compute_vmaf_score(ref, dist).numpy()
            return {key: score + i for i, key in enumerate(port_vmaf._VMAF_FEATURE_ORDER)}

    module.VMAF = VMAF
    return module


def test_the_vmaf_torch_path_goes_first_as_in_the_jax_package(monkeypatch):
    log: list = []
    monkeypatch.setitem(sys.modules, "vmaf_torch", _fake_vmaf_torch(log))
    for module in (jax_vmaf, port_vmaf):
        monkeypatch.setattr(module, "_VMAF_TORCH_AVAILABLE", True)
    preds, target = VIDEOS[0]
    for features in (False, True):
        want = jax_fn.video_multi_method_assessment_fusion(preds, target, features=features)
        got = port_fn.video_multi_method_assessment_fusion(*_t(preds, target), features=features)
        if features:
            assert list(got) == list(want)
            for key in want:
                _close(got[key], want[key], units=1, context=key)
        else:
            _close(got, want, units=1)
    assert set(log) == {(3, 1, 36, 44)}  # (frames, 1, H, W) a video


@pytest.mark.parametrize("features", [False, True])
def test_class_matches_the_jax_package(features, model_path):
    """forward on the first batch, update on the second (cat states and compute over
    both), merge_state and a checkpoint from the JAX package loaded into the port."""
    jax_metric = jtm.video.VideoMultiMethodAssessmentFusion(features=features, model_path=model_path)
    port_metric = ttm.video.VideoMultiMethodAssessmentFusion(features=features, model_path=model_path, **CPU)

    def hold(got, want, context):
        want = want if isinstance(want, dict) else {"vmaf": want}
        got = got if isinstance(got, dict) else {"vmaf": got}
        assert list(got) == list(want), context
        for key, value in want.items():
            if key == "vmaf":
                _close(got[key], value, units=0, atol=1e-3 * float(np.abs(value).max()), context=f"{context} {key}")
        _hold_features({k: v for k, v in got.items() if k != "vmaf"}, {k: v for k, v in want.items() if k != "vmaf"})

    hold(port_metric(*_t(*VIDEOS[0])), jax_metric(*VIDEOS[0]), "forward")
    jax_metric.update(*VIDEOS[1])
    port_metric.update(*_t(*VIDEOS[1]))
    assert set(port_metric._state) == set(jax_metric._state)
    want = jax_metric.compute()
    hold(port_metric.compute(), want, "compute")
    a, b = (ttm.video.VideoMultiMethodAssessmentFusion(features=features, model_path=model_path, **CPU)
            for _ in range(2))
    a.update(*_t(*VIDEOS[0]))
    b.update(*_t(*VIDEOS[1]))
    a.merge_state(b)
    hold(a.compute(), want, "merged")
    jax_metric.persistent(True)
    restored = ttm.video.VideoMultiMethodAssessmentFusion(features=features, model_path=model_path, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    hold(restored.compute(), want, "restored")
    assert port_metric._jittable_compute is jax_metric._jittable_compute is False


def test_exports_and_signatures_are_the_jax_packages():
    assert ttm.video.__all__ == jtm.video.__all__
    assert port_fn.video.__all__ == jax_fn.video.__all__
    assert ttm.VideoMultiMethodAssessmentFusion is ttm.video.VideoMultiMethodAssessmentFusion
    for name in jax_fn.video.__all__:
        assert getattr(port_fn, name) is getattr(port_fn.video, name)
        jax_params = inspect.signature(getattr(jax_fn.video, name)).parameters
        port_params = inspect.signature(getattr(port_fn.video, name)).parameters
        assert [(p.name, p.default) for p in port_params.values()] == \
            [(p.name, p.default) for p in jax_params.values()], name
    assert list(inspect.signature(ttm.video.VideoMultiMethodAssessmentFusion).parameters) == \
        list(inspect.signature(jtm.video.VideoMultiMethodAssessmentFusion).parameters)


@pytest.mark.parametrize("luma", [16, 128])
def test_vif_of_identical_flat_videos_is_zero_at_every_scale(luma):
    """A documented divergence: on two identical constant videos (72 x 128) the port's
    blurs, exact float64 products rounded once, leave variances of exactly 0, so every
    VIF scale is 0. The JAX package's float32 blurs leave rounding noise in the
    variances, which gives about 1.0 at some scales and 0 at others by the frame size;
    neither is libvmaf's rule."""
    video = np.full((1, 3, 2, 72, 128), luma / 255, np.float32)
    got = port_fn.vmaf_features(*_t(video, video))
    want = _jax_features()(video, video)
    for scale in range(4):
        key = f"integer_vif_scale{scale}"
        np.testing.assert_array_equal(_np(got[key]), np.zeros((1, 2), np.float32), err_msg=key)
        # JAX's noise: 0, or 1 within a few float32 units
        assert np.all(np.minimum(np.abs(np.asarray(want[key])), np.abs(np.asarray(want[key]) - 1)) < 1e-5), key
