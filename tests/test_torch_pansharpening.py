"""The port's pan-sharpening metrics against the JAX package, on the CPU: SAM, ERGAS,
SCC, D_lambda, D_s (with and without ``pan_lr``), QNR, and UQI where they use it, as
functions and as classes.

The same numpy inputs, made from a seed, go through the JAX package and the port
(``device="cpu"``): 4 bands, fused images of 32 x 32, ``ms`` of 16 x 16 and of 8 x 8,
``pan`` of 32 x 32 (repeated to the 4 bands, as D_s needs). At ``ms`` 8 x 8 the UQI
map's crop (5 pixels a side for the 11 x 11 window) leaves nothing, so D_lambda and D_s
are NaN in both packages; 16 x 16 gives values.

Tolerances, with ``u = 2**-24``:

- SAM's angle within ``8 u / sin(angle) + 32 u`` (at most ``sqrt(16 u)``): the cosine
  carries a few rounding units, and ``arccos`` multiplies an error by ``1 / sin``;
  a mean of angles within the mean of those;
- ERGAS within 1e-6 relative (the port's band sums are float64 rounded once);
- SCC within ``32 u`` of its magnitude (at least 1): 9-tap and 64-tap convolutions
  summed in another order than XLA's, means over 2,048 pixels;
- the UQI-based values within ``242 u`` a UQI mean they difference (D_lambda and D_s:
  two, ``484 u``; QNR: four, ``968 u``): a UQI map entry is a ratio of 121-tap gaussian
  sums within about ``2 * 121 u`` of JAX's (one unit a tap for the order of summation,
  one for the window's last bit, which the port rounds from float64), and at these
  sizes a band's map holds only 72 to 968 entries, too few to average that down;
- the antialiased resize within ``4 u`` of ``jax.image.resize``'s (a float64 product
  of the same triangle weights, rounded once, against a float32 one).
"""

from __future__ import annotations

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu_torch import functional as port_fn

port_d_s = importlib.import_module("torchmetrics_tpu_torch.functional.image.d_s")

CPU = {"device": "cpu"}
U = 2.0**-24
_RNG = np.random.default_rng(2022)
BANDS = 4
TRUTH = _RNG.random((2, 2, BANDS, 32, 32), dtype=np.float32)  # two batches of two samples
FUSED = np.clip(TRUTH + 0.05 * _RNG.standard_normal(TRUTH.shape).astype(np.float32), 0.01, 1)
MS = TRUTH.reshape(2, 2, BANDS, 16, 2, 16, 2).mean((4, 6)).astype(np.float32)
MS8 = TRUTH.reshape(2, 2, BANDS, 8, 4, 8, 4).mean((4, 6)).astype(np.float32)
PAN = np.repeat(TRUTH.mean(2, keepdims=True), BANDS, axis=2).astype(np.float32)
PAN_LR = PAN.reshape(2, 2, BANDS, 16, 2, 16, 2).mean((4, 6)).astype(np.float32)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _close(port, ref, units: float = 32, context: str = "", relative: float = 0.0, tol=None) -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    p64, r64 = p.astype(np.float64), r.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(p64), np.isnan(r64), err_msg=context)
    if tol is None:
        tol = relative * np.abs(r64) if relative else units * U * np.maximum(np.abs(r64), 1.0)
    tol = np.broadcast_to(tol, r64.shape)
    keep = ~np.isnan(r64) & (p64 != r64)
    assert np.all(np.abs(p64[keep] - r64[keep]) <= tol[keep]), f"{context}: {p} against {r}"


@functools.lru_cache(maxsize=None)
def _jitted(fn_name: str, kw_items: tuple):
    """The JAX function under ``jax.jit``: one compile a call pattern."""
    return jax.jit(functools.partial(getattr(jax_fn, fn_name), **dict(kw_items)))


def _both(fn_name: str, *arrays, **kw):
    return _jitted(fn_name, tuple(sorted(kw.items())))(*_j(*arrays)), getattr(port_fn, fn_name)(*_t(*arrays), **kw)


UQI_UNITS = {"spectral_distortion_index": 484, "spatial_distortion_index": 484, "quality_with_no_reference": 968,
             "d_lambda": 484, "d_s": 484, "d_s_lr": 484, "qnr": 968, "qnr_lr": 968}


def _angle_tolerance(angle: np.ndarray) -> np.ndarray:
    return np.minimum(8 * U / np.maximum(np.sin(angle), 1e-30) + 32 * U, np.sqrt(16 * U))


# ---------------------------------------------------------------------------- functions

@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_sam(reduction):
    want, got = _both("spectral_angle_mapper", FUSED[0], TRUTH[0], reduction=reduction)
    angles = _np(_jitted("spectral_angle_mapper", (("reduction", "none"),))(*_j(FUSED[0], TRUTH[0]))).astype(np.float64)
    tol = _angle_tolerance(angles)
    tol = {"none": tol, "sum": tol.sum(), "elementwise_mean": tol.mean()}[reduction]
    _close(got, want, tol=tol, context=reduction)


@pytest.mark.parametrize("ratio, reduction", [(4, "elementwise_mean"), (2, "none"), (4, "sum")])
def test_ergas(ratio, reduction):
    want, got = _both("error_relative_global_dimensionless_synthesis", FUSED[0], TRUTH[0], ratio=ratio,
                      reduction=reduction)
    _close(got, want, relative=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_scc_on_bands(reduction):
    want, got = _both("spatial_correlation_coefficient", FUSED[0], TRUTH[0], reduction=reduction)
    _close(got, want)


def test_sam_and_ergas_errors_like_the_jax_package():
    for lib, make in ((jax_fn, _j), (port_fn, _t)):
        with pytest.raises(ValueError, match="larger than 1"):
            lib.spectral_angle_mapper(*make(FUSED[0, :, :1], TRUTH[0, :, :1]))
        with pytest.raises(TypeError):
            lib.error_relative_global_dimensionless_synthesis(*make(FUSED[0], TRUTH[0].astype(np.int32)))
        with pytest.raises(RuntimeError):
            lib.spectral_angle_mapper(*make(FUSED[0], TRUTH[0, :, :2]))


@pytest.mark.parametrize("p, reduction", [(1, "elementwise_mean"), (2, "sum"), (3, "none")])
def test_d_lambda(p, reduction):
    want, got = _both("spectral_distortion_index", FUSED[0], MS[0], p=p, reduction=reduction)
    _close(got, want, units=484)


def test_pairwise_band_uqi_fills_jaxs_symmetric_matrix():
    jax_d = importlib.import_module("torchmetrics_tpu.functional.image.d_lambda")
    port_d = importlib.import_module("torchmetrics_tpu_torch.functional.image.d_lambda")
    want, got = jax_d._pairwise_band_uqi(*_j(FUSED[0])), port_d._pairwise_band_uqi(*_t(FUSED[0]))
    _close(got, want, units=242)
    assert bool((got == got.T).all()) and bool((torch.diagonal(got) == 0).all())
    _close(port_d._pairwise_band_uqi(*_t(FUSED[0, :, :1])), jax_d._pairwise_band_uqi(*_j(FUSED[0, :, :1])))


@pytest.mark.parametrize("pixels", [1, 3 * 32 * 32, 5 * 32 * 32])
def test_pairwise_band_uqi_in_chunks_is_the_unchunked_matrix(monkeypatch, pixels):
    """Chunks of one band image, of three (a pair's samples split across chunks) and of
    five give the one-call matrix bit for bit: each map is the same sum, and the per-pair
    sums add the same float64 terms in the same order."""
    port_d = importlib.import_module("torchmetrics_tpu_torch.functional.image.d_lambda")
    img = torch.from_numpy(np.concatenate([FUSED[0], FUSED[1]]))
    whole = port_d._pairwise_band_uqi(img)
    monkeypatch.setattr(port_d, "_CHUNK_PIXELS", pixels)
    assert torch.equal(port_d._pairwise_band_uqi(img), whole)


@pytest.mark.parametrize("norm_order, window, reduction, with_lr", [
    (1, 7, "elementwise_mean", False), (2, 3, "none", False), (1, 7, "sum", True), (2, 7, "elementwise_mean", True),
])
def test_d_s(norm_order, window, reduction, with_lr):
    args = (FUSED[0], MS[0], PAN[0]) + ((PAN_LR[0],) if with_lr else ())
    want, got = _both("spatial_distortion_index", *args, norm_order=norm_order, window_size=window,
                      reduction=reduction)
    _close(got, want, units=484)


@pytest.mark.parametrize("alpha, beta, with_lr", [(1, 1, False), (0.5, 2.0, True)])
def test_qnr(alpha, beta, with_lr):
    args = (FUSED[0], MS[0], PAN[0]) + ((PAN_LR[0],) if with_lr else ())
    want, got = _both("quality_with_no_reference", *args, alpha=alpha, beta=beta)
    _close(got, want, units=968)


def test_ms_of_8_by_8_leaves_an_empty_uqi_map_and_nan_in_both():
    for fn in ("spectral_distortion_index", "spatial_distortion_index", "quality_with_no_reference"):
        args = (FUSED[0], MS8[0]) + ((PAN[0],) if fn != "spectral_distortion_index" else ())
        want, got = _both(fn, *args)
        _close(got, want, units=UQI_UNITS[fn], context=fn)
        assert bool(torch.isnan(got))


@pytest.mark.parametrize("size, out", [((32, 32), (16, 16)), ((32, 32), (8, 8)), ((48, 64), (12, 16)),
                                       ((60, 60), (20, 15)), ((16, 16), (16, 16)), ((256, 256), (64, 64))])
def test_resize_is_jax_image_resize_bilinear(size, out):
    """D_s's degraded pan: the port's antialiased resize against ``jax.image.resize``,
    at the shapes of the tests and of the chip smoke's reduced set (256 -> 64)."""
    x = _RNG.random((1, 2, *size), dtype=np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, 2, *out), method="bilinear")
    _close(port_d_s._resize_antialias(torch.from_numpy(x), *out), want, units=4)


@pytest.mark.parametrize("kw, error", [
    ({"preds": FUSED[0, 0]}, ValueError), ({"pan": PAN[0, :, :, :16]}, ValueError), ({"ms": MS[0, :, :, :, :15]},
                                                                                     ValueError),
    ({"pan_lr": PAN_LR[0, :, :, :8]}, ValueError), ({"ms": MS[0].astype(np.int32)}, TypeError),
    ({"pan": PAN[0, :, :2]}, ValueError), ({"window_size": 16}, ValueError), ({"norm_order": 0}, ValueError),
    ({"window_size": 1.5}, ValueError),
], ids=["preds_3d", "pan_size", "ms_multiple", "pan_lr_size", "dtype", "pan_channels", "window_too_big",
        "norm_order", "window_float"])
def test_d_s_errors_like_the_jax_package(kw, error):
    arrays = {"preds": FUSED[0], "ms": MS[0], "pan": PAN[0], "pan_lr": None}
    arrays.update({k: v for k, v in kw.items() if k in arrays})
    options = {k: v for k, v in kw.items() if k not in arrays}
    for lib, make in ((jax_fn, jnp.asarray), (port_fn, lambda a: torch.from_numpy(np.ascontiguousarray(a)))):
        with pytest.raises(error):
            lib.spatial_distortion_index(**{k: (make(v) if v is not None else None) for k, v in arrays.items()},
                                         **options)


def test_d_lambda_and_qnr_errors_like_the_jax_package():
    for lib, make in ((jax_fn, _j), (port_fn, _t)):
        with pytest.raises(ValueError):
            lib.spectral_distortion_index(*make(FUSED[0], MS[0]), p=0)
        with pytest.raises(ValueError):
            lib.spectral_distortion_index(*make(FUSED[0], MS[0, :, :2]))
        with pytest.raises(ValueError):
            lib.quality_with_no_reference(*make(FUSED[0], MS[0], PAN[0]), alpha=-1)
        with pytest.raises(ValueError):
            lib.quality_with_no_reference(*make(FUSED[0], MS[0], PAN[0]), beta="1")
        with pytest.raises(TypeError):
            lib.spectral_distortion_index(*make(FUSED[0], MS[0].astype(np.int32)))


# ---------------------------------------------------------------------------- classes

def _pan_target(i: int, with_lr: bool, make):
    out = {"ms": make(MS[i]), "pan": make(PAN[i])}
    if with_lr:
        out["pan_lr"] = make(PAN_LR[i])
    return out


CLASS_CASES = {
    "sam": ("SpectralAngleMapper", {}, "pair"),
    "sam_sum": ("SpectralAngleMapper", {"reduction": "sum"}, "pair"),
    "sam_none": ("SpectralAngleMapper", {"reduction": "none"}, "pair"),
    "ergas": ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2}, "pair"),
    "d_lambda": ("SpectralDistortionIndex", {"p": 2}, "ms"),
    "d_s": ("SpatialDistortionIndex", {}, "pan"),
    "d_s_lr": ("SpatialDistortionIndex", {"norm_order": 2, "reduction": "none"}, "pan_lr"),
    "qnr": ("QualityWithNoReference", {"alpha": 0.5}, "pan"),
    "qnr_lr": ("QualityWithNoReference", {"window_size": 5}, "pan_lr"),
}


def _class_args(kind: str, i: int, make):
    if kind == "pair":
        return (make(FUSED[i]), make(TRUTH[i]))
    if kind == "ms":
        return (make(FUSED[i]), make(MS[i]))
    return (make(FUSED[i]), _pan_target(i, kind == "pan_lr", make))


def _jnp(a):
    return jnp.asarray(a)


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hold(got, want, case: str) -> None:
    if case.startswith("sam"):
        # sum and mean: within the summed (averaged) angle tolerances of the whole map
        angles = np.concatenate([_np(jax_fn.spectral_angle_mapper(*_j(FUSED[i], TRUTH[i]), reduction="none"))
                                 for i in range(2)]).astype(np.float64)
        tol = _angle_tolerance(angles)
        n = _np(want).size
        _close(got, want, tol=tol if n > 1 else (tol.sum() if case == "sam_sum" else tol.mean()), context=case)
    elif case == "ergas":
        _close(got, want, relative=1e-6, context=case)
    else:
        _close(got, want, units=UQI_UNITS[case], context=case)


@pytest.mark.parametrize("case", sorted(CLASS_CASES))
def test_classes_match_the_jax_package(case):
    """forward on the first batch (its own value), update on the second (cat states bit
    for bit, sum states and values within tolerance), merge_state and a checkpoint from
    the JAX package. One JAX metric a case: each JAX metric compiles its update anew."""
    name, kw, kind = CLASS_CASES[case]
    jax_metric, port_metric = getattr(jtm.image, name)(**kw), getattr(ttm.image, name)(**kw, **CPU)
    batch_value = port_metric(*_class_args(kind, 0, _torch))
    if kind == "pan":
        # JAX-side fault, not copied: its forward computes on the batch's state, which
        # lacks "pan_lr" when none was given (KeyError) before folding the batch in; the
        # port's forward gives the batch's value, held against the JAX function
        with pytest.raises(KeyError, match="pan_lr"):
            jax_metric(*_class_args(kind, 0, _jnp))
        jax_metric.update(*_class_args(kind, 0, _jnp))  # the failed forward folded nothing
        fn = "spatial_distortion_index" if name == "SpatialDistortionIndex" else "quality_with_no_reference"
        jax_batch = _jitted(fn, tuple(sorted(kw.items())))(*_j(FUSED[0], MS[0], PAN[0]))
    else:
        jax_batch = jax_metric(*_class_args(kind, 0, _jnp))
    if case.startswith("sam"):
        _close(batch_value, jax_batch, tol=np.sqrt(16 * U) if _np(jax_batch).size == 1 else _angle_tolerance(
            _np(jax_batch).astype(np.float64)), context=f"{case} forward")
    else:
        _hold(batch_value, jax_batch, case)
    jax_metric.update(*_class_args(kind, 1, _jnp))
    port_metric.update(*_class_args(kind, 1, _torch))
    for key, value in port_metric._state.items():
        if isinstance(value, list) and not value:
            assert jax_metric._state[key] == [], (case, key)
            continue
        got = torch.cat(value) if isinstance(value, list) else value
        want = jax_metric._state[key]
        want = np.concatenate([np.asarray(x) for x in want]) if isinstance(want, list) else np.asarray(want)
        if not got.is_floating_point() or isinstance(value, list):
            assert _np(got).dtype == want.dtype and np.array_equal(_np(got), want), (case, key)
        elif key == "sum_sam":
            _hold(got, want, "sam_sum")
        else:
            _close(got, want, context=f"{case} {key}")
    if "pan_lr" in port_metric._state:
        assert len(port_metric.pan_lr) == (2 if kind == "pan_lr" else 0)
    want = jax_metric.compute()
    _hold(port_metric.compute(), want, case)
    a, b = (getattr(ttm.image, name)(**kw, **CPU) for _ in range(2))
    a.update(*_class_args(kind, 0, _torch))
    b.update(*_class_args(kind, 1, _torch))
    a.merge_state(b)
    _hold(a.compute(), want, case)
    jax_metric.persistent(True)
    restored = getattr(ttm.image, name)(**kw, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _hold(restored.compute(), want, case)


@pytest.mark.parametrize("build", [
    lambda m, **d: m.image.SpectralAngleMapper(reduction="max", **d),
    lambda m, **d: m.image.ErrorRelativeGlobalDimensionlessSynthesis(reduction="max", **d),
    lambda m, **d: m.image.SpectralDistortionIndex(p=0, **d),
    lambda m, **d: m.image.SpectralDistortionIndex(reduction=None, **d),
    lambda m, **d: m.image.SpatialDistortionIndex(norm_order=0, **d),
    lambda m, **d: m.image.SpatialDistortionIndex(window_size=-2, **d),
    lambda m, **d: m.image.QualityWithNoReference(alpha=-1, **d),
    lambda m, **d: m.image.QualityWithNoReference(beta=-1, **d),
    lambda m, **d: m.image.QualityWithNoReference(reduction="max", **d),
], ids=["sam", "ergas", "d_lambda_p", "d_lambda_reduction", "d_s_norm", "d_s_window", "qnr_alpha", "qnr_beta",
        "qnr_reduction"])
def test_constructor_errors_like_the_jax_package(build):
    with pytest.raises(ValueError) as jax_err:
        build(jtm)
    with pytest.raises(ValueError) as port_err:
        build(ttm, **CPU)
    assert str(port_err.value) == str(jax_err.value)


def test_pan_target_needs_ms_and_pan():
    for lib, make in ((jtm, _jnp), (ttm, _torch)):
        metric = lib.image.SpatialDistortionIndex(**({} if lib is jtm else CPU))
        with pytest.raises(ValueError, match="ms and pan"):
            metric.update(make(FUSED[0]), {"ms": make(MS[0])})


# ------------------------------------------------------- float64 and mixed inputs

_WIDE = {name: arr[0].astype(np.float64) + 1e-9 * _RNG.standard_normal(arr[0].shape)
         for name, arr in (("fused", FUSED), ("ms", MS), ("pan", PAN), ("pan_lr", PAN_LR))}
PAN_FLOAT64 = {
    "spectral_distortion_index": ("fused", "ms"),
    "spatial_distortion_index": ("fused", "ms", "pan"),
    "quality_with_no_reference": ("fused", "ms", "pan"),
}


@pytest.mark.parametrize("name", sorted(PAN_FLOAT64))
@pytest.mark.parametrize("narrow", ["none", "fused", "ms"])
def test_pan_float64_and_mixed_inputs_round_to_float32_as_in_the_jax_package(name, narrow):
    """float64 inputs, alone or beside a float32 one, give float32 values equal to the
    float32 inputs' bit for bit; JAX's are float32 too."""
    args = tuple(_WIDE[k].astype(np.float32) if k == narrow else _WIDE[k] for k in PAN_FLOAT64[name])
    rounded = tuple(_WIDE[k].astype(np.float32) for k in PAN_FLOAT64[name])
    want = getattr(jax_fn, name)(*args)
    got = getattr(port_fn, name)(*_t(*args))
    assert _np(got).dtype == np.asarray(want).dtype == np.float32
    ref = getattr(port_fn, name)(*_t(*rounded))
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("case", ["d_lambda", "d_s", "d_s_lr", "qnr"])
def test_pan_float64_class_updates_give_float32_as_in_the_jax_package(case):
    name, kw, kind = CLASS_CASES[case]
    wide = lambda a: torch.from_numpy(a.astype(np.float64) + 1e-9)
    narrow = lambda a: torch.from_numpy((a.astype(np.float64) + 1e-9).astype(np.float32))
    metric = getattr(ttm.image, name)(**kw, **CPU)
    metric.update(*_class_args(kind, 0, wide))
    twin = getattr(ttm.image, name)(**kw, **CPU)
    twin.update(*_class_args(kind, 0, narrow))
    jax_metric = getattr(jtm.image, name)(**kw)
    jax_metric.update(*_class_args(kind, 0, lambda a: np.asarray(a, np.float64) + 1e-9))
    got = metric.compute()
    assert _np(got).dtype == np.asarray(jax_metric.compute()).dtype == np.float32, case
    np.testing.assert_array_equal(_np(got), _np(twin.compute()))
