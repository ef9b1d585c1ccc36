"""The port's image-quality metrics against the JAX package, on the CPU: the filter and
padding helpers, PSNR, PSNR-B, SSIM and MS-SSIM (2-D and 3-D), UQI, VIF, TV, RMSE-SW,
RASE, SCC and the image gradients, as functions and as classes.

The same numpy inputs, made from a seed, go through the JAX package and the port
(``device="cpu"``). Shapes are few, because JAX compiles every op per shape:
``(2, 3, 48, 48)`` for most cases (it clears VIF's 41 x 41 and MS-SSIM's three betas),
``(1, 1, 180, 180)`` for MS-SSIM's five default betas, ``(1, 1, 24, 24, 24)`` for 3-D.

Tolerances, with ``u = 2**-24`` (float32's rounding unit):

- integer states and counts (``total``, ``numel``, ``num_elements``), the gradients, the
  pad gathers and the integer TV bit for bit;
- the float sums that the port takes in float64 and rounds once (PSNR's squared error,
  TV, ERGAS's band sums) within 1e-6 relative of JAX's float32 sums;
- the values of the convolution-based metrics (SSIM, MS-SSIM, UQI, VIF, SCC, RMSE-SW,
  RASE) within ``32 u`` of their magnitude (at least 1): the convolutions sum 9 to 1,331
  taps in another order than XLA's CPU convolution (oneDNN's), and the means over the
  maps add in float64 where JAX adds in float32;
- a per-pixel map (SSIM's full image, UQI's ``"none"``, RMSE-SW's map) within
  ``taps * u`` of its magnitude for a box window, ``2 * taps * u`` for a gaussian one:
  one conv output carries at most about one rounding unit a tap between two orders of
  summation, and one more a tap where the weights differ in their last bit (the port
  rounds the gaussian window from float64, JAX computes it in float32).
"""

from __future__ import annotations

import functools
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError

jax_utils = importlib.import_module("torchmetrics_tpu.functional.image.utils")
port_utils = importlib.import_module("torchmetrics_tpu_torch.functional.image.utils")
jax_scc = importlib.import_module("torchmetrics_tpu.functional.image.scc")
port_scc = importlib.import_module("torchmetrics_tpu_torch.functional.image.scc")

CPU = {"device": "cpu"}
U = 2.0**-24
_RNG = np.random.default_rng(1414)
SHAPE = (2, 3, 48, 48)
PREDS = _RNG.random((2, *SHAPE), dtype=np.float32)  # two batches
TARGET = np.clip(PREDS + 0.1 * _RNG.standard_normal(PREDS.shape).astype(np.float32), 0, 1)
# smooth grayscale targets, and predictions with 8 x 8 block offsets as a block codec
# leaves them (so the block effect is not 0)
_YX = np.mgrid[0:48, 0:48].astype(np.float32)
_SMOOTH = (0.5 + 0.3 * np.sin(_YX[1] / 7.0 + _RNG.random((2, 2, 1, 1, 1)) * 6) * np.cos(_YX[0] / 5.0)).astype(np.float32)
_BLOCKS = np.kron(0.05 * _RNG.standard_normal((2, 2, 1, 6, 6)), np.ones((8, 8))).astype(np.float32)
GRAY = (np.clip(_SMOOTH + _BLOCKS, 0, 1).astype(np.float32), _SMOOTH)
BIG = _RNG.random((2, 1, 1, 180, 180), dtype=np.float32)
BIG_TARGET = np.clip(BIG + 0.1 * _RNG.standard_normal(BIG.shape).astype(np.float32), 0, 1)
VOLUME = _RNG.random((2, 1, 1, 24, 24, 24), dtype=np.float32)
VOLUME_TARGET = np.clip(VOLUME + 0.1 * _RNG.standard_normal(VOLUME.shape).astype(np.float32), 0, 1)
UINT8 = np.random.default_rng(0).integers(0, 256, (1, 3, 32, 32), dtype=np.uint8)
CONSTANT = np.zeros(SHAPE, np.float32)  # every conv of it is exactly 0, in any order of summation


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _bitwise(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    np.testing.assert_array_equal(p, r, err_msg=context)


def _close(port, ref, units: float = 32, context: str = "", relative: float = 0.0) -> None:
    """Within ``units`` rounding units of the magnitude (at least 1), or ``relative`` of
    the value when given; NaN by place, equal infinities pass."""
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    p64, r64 = p.astype(np.float64), r.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(p64), np.isnan(r64), err_msg=context)
    tol = relative * np.abs(r64) if relative else units * U * np.maximum(np.abs(r64), 1.0)
    keep = ~np.isnan(r64) & (p64 != r64)
    assert np.all(np.abs(p64[keep] - r64[keep]) <= tol[keep]), (
        f"{context}: worst {np.max(np.abs(p64 - r64)[keep]) if keep.any() else 0} against {tol.min()}")


@functools.lru_cache(maxsize=None)
def _jitted(fn_name: str, kw_items: tuple):
    """The JAX function under ``jax.jit``: one compile a call pattern, where running it
    op by op compiles every op per shape (VIF: 12 s against 1.6)."""
    return jax.jit(functools.partial(getattr(jax_fn, fn_name), **dict(kw_items)))


def _both(fn_name: str, *arrays, **kw):
    """(JAX's value, the port's value) of ``functional.<fn_name>`` on the same arrays."""
    return _jitted(fn_name, tuple(sorted(kw.items())))(*_j(*arrays)), getattr(port_fn, fn_name)(*_t(*arrays), **kw)


# ---------------------------------------------------------------------------- helpers

@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("size, before, after", [(1, 2, 3), (2, 5, 0), (5, 4, 4), (5, 5, 9), (6, 13, 2), (7, 0, 20)])
def test_pad_gather_is_jnp_pad_at_any_pad(mode, size, before, after):
    """Pads as large as the image and larger: ``F.pad`` refuses those in reflect mode and
    has no symmetric mode; the gather gives ``jnp.pad``'s result."""
    x = np.arange(3 * size * (size + 1), dtype=np.float32).reshape(1, 3, size, size + 1)
    want = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (before, after), (after, before)), mode=mode)
    got = port_utils._pad(torch.from_numpy(x), ((before, after), (after, before)), mode)
    _bitwise(got, want, f"{mode} {size} {before} {after}")


@pytest.mark.parametrize("pad, outer", [(4, 0), (3, 1), (0, 1), (24, 0), (40, 1)])
def test_symmetric_pad_with_its_asymmetric_tail(pad, outer):
    x = PREDS[0, :1, :1]
    _bitwise(port_utils._symmetric_pad_2d(*_t(x), pad, outer), jax_utils._symmetric_pad_2d(*_j(x), pad, outer))


def test_reflect_pads_and_scc_symmetric_pad_match_the_jax_helpers():
    x = PREDS[0, :1, :1, :7, :9]
    _bitwise(port_utils.reflect_pad_2d(*_t(x), 7, 10), jax_utils.reflect_pad_2d(*_j(x), 7, 10))
    v = VOLUME[0, :, :, :5, :6, :7]
    _bitwise(port_utils.reflect_pad_3d(*_t(v), 5, 2, 8), jax_utils.reflect_pad_3d(*_j(v), 5, 2, 8))
    _bitwise(port_scc._symmetric_reflect_pad_2d(*_t(x), (1, 2, 9, 0)),
             jax_scc._symmetric_reflect_pad_2d(*_j(x), (1, 2, 9, 0)))
    with pytest.raises(ValueError):
        jax_scc._symmetric_reflect_pad_2d(*_j(x), (1, 2, 3))
    with pytest.raises(ValueError):
        port_scc._symmetric_reflect_pad_2d(*_t(x), (1, 2, 3))


@pytest.mark.parametrize("ks, sigma", [((11, 11), (1.5, 1.5)), ((7, 3), (1.0, 0.5)), ((11, 5, 3), (1.5, 1.0, 2.0))])
def test_gaussian_kernels_are_jaxs_products_of_1d_windows(ks, sigma):
    build = "_gaussian_kernel_2d" if len(ks) == 2 else "_gaussian_kernel_3d"
    want = getattr(jax_utils, build)(3, ks, sigma)
    got = getattr(port_utils, build)(3, ks, sigma)
    assert tuple(got.shape) == tuple(want.shape) == (3, 1, *ks)
    _close(got, want, units=2, context=build)  # exp and an 11-term sum, 1-2 units apart


def test_integer_windows_raise_overflow_error_like_jnp_arange():
    with pytest.raises(OverflowError) as jax_err:
        jax_utils._gaussian_kernel_2d(1, (11, 11), (1.5, 1.5), jnp.uint8)
    with pytest.raises(OverflowError) as port_err:
        port_utils._gaussian_kernel_2d(1, (11, 11), (1.5, 1.5), torch.uint8)
    assert str(port_err.value) == str(jax_err.value)


def test_convolutions_run_with_tf32_off_and_restore_the_callers_flags(monkeypatch):
    seen = []

    def spy(x, w, groups=1):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return x[..., : x.shape[-2] - w.shape[-2] + 1, : x.shape[-1] - w.shape[-1] + 1]

    monkeypatch.setattr(port_utils.F, "conv2d", spy)
    prior = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        port_utils.conv2d(torch.ones(1, 1, 5, 5), torch.ones(1, 1, 3, 3))
        assert seen == [(False, False)]
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prior


def test_single_channel_batches_convolve_as_one_depthwise_conv_with_the_same_bits():
    """A batch of single-channel images under a single-channel kernel goes as one
    depthwise conv (the batch in the channel axis): each output is the same sum."""
    rng = np.random.default_rng(5)
    x, k = torch.from_numpy(rng.random((6, 1, 40, 50), dtype=np.float32)), torch.rand(1, 1, 17, 17)
    _bitwise(port_utils.conv2d(x, k), torch.nn.functional.conv2d(x, k))
    v, k3 = torch.from_numpy(rng.random((4, 1, 20, 20, 20), dtype=np.float32)), torch.rand(1, 1, 11, 11, 11)
    _bitwise(port_utils.conv3d(v, k3), torch.nn.functional.conv3d(v, k3))


@pytest.mark.parametrize("batch, channels", [(1, 3), (5, 3), (4, 8)])
def test_grouped_depthwise_convs_fold_the_batch_into_channels_with_the_same_bits(batch, channels):
    """A grouped conv with one channel a group (SSIM's and UQI's windows) goes as one
    depthwise conv over ``(1, B C)``: each output is the same sum as the grouped call's.
    A kernel with more than one input channel a group keeps the plain call."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((batch, channels, 30, 40), dtype=np.float32))
    k = torch.from_numpy(rng.random((channels, 1, 11, 7), dtype=np.float32))
    _bitwise(port_utils.conv2d(x, k, groups=channels), torch.nn.functional.conv2d(x, k, groups=channels))
    v = torch.from_numpy(rng.random((batch, channels, 14, 14, 14), dtype=np.float32))
    k3 = torch.from_numpy(rng.random((channels, 1, 5, 5, 5), dtype=np.float32))
    _bitwise(port_utils.conv3d(v, k3, groups=channels), torch.nn.functional.conv3d(v, k3, groups=channels))
    full = torch.from_numpy(rng.random((2, channels, 3, 3), dtype=np.float32))
    _bitwise(port_utils.conv2d(x, full), torch.nn.functional.conv2d(x, full))


@pytest.mark.parametrize("window", [7, 8])
def test_uniform_filter_and_pools(window):
    x = PREDS[0]
    _close(port_utils.uniform_filter(*_t(x), window), jax_utils.uniform_filter(*_j(x), window), units=window**2)
    _close(port_utils.avg_pool2d(*_t(x)), jax_utils.avg_pool2d(*_j(x)), units=1)
    v = VOLUME[0]
    _close(port_utils.avg_pool3d(*_t(v)), jax_utils.avg_pool3d(*_j(v)), units=1)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "mean", "sum", "none", None])
def test_reduce_with_the_mean_alias(reduction):
    x = PREDS[0, 0]
    _close(port_utils.reduce(*_t(x), reduction), jax_utils.reduce(*_j(x), reduction), units=4)


def test_reduce_and_the_pair_check_raise_like_the_jax_package():
    for bad in ("max",):
        with pytest.raises(ValueError):
            jax_utils.reduce(jnp.ones(2), bad)
        with pytest.raises(ValueError):
            port_utils.reduce(torch.ones(2), bad)
    for preds, target, error in ((PREDS[0], TARGET[0].astype(np.int32), TypeError),
                                 (PREDS[0], TARGET[0, :1], RuntimeError), (PREDS[0, 0], TARGET[0, 0], ValueError)):
        with pytest.raises(error):
            jax_utils._check_image_pair(*_j(preds, target))
        with pytest.raises(error):
            port_utils._check_image_pair(*_t(preds, target))


# ---------------------------------------------------------------------------- functions

def test_image_gradients_bit_for_bit_and_their_errors():
    for want, got in zip(*_both("image_gradients", PREDS[0])):
        _bitwise(got, want)
    for want, got in zip(*_both("image_gradients", UINT8)):  # uint8 differences wrap in both
        _bitwise(got, want)
    with pytest.raises(TypeError):
        jax_fn.image_gradients([1.0])
    with pytest.raises(TypeError):
        port_fn.image_gradients([1.0])
    with pytest.raises(RuntimeError):
        jax_fn.image_gradients(jnp.ones((3, 4, 4)))
    with pytest.raises(RuntimeError):
        port_fn.image_gradients(torch.ones(3, 4, 4))


@pytest.mark.parametrize("kw", [
    {"data_range": 1.0}, {"data_range": (0.1, 0.9)}, {"data_range": 1.0, "base": 2.0},
    {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, {"data_range": 1.0, "dim": 1, "reduction": "sum"},
    {"data_range": 1.0, "dim": (2, 3), "reduction": "elementwise_mean"},
], ids=["float", "tuple", "base2", "dim123_none", "dim1_sum", "dim23_mean"])
def test_psnr(kw):
    want, got = _both("peak_signal_noise_ratio", PREDS[0], TARGET[0], **kw)
    _close(got, want, context=str(kw))  # the log of a float64 sum rounded once against JAX's float32 sum


def test_psnr_casts_integers_the_compat_default_and_the_warning():
    """uint8 inputs are cast to float32. Their squares (up to 65,025) are exact, and
    the port's float64 sum of them rounded once is the exact sum's float32; JAX's float32
    sum of the 3,072 squares carries up to ``n u`` of relative error (it adds numbers
    near 1e8 in float32), so the values in dB agree within ``10 / ln 10 * n u``."""
    preds, target = UINT8, UINT8[:, ::-1]
    want, got = _both("peak_signal_noise_ratio", preds, target, data_range=255.0)
    assert got.dtype == torch.float32
    _close(got, want, relative=10 / np.log(10) * preds.size * U / abs(float(want)))
    exact = ((preds.astype(np.float64) - target) ** 2).sum()
    _close(got, np.float32(20 * np.log10(255.0) - 10 * np.log10(exact / preds.size)))
    _close(port_fn.peak_signal_noise_ratio(*_t(PREDS[0], TARGET[0])), jax_fn.peak_signal_noise_ratio(*_j(PREDS[0], TARGET[0])))
    with pytest.raises(TypeError):  # the strict export needs data_range
        port_fn.image.peak_signal_noise_ratio(*_t(PREDS[0], TARGET[0]))
    with pytest.warns(UserWarning, match="will not have any effect"):
        port_fn.peak_signal_noise_ratio(*_t(PREDS[0], TARGET[0]), reduction="sum")
    sse, num_obs = importlib.import_module("torchmetrics_tpu_torch.functional.image.psnr")._psnr_update(
        *_t(PREDS[0], TARGET[0]), dim=(1, 2, 3))
    assert num_obs.dtype == torch.int32 and num_obs.tolist() == [3 * 48 * 48] * 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, got = _both("peak_signal_noise_ratio", PREDS[0], TARGET[0], data_range=1.0, dim=(), reduction="none")
    _close(got, want)  # dim=() reduces nothing in jnp.sum, and so in the port


def test_squared_error_sums_are_the_exact_sums_rounded_once():
    """The port's float64 sums of the float32 squares, rounded once, equal numpy's
    float64 sums of the same squares rounded once."""
    psnr = importlib.import_module("torchmetrics_tpu_torch.functional.image.psnr")
    psnrb = importlib.import_module("torchmetrics_tpu_torch.functional.image.psnrb")
    squares = (PREDS[0] - TARGET[0]) ** 2
    sse, _ = psnr._psnr_update(*_t(PREDS[0], TARGET[0]))
    _bitwise(sse, np.float32(squares.sum(dtype=np.float64)))
    sse, _ = psnr._psnr_update(*_t(PREDS[0], TARGET[0]), dim=(1, 2, 3))
    _bitwise(sse, squares.sum((1, 2, 3), dtype=np.float64).astype(np.float32))
    sse, _, _ = psnrb._psnrb_update(*_t(GRAY[0][0], GRAY[1][0]))
    _bitwise(sse, np.float32(((GRAY[0][0] - GRAY[1][0]) ** 2).sum(dtype=np.float64)))


@pytest.mark.parametrize("kw", [{"data_range": 1.0}, {"data_range": (0.2, 0.8), "block_size": 4}])
def test_psnrb(kw):
    want, got = _both("peak_signal_noise_ratio_with_blocked_effect", *(g[0] for g in GRAY), **kw)
    _close(got, want)


def test_psnrb_on_three_channels_raises():
    for lib, make in ((jax_fn, _j), (port_fn, _t)):
        with pytest.raises(ValueError, match="grayscale"):
            lib.peak_signal_noise_ratio_with_blocked_effect(*make(PREDS[0], TARGET[0]), data_range=1.0)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_total_variation(reduction):
    want, got = _both("total_variation", PREDS[0], reduction=reduction)
    _close(got, want, relative=1e-6)


def test_total_variation_of_uint8_wraps_as_jax_does():
    """JAX-side quirk kept: uint8 differences wrap modulo 256 and the sums are uint32
    (``jnp.sum``'s dtype for unsigned inputs); the port returns uint32 too."""
    want, got = _both("total_variation", UINT8)
    _bitwise(got, want)
    assert got.dtype == torch.uint32 and int(got) == 758809
    want, got = _both("total_variation", UINT8, reduction="mean")
    _bitwise(got, want)
    with pytest.raises(ValueError):
        port_fn.total_variation(*_t(PREDS[0]), reduction="max")
    with pytest.raises(RuntimeError):
        port_fn.total_variation(torch.ones(3, 4, 4))


SSIM_CASES = {
    "range1": {"data_range": 1.0, "reduction": "none"},
    "range_none": {"reduction": "none"},
    "range_tuple": {"data_range": (0.1, 0.9)},
    "uniform": {"gaussian_kernel": False, "kernel_size": 7, "data_range": 1.0, "reduction": "sum"},
    "anisotropic": {"sigma": (1.5, 0.8), "data_range": 1.0, "reduction": "none"},
    "k": {"k1": 0.02, "k2": 0.05, "data_range": 1.0},
}


@pytest.mark.parametrize("case", sorted(SSIM_CASES))
def test_ssim(case):
    want, got = _both("structural_similarity_index_measure", PREDS[0], TARGET[0], **SSIM_CASES[case])
    _close(got, want, context=case)


@pytest.mark.parametrize("flag", ["return_full_image", "return_contrast_sensitivity"])
def test_ssim_full_image_and_contrast(flag):
    want, got = _both("structural_similarity_index_measure", PREDS[0], TARGET[0], data_range=1.0, **{flag: True})
    _close(got[0], want[0])
    _close(got[1], want[1], units=242, context=flag)  # a map of 11 x 11-tap gaussian conv outputs (or its mean)


def test_ssim_3d():
    want, got = _both("structural_similarity_index_measure", VOLUME[0], VOLUME_TARGET[0], data_range=1.0,
                      reduction="none")
    _close(got, want)
    want, got = _both("structural_similarity_index_measure", VOLUME[0], VOLUME_TARGET[0],
                      return_contrast_sensitivity=True, sigma=(1.5, 1.0, 0.5))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("normalize", ["relu", "simple", None])
def test_ms_ssim_three_betas(normalize):
    want, got = _both("multiscale_structural_similarity_index_measure", PREDS[0], TARGET[0], data_range=1.0,
                      betas=(0.3, 0.3, 0.4), normalize=normalize, reduction="none")
    _close(got, want, context=str(normalize))


def test_ms_ssim_default_betas_and_3d():
    want, got = _both("multiscale_structural_similarity_index_measure", BIG[0], BIG_TARGET[0], data_range=1.0)
    _close(got, want)
    want, got = _both("multiscale_structural_similarity_index_measure", VOLUME[0], VOLUME_TARGET[0],
                      betas=(0.5, 0.5), reduction="sum")
    _close(got, want)


@pytest.mark.parametrize("fn, kw", [
    ("structural_similarity_index_measure", {"kernel_size": (11, 11, 11)}),
    ("structural_similarity_index_measure", {"sigma": (1.5,)}),
    ("structural_similarity_index_measure", {"return_full_image": True, "return_contrast_sensitivity": True}),
    ("structural_similarity_index_measure", {"kernel_size": 4, "gaussian_kernel": False}),
    ("structural_similarity_index_measure", {"sigma": -1.0}),
    ("multiscale_structural_similarity_index_measure", {"betas": (1, 2)}),
    ("multiscale_structural_similarity_index_measure", {"normalize": "max"}),
    ("multiscale_structural_similarity_index_measure", {}),
], ids=["ks_dims", "sigma_dims", "exclusive", "even_kernel", "negative_sigma", "int_betas", "normalize",
        "too_small_for_five_betas"])
def test_ssim_errors_like_the_jax_package(fn, kw):
    for lib, make in ((jax_fn, _j), (port_fn, _t)):
        with pytest.raises(ValueError):
            getattr(lib, fn)(*make(PREDS[0], TARGET[0]), data_range=1.0, **kw)
    for lib, make in ((jax_fn, _j), (port_fn, _t)):
        with pytest.raises(RuntimeError):
            getattr(lib, fn)(*make(PREDS[0], TARGET[0, :, :2]))


@pytest.mark.parametrize("fn", ["structural_similarity_index_measure", "universal_image_quality_index"])
def test_uint8_inputs_raise_overflow_error_in_both(fn):
    """JAX-side quirk kept: the gaussian window is built in the input's dtype, and
    ``jnp.arange`` refuses uint8's negative taps."""
    for lib, make in ((jax_fn, _j), (port_fn, _t)):
        with pytest.raises(OverflowError):
            getattr(lib, fn)(*make(UINT8, UINT8))


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_uqi(reduction):
    want, got = _both("universal_image_quality_index", PREDS[0], TARGET[0], reduction=reduction)
    _close(got, want, units=242 if reduction == "none" else 32)


def test_uqi_keeps_jaxs_swapped_pads():
    """JAX-side quirk kept: H is padded by the width's half-kernel and W by the
    height's, so an (11, 7) window on 40 x 40 gives a 26 x 38 map (30 x 30 at 11 x 11)."""
    x, y = PREDS[0, :1, :, :40, :40], TARGET[0, :1, :, :40, :40]
    want, got = _both("universal_image_quality_index", x, y, kernel_size=(11, 7), sigma=(1.5, 1.0),
                      reduction="none")
    assert tuple(got.shape) == tuple(want.shape) == (1, 3, 26, 38)
    _close(got, want, units=154)
    want, got = _both("universal_image_quality_index", x, y, reduction="none")
    assert tuple(got.shape) == tuple(want.shape) == (1, 3, 30, 30)
    for kw in ({"kernel_size": (11,)}, {"kernel_size": (4, 4)}, {"sigma": (1.5, 0.0)}):
        for lib, make in ((jax_fn, _j), (port_fn, _t)):
            with pytest.raises(ValueError):
                lib.universal_image_quality_index(*make(x, y), **kw)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_vif(reduction):
    want, got = _both("visual_information_fidelity", PREDS[0], TARGET[0], reduction=reduction)
    _close(got, want)


def test_vif_and_scc_on_constant_images_hit_their_zero_guards():
    """A zero target: VIF's masks zero every term (0 / 0, NaN, in both); SCC's zero
    denominators give 0. (A constant other than 0 leaves local variances of a few
    rounding units whose sign depends on the order of summation: JAX's own eager and
    jitted runs then give NaN and inf.)"""
    want, got = _both("visual_information_fidelity", PREDS[0], CONSTANT, reduction="none")
    _close(got, want)
    assert bool(torch.isnan(got).all())
    want, got = _both("spatial_correlation_coefficient", PREDS[0], CONSTANT, reduction="none")
    _bitwise(got, want)
    assert got.tolist() == [0.0, 0.0]
    for lib, make in ((jax_fn, _j), (port_fn, _t)):
        with pytest.raises(ValueError, match="41x41"):
            lib.visual_information_fidelity(*make(PREDS[0, :, :, :40], TARGET[0, :, :, :40]))
        with pytest.raises(ValueError):
            lib.visual_information_fidelity(*make(PREDS[0], TARGET[0]), reduction="sum")


@pytest.mark.parametrize("kw", [{}, {"reduction": "none"}, {"reduction": None, "window_size": 5},
                                {"hp_filter": np.asarray([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)}],
                         ids=["mean", "none", "window5", "laplacian4"])
def test_scc(kw):
    want = jax_fn.spatial_correlation_coefficient(*_j(PREDS[0], TARGET[0]), **{
        k: (jnp.asarray(v) if k == "hp_filter" else v) for k, v in kw.items()})
    got = port_fn.spatial_correlation_coefficient(*_t(PREDS[0], TARGET[0]), **{
        k: (torch.from_numpy(v) if k == "hp_filter" else v) for k, v in kw.items()})
    _close(got, want)


def test_scc_grayscale_batches_and_errors():
    want, got = _both("spatial_correlation_coefficient", PREDS[0, :, 0], TARGET[0, :, 0], reduction="none")
    _close(got, want)
    for kw, error in (({"reduction": "sum"}, ValueError), ({"window_size": 49}, ValueError),
                      ({"window_size": 0}, ValueError)):
        for lib, make in ((jax_fn, _j), (port_fn, _t)):
            with pytest.raises(error):
                lib.spatial_correlation_coefficient(*make(PREDS[0], TARGET[0]), **kw)


@pytest.mark.parametrize("window", [7, 8, 5])
def test_rmse_sw_and_rase(window):
    want, got = _both("root_mean_squared_error_using_sliding_window", PREDS[0], TARGET[0], window_size=window,
                      return_rmse_map=True)
    _close(got[0], want[0])
    _close(got[1], want[1], units=window**2)
    want, got = _both("relative_average_spectral_error", PREDS[0], TARGET[0], window_size=window)
    _close(got, want)


def test_rmse_sw_errors():
    for lib, make in ((jax_fn, _j), (port_fn, _t)):
        with pytest.raises(ValueError):
            lib.root_mean_squared_error_using_sliding_window(*make(PREDS[0], TARGET[0]), window_size=0)
        with pytest.raises(ValueError, match="round"):
            lib.root_mean_squared_error_using_sliding_window(*make(PREDS[0], TARGET[0]), window_size=97)
        with pytest.raises(ValueError):
            lib.relative_average_spectral_error(*make(PREDS[0], TARGET[0]), window_size=-1)


# ---------------------------------------------------------------------------- classes

CLASS_CASES = {
    "psnr": ("PeakSignalNoiseRatio", {"data_range": 1.0}, "pair"),
    "psnr_dim": ("PeakSignalNoiseRatio", {"data_range": (0.0, 1.0), "dim": (1, 2, 3), "reduction": "none"}, "pair"),
    "psnrb": ("PeakSignalNoiseRatioWithBlockedEffect", {"data_range": 1.0}, "gray"),
    "ssim": ("StructuralSimilarityIndexMeasure", {"data_range": 1.0}, "pair"),
    "ssim_none": ("StructuralSimilarityIndexMeasure", {"reduction": "none"}, "pair"),
    "ssim_full": ("StructuralSimilarityIndexMeasure", {"data_range": 1.0, "return_full_image": True}, "pair"),
    "ssim_3d": ("StructuralSimilarityIndexMeasure", {"data_range": 1.0, "reduction": "sum"}, "volume"),
    "ms_ssim": ("MultiScaleStructuralSimilarityIndexMeasure", {"data_range": 1.0, "betas": (0.3, 0.3, 0.4)},
                "pair"),
    "ms_ssim_none": ("MultiScaleStructuralSimilarityIndexMeasure",
                     {"betas": (0.5, 0.5), "reduction": "none", "normalize": "simple"}, "pair"),
    "uqi": ("UniversalImageQualityIndex", {}, "pair"),
    "uqi_none": ("UniversalImageQualityIndex", {"reduction": "none"}, "pair"),
    "vif": ("VisualInformationFidelity", {}, "pair"),
    "tv": ("TotalVariation", {}, "image"),
    "tv_mean": ("TotalVariation", {"reduction": "mean"}, "image"),
    "tv_none": ("TotalVariation", {"reduction": "none"}, "image"),
    "scc": ("SpatialCorrelationCoefficient", {}, "pair"),
    "rase": ("RelativeAverageSpectralError", {}, "pair"),
    "rmse_sw": ("RootMeanSquaredErrorUsingSlidingWindow", {"window_size": 7}, "pair"),
}
MAP_OUTPUTS = {"uqi_none": 242, "ssim_full": 242}  # 11 x 11 gaussian maps
# float64 sums rounded once in the port, float32 sums in JAX: held within 1e-6 relative,
# or within JAX's own float32 summation error, n u relative over n terms, where larger
FLOAT_SUMS = {"sum_squared_error", "score"}


def _class_batches(kind: str):
    if kind == "pair":
        return [(PREDS[i], TARGET[i]) for i in range(2)]
    if kind == "gray":
        return [(GRAY[0][i], GRAY[1][i]) for i in range(2)]
    if kind == "volume":
        return [(VOLUME[i], VOLUME_TARGET[i]) for i in range(2)]
    return [(PREDS[i],) for i in range(2)]


def _state(value):
    return torch.cat(value) if isinstance(value, list) else value


def _hold_states(port_metric, jax_metric, case: str, terms: int = 0) -> None:
    for key, value in port_metric._state.items():
        got = _state(value)
        want = jax_metric._state[key]
        want = np.concatenate([np.asarray(x) for x in want]) if isinstance(want, list) else np.asarray(want)
        if not got.is_floating_point():
            _bitwise(got, want, f"{case} {key}")
        elif key in FLOAT_SUMS:
            _close(got, want, context=f"{case} {key}", relative=max(1e-6, terms * U))
        else:
            _close(got, want, units=MAP_OUTPUTS.get(case, 32), context=f"{case} {key}")


def _hold_values(got, want, case: str, context: str = "") -> None:
    if isinstance(want, tuple):
        _close(got[0], want[0], context=f"{case} {context}")
        _close(got[1], want[1], units=MAP_OUTPUTS.get(case, 32), context=f"{case} {context}")
    else:
        _close(got, want, units=MAP_OUTPUTS.get(case, 32), context=f"{case} {context}")


@pytest.mark.parametrize("case", sorted(CLASS_CASES))
def test_classes_match_the_jax_package(case):
    """forward on the first batch (its own value), update on the second (states and
    compute over both), merge_state and a checkpoint from the JAX package loaded into
    the port. One JAX metric a case: each JAX metric compiles its update anew."""
    name, kw, kind = CLASS_CASES[case]
    batches = _class_batches(kind)
    jax_metric, port_metric = getattr(jtm.image, name)(**kw), getattr(ttm.image, name)(**kw, **CPU)
    _hold_values(port_metric(*_t(*batches[0])), jax_metric(*_j(*batches[0])), case, "forward")
    jax_metric.update(*_j(*batches[1]))
    port_metric.update(*_t(*batches[1]))
    terms = sum(batch[0].size for batch in batches)
    _hold_states(port_metric, jax_metric, case, terms)
    want = jax_metric.compute()
    _hold_values(port_metric.compute(), want, case)
    # merge_state of one metric a batch gives the two batches' value
    a, b = (getattr(ttm.image, name)(**kw, **CPU) for _ in range(2))
    a.update(*_t(*batches[0]))
    b.update(*_t(*batches[1]))
    a.merge_state(b)
    _hold_values(a.compute(), want, case, "merged")
    # the JAX package's checkpoint loads into the port
    jax_metric.persistent(True)
    restored = getattr(ttm.image, name)(**kw, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _hold_states(restored, jax_metric, f"{case} restored", terms)
    _hold_values(restored.compute(), want, case, "restored")


def test_state_dtypes_are_the_jax_packages():
    """float32 sums and int32 counts (``np.zeros(())`` defaults are float32 under JAX
    with x64 off; the port passes float32 explicitly)."""
    for case, (name, kw, _) in CLASS_CASES.items():
        jax_metric, port_metric = getattr(jtm.image, name)(**kw), getattr(ttm.image, name)(**kw, **CPU)
        for key, default in port_metric._defaults.items():
            want = jax_metric._state[key]
            if isinstance(want, list):
                assert default == [] and port_metric._state[key] == [], (case, key)
            else:
                assert str(default.dtype).replace("torch.", "") == str(np.asarray(want).dtype), (case, key)


def test_psnrb_sums_bef_over_updates_as_jax_does():
    """JAX-side quirk kept: ``bef`` is a sum state and the compute adds the sum, not a
    mean, to the mean squared error; two updates of one batch differ from one."""
    jax_metric = jtm.image.PeakSignalNoiseRatioWithBlockedEffect(data_range=1.0)
    port_metric = ttm.image.PeakSignalNoiseRatioWithBlockedEffect(data_range=1.0, **CPU)
    batch = (GRAY[0][0], GRAY[1][0])
    once = float(port_fn.peak_signal_noise_ratio_with_blocked_effect(*_t(*batch), data_range=1.0))
    for _ in range(2):
        jax_metric.update(*_j(*batch))
        port_metric.update(*_t(*batch))
    _close(port_metric.compute(), jax_metric.compute())
    _close(port_metric.bef, jax_metric._state["bef"])
    assert float(port_metric.bef) > 0 and float(port_metric.compute()) < once


def test_top_level_psnr_is_the_compat_class():
    assert ttm.PeakSignalNoiseRatio is importlib.import_module("torchmetrics_tpu_torch.image.psnr")._CompatPeakSignalNoiseRatio
    assert ttm.image.PeakSignalNoiseRatio is not ttm.PeakSignalNoiseRatio
    metric, jax_metric = ttm.PeakSignalNoiseRatio(**CPU), jtm.PeakSignalNoiseRatio()
    metric.update(*_t(PREDS[0], TARGET[0]))
    jax_metric.update(*_j(PREDS[0], TARGET[0]))
    _close(metric.compute(), jax_metric.compute())
    assert metric.data_range_val == jax_metric.data_range_val == 3.0
    with pytest.raises(TypeError):
        ttm.image.PeakSignalNoiseRatio(**CPU)


def test_tv_class_on_uint8_images():
    jax_metric, port_metric = jtm.image.TotalVariation(), ttm.image.TotalVariation(**CPU)
    jax_metric.update(*_j(UINT8))
    port_metric.update(*_t(UINT8))
    _bitwise(port_metric.compute(), jax_metric.compute())
    _bitwise(port_metric.num_elements, jax_metric._state["num_elements"])


@pytest.mark.parametrize("build", [
    lambda m, **d: m.image.StructuralSimilarityIndexMeasure(reduction="max", **d),
    lambda m, **d: m.image.MultiScaleStructuralSimilarityIndexMeasure(betas=(1, 2), **d),
    lambda m, **d: m.image.MultiScaleStructuralSimilarityIndexMeasure(normalize="max", **d),
    lambda m, **d: m.image.UniversalImageQualityIndex(reduction="max", **d),
    lambda m, **d: m.image.VisualInformationFidelity(sigma_n_sq=-1.0, **d),
    lambda m, **d: m.image.TotalVariation(reduction="max", **d),
    lambda m, **d: m.image.SpatialCorrelationCoefficient(window_size=0, **d),
    lambda m, **d: m.image.RelativeAverageSpectralError(window_size=0, **d),
    lambda m, **d: m.image.RootMeanSquaredErrorUsingSlidingWindow(window_size=1.5, **d),
    lambda m, **d: m.image.PeakSignalNoiseRatioWithBlockedEffect(1.0, block_size=0, **d),
], ids=["ssim_reduction", "ms_ssim_betas", "ms_ssim_normalize", "uqi_reduction", "vif_sigma", "tv_reduction",
        "scc_window", "rase_window", "rmse_sw_window", "psnrb_block"])
def test_constructor_errors_like_the_jax_package(build):
    with pytest.raises(ValueError) as jax_err:
        build(jtm)
    with pytest.raises(ValueError) as port_err:
        build(ttm, **CPU)
    assert str(port_err.value) == str(jax_err.value)


def test_truncated_checkpoint_raises():
    jax_metric = jtm.image.StructuralSimilarityIndexMeasure(data_range=1.0)
    jax_metric.persistent(True)
    jax_metric.update(*_j(PREDS[0], TARGET[0]))
    state = dict(jax_metric.state_dict())
    state.pop(next(iter(state)))
    with pytest.raises(StateCorruptionError):
        ttm.image.StructuralSimilarityIndexMeasure(data_range=1.0, **CPU).load_state_dict(state)


# ---------------------------------------------------------------------------- exports

def test_exports_are_the_jax_packages_less_the_model_backed_names():
    """Since the model-backed metrics (ARNIQA, DISTS, LPIPS, perceptual path length) are
    ported, none is left out: every image name of the JAX package, in its order, with
    its signature."""
    import inspect

    assert ttm.image.__all__ == jtm.image.__all__
    assert port_fn.image.__all__ == jax_fn.image.__all__
    image_names = set(jtm.image.__all__) | set(jax_fn.image.__all__)
    for port_module, jax_module in ((ttm, jtm), (port_fn, jax_fn), (ttm.image, jtm.image), (port_fn.image, jax_fn.image)):
        jax_image = [n for n in jax_module.__all__ if n in image_names]
        assert [n for n in port_module.__all__ if n in image_names] == jax_image
        for name in jax_image:
            port_sig, jax_sig = inspect.signature(getattr(port_module, name)), inspect.signature(getattr(jax_module, name))
            assert list(port_sig.parameters) == list(jax_sig.parameters), name
            assert [p.default for p in port_sig.parameters.values()] == [p.default for p in jax_sig.parameters.values()], name
    assert port_fn.peak_signal_noise_ratio.__name__ == "_compat_peak_signal_noise_ratio"
    assert inspect.signature(port_fn.peak_signal_noise_ratio).parameters["data_range"].default == 3.0


# ------------------------------------------------------- float64 and mixed inputs

# float64 images with bits below float32's: rounding them is the first step in JAX
WIDE = PREDS[0].astype(np.float64) + 1e-9 * _RNG.standard_normal(SHAPE)
WIDE_TARGET = TARGET[0].astype(np.float64) - 1e-9 * _RNG.standard_normal(SHAPE)
FLOAT64_FUNCTIONS = {
    "peak_signal_noise_ratio": ({"data_range": 1.0}, 2),
    "peak_signal_noise_ratio_with_blocked_effect": ({"data_range": 1.0}, 2),
    "structural_similarity_index_measure": ({"data_range": 1.0}, 2),
    "multiscale_structural_similarity_index_measure": ({"data_range": 1.0, "betas": (0.4, 0.6)}, 2),
    "universal_image_quality_index": ({}, 2),
    "visual_information_fidelity": ({}, 2),
    "spatial_correlation_coefficient": ({}, 2),
    "spectral_angle_mapper": ({}, 2),
    "error_relative_global_dimensionless_synthesis": ({}, 2),
    "root_mean_squared_error_using_sliding_window": ({}, 2),
    "relative_average_spectral_error": ({}, 2),
    "total_variation": ({}, 1),
    "image_gradients": ({}, 1),
}


def _image_pair(name: str, preds: np.ndarray, target: np.ndarray, arity: int) -> tuple:
    if name == "peak_signal_noise_ratio_with_blocked_effect":
        preds, target = preds[:, :1], target[:, :1]
    return (preds, target)[:arity]


@pytest.mark.parametrize("name, pair", [
    (name, pair) for name, (_, arity) in sorted(FLOAT64_FUNCTIONS.items())
    for pair in (("float64", "float64_float32", "float32_float64") if arity == 2 else ("float64",))])
def test_float64_and_mixed_inputs_round_to_float32_as_in_the_jax_package(name, pair):
    """``jnp.asarray`` rounds float64 to float32 with 64-bit types off: every JAX image
    function returns float32 and takes a float64 image beside a float32 one. The port
    rounds at the entry: its value is the float32 inputs' value, bit for bit."""
    kw, arity = FLOAT64_FUNCTIONS[name]
    preds = WIDE if pair.startswith("float64") else WIDE.astype(np.float32)
    target = WIDE_TARGET if pair.endswith("float64") else WIDE_TARGET.astype(np.float32)
    args = _image_pair(name, preds, target, arity)
    rounded = _image_pair(name, WIDE.astype(np.float32), WIDE_TARGET.astype(np.float32), arity)
    want = getattr(jax_fn, name)(*args, **kw)
    got = getattr(port_fn, name)(*_t(*args), **kw)
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert _np(g).dtype == np.asarray(w).dtype == np.float32, name
    _bitwise(got if not isinstance(got, tuple) else torch.stack(got),
             (lambda r: r if not isinstance(r, tuple) else torch.stack(r))(getattr(port_fn, name)(*_t(*rounded), **kw)),
             name)


FLOAT64_CLASSES = {
    "psnr_none": ("PeakSignalNoiseRatio", {"data_range": 1.0, "reduction": "none", "dim": (1, 2, 3)}),
    "psnrb": ("PeakSignalNoiseRatioWithBlockedEffect", {"data_range": 1.0}),
    "ssim_none": ("StructuralSimilarityIndexMeasure", {"data_range": 1.0, "reduction": "none"}),
    "ms_ssim": ("MultiScaleStructuralSimilarityIndexMeasure", {"data_range": 1.0, "betas": (0.4, 0.6)}),
    "uqi": ("UniversalImageQualityIndex", {}),
    "uqi_none": ("UniversalImageQualityIndex", {"reduction": "none"}),
    "vif": ("VisualInformationFidelity", {}),
    "scc": ("SpatialCorrelationCoefficient", {}),
    "sam": ("SpectralAngleMapper", {}),
    "ergas": ("ErrorRelativeGlobalDimensionlessSynthesis", {}),
    "rase": ("RelativeAverageSpectralError", {}),
    "rmse_sw": ("RootMeanSquaredErrorUsingSlidingWindow", {}),
    "tv": ("TotalVariation", {}),
}


@pytest.mark.parametrize("case", sorted(FLOAT64_CLASSES))
@pytest.mark.parametrize("pair", ["float64", "float64_float32"])
def test_float64_and_mixed_class_updates_give_float32_as_in_the_jax_package(case, pair):
    name, kw = FLOAT64_CLASSES[case]
    arity = 1 if name == "TotalVariation" else 2
    preds = WIDE
    target = WIDE_TARGET if pair == "float64" else WIDE_TARGET.astype(np.float32)
    args = _image_pair("peak_signal_noise_ratio_with_blocked_effect" if case == "psnrb" else name, preds, target, arity)
    rounded = tuple(a.astype(np.float32) for a in args)
    jax_metric = getattr(jtm.image, name)(**kw)
    jax_metric.update(*args)
    port_metric = getattr(ttm.image, name)(**kw, **CPU)
    port_metric.update(*_t(*args))
    twin = getattr(ttm.image, name)(**kw, **CPU)
    twin.update(*_t(*rounded))
    got = port_metric.compute()
    assert _np(got).dtype == np.asarray(jax_metric.compute()).dtype == np.float32, case
    _bitwise(got, twin.compute(), case)


def test_vif_class_update_under_41_by_41_raises_the_functions_value_error():
    """The function's check runs in the class's update, before any convolution (the JAX
    class skips it and scores empty convolutions)."""
    small = _RNG.random((1, 1, 32, 32), dtype=np.float32)
    with pytest.raises(ValueError) as fn_err:
        port_fn.visual_information_fidelity(*_t(small, small))
    metric = ttm.image.VisualInformationFidelity(**CPU)
    with pytest.raises(ValueError) as cls_err:
        metric.update(*_t(small, small))
    assert str(cls_err.value) == str(fn_err.value) == "Invalid size of preds. Expected at least 41x41, but got 32x32!"
    with pytest.raises(ValueError, match="Invalid size of target"):
        metric.update(*_t(np.zeros((1, 1, 48, 48), np.float32), np.zeros((1, 1, 48, 40), np.float32)))
    assert metric.update_count == 0 and metric.vif_score == []
