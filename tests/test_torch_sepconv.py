"""The port's ``sepconv7`` on the CPU: its plain version against the JAX package's
``lax.conv`` baseline and against the Pallas kernel it replaces (run in interpret mode),
plus the wrapper's CPU path and argument checks. The CUDA kernel itself is checked
against the plain version on the card by ``chip_smoke.py``.

Inputs come from a numpy seed and go to both frameworks as the same float32 values.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from torchmetrics_tpu_torch.kernels.sepconv import packed_weight_numel, sepconv7, sepconv7_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The plain version and lax.conv sum the same float32 products in different orders:
# 1e-5 absolute is ~100 f32 ulps at the outputs' O(1) scale.
F32_ATOL = 1e-5


@pytest.fixture(scope="module")
def exp_sepconv():
    """``tools/exp_sepconv.py``, loaded by path (``tools`` is not a package)."""
    spec = importlib.util.spec_from_file_location("exp_sepconv", ROOT / "tools" / "exp_sepconv.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(seed, b, c, o, h, w):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, h, w)).astype(np.float32)
    wt = (rng.normal(size=(o, c, 7)) / np.sqrt(7 * c)).astype(np.float32)
    return x, wt


def _oihw(wt, axis):
    return wt[:, :, None, :] if axis == "W" else wt[:, :, :, None]


@pytest.mark.parametrize("axis", ["W", "H"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 17, 17), (1, 5, 12, 9, 13), (3, 16, 4, 4, 30)])
def test_reference_matches_lax_conv(exp_sepconv, axis, shape):
    b, c, o, h, w = shape
    x, wt = _inputs(0, b, c, o, h, w)
    want = np.asarray(exp_sepconv.conv_baseline(jnp.asarray(x), jnp.asarray(_oihw(wt, axis)), kind=None))
    got = sepconv7_reference(torch.from_numpy(x), torch.from_numpy(wt), axis).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_reference_matches_pallas_kernel_interpret(exp_sepconv, monkeypatch):
    """The TPU kernel itself, run by Pallas's interpreter at B=4, C=O=8 (17 rows per
    grid step); no file of the JAX side changes."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(exp_sepconv, "B", 4)
    run = exp_sepconv.make_pallas_sepconv(8, 8, r_blk=17)
    x, wt = _inputs(1, 4, 8, 8, 17, 17)
    want = np.asarray(run(jnp.asarray(x), jnp.asarray(_oihw(wt, "W"))))
    got = sepconv7_reference(torch.from_numpy(x), torch.from_numpy(wt), "W").numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_h_axis_is_the_transposed_w_axis():
    x, wt = _inputs(2, 2, 6, 5, 11, 17)
    xt = torch.from_numpy(x)
    via_h = sepconv7_reference(xt, torch.from_numpy(wt), "H")
    via_w = sepconv7_reference(xt.transpose(2, 3), torch.from_numpy(wt), "W").transpose(2, 3)
    torch.testing.assert_close(via_h, via_w, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_takes_the_plain_version_without_counting(dtype):
    x, wt = _inputs(3, 2, 8, 8, 17, 17)
    xt, wtt = torch.from_numpy(x).to(dtype), torch.from_numpy(wt).to(dtype)
    before = sepconv7.launches
    out = sepconv7(xt, wtt, "W")
    assert sepconv7.launches == before  # the count moves only where the kernel launches
    assert out.dtype == dtype and out.shape == (2, 8, 17, 17)
    torch.testing.assert_close(out, sepconv7_reference(xt, wtt, "W"), atol=0, rtol=0)
    if dtype == torch.bfloat16:
        # summed in f32, rounded once to bf16: within half a bf16 ulp (2^-9 relative)
        ref = sepconv7_reference(xt.float(), wtt.float(), "W")
        assert float(((out.float() - ref).abs() / ref.abs().clamp_min(1e-3)).max()) <= 2.0**-8


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(1, 4, 5, 5)
    with pytest.raises(ValueError, match="axis"):
        sepconv7(x, torch.zeros(3, 4, 7), "X")
    with pytest.raises(ValueError, match="expected x"):
        sepconv7(x, torch.zeros(3, 5, 7), "W")
    with pytest.raises(ValueError, match="expected x"):
        sepconv7(x, torch.zeros(3, 4, 3), "W")


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises: here (meta
    tensors) it raises before any build."""
    x, w = torch.zeros(1, 4, 5, 5, device="meta"), torch.zeros(3, 4, 7, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sepconv7(x, w, "W")
    with pytest.raises(ValueError, match="CUDA"):
        sepconv7(torch.zeros(1, 4, 5, 5), w, "W")


_PACK_CASES = [(128, 128, 2 * 4), (160, 160, 3 * 5), (160, 192, 3 * 5), (192, 192, 3 * 6), (12, 24, 1), (33, 65, 2 * 2)]
# float32 chunks are 16 channels: twice the bf16 slices along C
_PACK_CASES_F32 = [(128, 128, 2 * 8), (160, 160, 3 * 10), (160, 192, 3 * 10), (192, 192, 3 * 12), (12, 24, 1),
                   (33, 65, 2 * 3)]


@pytest.mark.parametrize("channels, out_channels, slices, dtype", [
    *(pytest.param(c, o, n, torch.bfloat16, id=f"{c}-{o}-{n}") for c, o, n in _PACK_CASES),
    *(pytest.param(c, o, n, torch.float32, id=f"f32-{c}-{o}-{n}") for c, o, n in _PACK_CASES_F32),
])
def test_packed_weights_are_whole_zero_padded_slices(channels, out_channels, slices, dtype):
    """The kernel's weight scratch: one slice per (O-tile, channel chunk), C and O rounded
    up. bf16: 64 outputs x 32 channels x 7 taps. f32: 64 outputs x 16 channels x 7 taps,
    twice, the TF32 hi and lo parts."""
    per_slice = 64 * 32 * 7 if dtype == torch.bfloat16 else 2 * 64 * 16 * 7
    assert packed_weight_numel(channels, out_channels, dtype) == slices * per_slice


# The trunk's distinct (C, O, axis): Mixed_6b-6e (c7 = 128, 160, 192) and Mixed_7a.
TRUNK_CASES = [(c, o, axis) for c, o in ((128, 128), (128, 192), (160, 160), (160, 192), (192, 192))
               for axis in ("W", "H")]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` does: add half of the dropped 13 bits, then clear them."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("channels, out_channels, axis", TRUNK_CASES)
def test_three_tf32_products_keep_f32_accuracy_where_one_does_not(channels, out_channels, axis):
    """Why the f32 kernel splits: at the trunk's shapes (B=2, inputs scaled as
    ``chip_smoke.py`` scales them) one TF32 product per product misses the f32 limit of
    1e-4, while x_lo*w_hi + x_hi*w_lo + x_hi*w_hi, each operand rounded to TF32 and every
    sum in f32, stays within 1e-5 of the exact f32 plain version."""
    rng = np.random.default_rng(channels + out_channels + (axis == "H"))
    x = torch.from_numpy(rng.normal(size=(2, channels, 17, 17)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(out_channels, channels, 7)) / np.sqrt(7 * channels)).astype(np.float32))
    x_hi, w_hi = _tf32(x), _tf32(w)
    x_lo, w_lo = _tf32(x - x_hi), _tf32(w - w_hi)
    assert torch.equal(_tf32(x_hi), x_hi) and torch.equal(_tf32(x_lo), x_lo)
    want = sepconv7_reference(x, w, axis)
    one = sepconv7_reference(x_hi, w_hi, axis)
    three = sepconv7_reference(x_lo, w_hi, axis) + sepconv7_reference(x_hi, w_lo, axis) + one
    assert float((one - want).abs().max()) > 1e-4
    assert float((three - want).abs().max()) <= 1e-5
