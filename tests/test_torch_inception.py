"""The port's InceptionV3 trunk against the JAX package's, on the CPU.

- Each block A-E at narrow widths with randomized BatchNorm, params carried as numpy
  (the port folds BN itself; the JAX side runs its own folded production path).
- The whole trunk at 2x3x299x299 against the JAX package's ``InceptionV3Features(seed=0)``,
  in float32 and in bfloat16, with the JAX params carried through ``from_numpy_params``
  and through a ``weights_path`` pickle.

Every 1x7 and 7x1 conv in the port goes through ``sepconv7``, which takes its plain
version for CPU tensors.
"""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.image import _extractors as jax_ext
from torchmetrics_tpu_torch.image import InceptionV3Features
from torchmetrics_tpu_torch.image._extractors import (
    InceptionA,
    InceptionB,
    InceptionC,
    InceptionD,
    InceptionE,
    _fold_bn,
)

# f32 blocks: the same folded f32 weights on both sides, f32 conv sums in different
# orders; outputs are O(1), so 1e-5 absolute is ~100 ulps.
BLOCK_ATOL, BLOCK_RTOL = 1e-5, 1e-4
# The whole f32 trunk: the precedent of tests/test_weight_parity.py (atol 2e-3, rtol 1e-3)
# plus a scale-aware bound, because random weights shrink the pooled features to ~1e-3.
TRUNK_ATOL, TRUNK_RTOL, TRUNK_REL_MAX = 2e-3, 1e-3, 1e-4
# bfloat16 trunks (8-bit mantissa, rounding at every layer of ~95 convs) compared in
# float32: relative L2 error <= 2% and max error <= 3% of the largest feature.
BF16_REL_L2, BF16_REL_MAX = 2e-2, 3e-2


def _raw_conv(rng, c_in, c_out, kh, kw):
    """A raw conv leaf with randomized inference BN, so folding is exercised."""
    return {
        "w": (rng.normal(size=(c_out, c_in, kh, kw)) / np.sqrt(c_in * kh * kw)).astype(np.float32),
        "scale": rng.uniform(0.5, 1.5, c_out).astype(np.float32),
        "bias": rng.normal(0.0, 0.1, c_out).astype(np.float32),
        "mean": rng.normal(0.0, 0.1, c_out).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, c_out).astype(np.float32),
    }


def _block_params(kind, rng, c_in):
    cp = lambda *a: _raw_conv(rng, *a)  # noqa: E731
    c7 = 8
    if kind == "a":
        return {"b1": cp(c_in, 8, 1, 1), "b5_1": cp(c_in, 6, 1, 1), "b5_2": cp(6, 8, 5, 5),
                "b3_1": cp(c_in, 8, 1, 1), "b3_2": cp(8, 12, 3, 3), "b3_3": cp(12, 12, 3, 3),
                "pool": cp(c_in, 4, 1, 1)}
    if kind == "b":
        return {"b3": cp(c_in, 12, 3, 3), "b3d_1": cp(c_in, 8, 1, 1), "b3d_2": cp(8, 12, 3, 3),
                "b3d_3": cp(12, 12, 3, 3)}
    if kind == "c":
        return {"b1": cp(c_in, 12, 1, 1),
                "b7_1": cp(c_in, c7, 1, 1), "b7_2": cp(c7, c7, 1, 7), "b7_3": cp(c7, 12, 7, 1),
                "b7d_1": cp(c_in, c7, 1, 1), "b7d_2": cp(c7, c7, 7, 1), "b7d_3": cp(c7, c7, 1, 7),
                "b7d_4": cp(c7, c7, 7, 1), "b7d_5": cp(c7, 12, 1, 7), "pool": cp(c_in, 12, 1, 1)}
    if kind == "d":
        return {"b3_1": cp(c_in, 8, 1, 1), "b3_2": cp(8, 12, 3, 3),
                "b7_1": cp(c_in, c7, 1, 1), "b7_2": cp(c7, c7, 1, 7), "b7_3": cp(c7, c7, 7, 1),
                "b7_4": cp(c7, c7, 3, 3)}
    return {"b1": cp(c_in, 12, 1, 1), "b3_1": cp(c_in, 10, 1, 1), "b3_2a": cp(10, 10, 1, 3),
            "b3_2b": cp(10, 10, 3, 1), "b3d_1": cp(c_in, 14, 1, 1), "b3d_2": cp(14, 10, 3, 3),
            "b3d_3a": cp(10, 10, 1, 3), "b3d_3b": cp(10, 10, 3, 1), "pool": cp(c_in, 6, 1, 1)}


BLOCKS = {
    "a": (jax_ext._inception_a, InceptionA, 9),
    "b": (jax_ext._inception_b, InceptionB, 9),
    "c": (jax_ext._inception_c, InceptionC, 17),
    "d": (jax_ext._inception_d, InceptionD, 17),
    "e": (jax_ext._inception_e, InceptionE, 8),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax(kind):
    jax_block, torch_block, size = BLOCKS[kind]
    rng = np.random.default_rng(ord(kind))
    c_in = 16
    raw = _block_params(kind, rng, c_in)
    x = rng.normal(size=(2, c_in, size, size)).astype(np.float32)
    jax_params = jax_ext._fold_bn(jax.tree.map(jnp.asarray, raw))
    want = np.asarray(jax_block(jnp.asarray(x), jax_params))
    block = torch_block(_fold_bn(raw), torch.from_numpy)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)


def test_fold_bn_matches_jax_bitwise():
    rng = np.random.default_rng(5)
    raw = {"conv": _raw_conv(rng, 4, 6, 1, 7)}
    want = jax.tree.map(np.asarray, jax_ext._fold_bn(jax.tree.map(jnp.asarray, raw)))
    got = _fold_bn(raw)
    np.testing.assert_array_equal(got["conv"]["w"], want["conv"]["w"])
    np.testing.assert_array_equal(got["conv"]["b"], want["conv"]["b"])


@pytest.fixture(scope="module")
def jax_trunk():
    """The JAX package's ``InceptionV3Features(seed=0)``, its folded params as numpy,
    a pickle of them, and the f32 features of a seeded 2x3x299x299 batch."""
    extractor = jax_ext.InceptionV3Features(seed=0)
    params = jax.tree.map(np.asarray, extractor.params)
    imgs = np.random.default_rng(16).random((2, 3, 299, 299)).astype(np.float32)
    return extractor, params, imgs, np.asarray(extractor(imgs))


def test_full_trunk_f32_matches_jax(jax_trunk):
    _, params, imgs, want = jax_trunk
    trunk = InceptionV3Features.from_numpy_params(params, device="cpu")
    got = trunk(torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TRUNK_ATOL, rtol=TRUNK_RTOL)
    assert np.abs(got - want).max() <= TRUNK_REL_MAX * np.abs(want).max()


def test_full_trunk_bf16_from_weights_path(jax_trunk, tmp_path):
    """The same pickle loads into both packages' bf16 trunks; each is held to the JAX
    f32 features, and the two bf16 trunks to each other."""
    _, params, imgs, want = jax_trunk
    path = tmp_path / "inception.pkl"
    with open(path, "wb") as f:
        pickle.dump(params, f)
    got = InceptionV3Features(weights_path=str(path), compute_dtype="bfloat16", device="cpu")(
        torch.from_numpy(imgs)
    ).numpy()
    jax_bf16 = np.asarray(jax_ext.InceptionV3Features(weights_path=str(path), compute_dtype="bfloat16")(imgs))
    scale = np.abs(want).max()
    for features in (got, jax_bf16):
        assert np.linalg.norm(features - want) <= BF16_REL_L2 * np.linalg.norm(want)
        assert np.abs(features - want).max() <= BF16_REL_MAX * scale
    assert np.abs(got - jax_bf16).max() <= BF16_REL_MAX * scale


def test_quantized_and_resized_input_matches_jax(jax_trunk):
    """``normalize=True`` quantization to uint8 and the resize of a 64x48 input to
    299x299 (both forks), through the f32 trunk."""
    extractor, params, _, _ = jax_trunk
    imgs = np.random.default_rng(17).random((1, 3, 64, 48)).astype(np.float32)
    trunk = InceptionV3Features.from_numpy_params(params, device="cpu")
    for antialias in (True, False):
        trunk.resize_antialias = antialias
        extractor.resize_antialias = antialias
        extractor._apply = jax.jit(extractor.in_graph_forward)
        want = np.asarray(extractor(imgs, normalize=True))
        got = trunk(torch.from_numpy(imgs), normalize=True).numpy()
        assert np.abs(got - want).max() <= TRUNK_REL_MAX * np.abs(want).max()
