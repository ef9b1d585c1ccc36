"""The port's KID, InceptionScore, MiFID and InceptionV3 weight converter, held to the
JAX package's on the CPU.

The metrics see the 16-feature linear extractor of ``tests/test_generative_and_pure.py``
(the same seed, 48 real and 48 fake 3x8x8 images). Each package's extractor computes its
features in numpy float64 and rounds them to float32 once, so both metrics receive the
same float32 features bit for bit and what is compared is the metrics' own algebra:
float64 in both packages (numpy on the host in the JAX package, torch on the metric's
device in the port), so the float32 values agree within 1e-6 relative.
"""

from __future__ import annotations

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.image as jimage
from torchmetrics_tpu.image import generative as jgen
from torchmetrics_tpu.image._extractors import convert_torchvision_inception_weights as jax_convert
from torchmetrics_tpu_torch.image import (
    InceptionScore,
    InceptionV3Features,
    KernelInceptionDistance,
    MemorizationInformedFrechetInceptionDistance,
    convert_torchvision_inception_weights,
)
from torchmetrics_tpu_torch.image import generative as tgen
from tests.test_weight_parity import TorchInceptionV3, _randomize_bn

RTOL = 1e-6

_RNG = np.random.default_rng(7)
_W = _RNG.normal(size=(3 * 8 * 8, 16)).astype(np.float32)
REAL = _RNG.random((48, 3, 8, 8)).astype(np.float32)
FAKE = (0.6 * REAL + 0.4 * _RNG.random((48, 3, 8, 8))).astype(np.float32)


def _features(imgs: np.ndarray) -> np.ndarray:
    return (imgs.reshape(imgs.shape[0], -1).astype(np.float64) @ _W.astype(np.float64)).astype(np.float32)


class JaxExtractor:
    num_features = 16

    def __call__(self, imgs):
        return jnp.asarray(_features(np.asarray(imgs, np.float32)))


class TorchExtractor:
    num_features = 16

    def __call__(self, imgs):
        return torch.from_numpy(_features(imgs.float().numpy()))


def _pair(name, **kw):
    jax_cls = getattr(jimage, name)
    torch_cls = {"KernelInceptionDistance": KernelInceptionDistance, "InceptionScore": InceptionScore,
                 "MemorizationInformedFrechetInceptionDistance": MemorizationInformedFrechetInceptionDistance}[name]
    return jax_cls(feature=JaxExtractor(), **kw), torch_cls(feature=TorchExtractor(), device="cpu", **kw)


def _feed_two_sided(pair, batches):
    for arr, real in batches:
        pair[0].update(jnp.asarray(arr), real=real)
        pair[1].update(torch.from_numpy(arr), real=real)


def _close(jax_value, torch_value, atol=0.0):
    want, got = np.asarray(jax_value), torch_value.numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


SPLIT = [(REAL[:20], True), (FAKE[:30], False), (REAL[20:], True), (FAKE[30:], False)]


@pytest.mark.parametrize("subsets, subset_size, kw", [
    (3, 48, {}), (5, 20, {}), (4, 32, {"degree": 2, "gamma": 0.5, "coef": 2.0}),
], ids=["full", "subsets", "kernel_args"])
def test_kid_matches_jax(subsets, subset_size, kw):
    pair = _pair("KernelInceptionDistance", normalize=True, subsets=subsets, subset_size=subset_size, seed=11, **kw)
    _feed_two_sided(pair, SPLIT)
    (jax_mean, jax_std), (mean, std) = pair[0].compute(), pair[1].compute()
    _close(jax_mean, mean)
    # where every subset holds all rows, the subsets' scores differ only by the float64
    # rounding of their permuted sums, and so does the std: hold it to 1e-6 of the mean
    _close(jax_std, std, atol=RTOL * abs(float(jax_mean)))


def test_kid_subsets_follow_the_jax_draw_order():
    metric = KernelInceptionDistance(feature=TorchExtractor(), subsets=4, subset_size=10, seed=5, device="cpu")
    real_idx, fake_idx = metric.subset_indices(48, 40)
    rng = np.random.default_rng(5)
    for s in range(4):
        np.testing.assert_array_equal(real_idx[s].numpy(), rng.permutation(48)[:10])
        np.testing.assert_array_equal(fake_idx[s].numpy(), rng.permutation(40)[:10])


@pytest.mark.parametrize("shape", [(6, 4), (9, 16)])
def test_mmd_helpers_match_jax(shape):
    rng = np.random.default_rng(shape[0])
    x, y = rng.normal(size=shape), rng.normal(size=shape)
    want = jgen.poly_mmd(x, y, degree=3, gamma=None, coef=1.0)
    got = tgen.poly_mmd(torch.from_numpy(x), torch.from_numpy(y))
    assert float(got) == pytest.approx(float(want), rel=1e-12)
    batched = tgen.poly_mmd(torch.from_numpy(np.stack([x, y])), torch.from_numpy(np.stack([y, x])))
    assert float(batched[0]) == pytest.approx(float(want), rel=1e-12)
    assert float(batched[1]) == pytest.approx(float(jgen.poly_mmd(y, x)), rel=1e-12)


def test_kid_too_large_subset_raises_as_jax():
    pair = _pair("KernelInceptionDistance", subsets=2, subset_size=49)
    _feed_two_sided(pair, SPLIT)
    for metric in pair:
        with pytest.raises(ValueError, match="should be smaller than the number of samples"):
            metric.compute()


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("normalize", [False, True])
def test_inception_score_matches_jax(splits, normalize):
    pair = _pair("InceptionScore", normalize=normalize, splits=splits, seed=3)
    for chunk in (REAL[:17] * 0.05, REAL[17:] * 0.05):
        pair[0].update(jnp.asarray(chunk))
        pair[1].update(torch.from_numpy(np.ascontiguousarray(chunk)))
    for want, got in zip(pair[0].compute(), pair[1].compute()):
        _close(want, got)


def test_inception_score_forward_and_default_head():
    metric = InceptionScore(feature=TorchExtractor(), splits=2, seed=0, device="cpu")
    batch_mean, _ = metric(torch.from_numpy(REAL * 0.05))
    alone = InceptionScore(feature=TorchExtractor(), splits=2, seed=0, device="cpu")
    alone.update(torch.from_numpy(REAL * 0.05))
    assert torch.equal(batch_mean, alone.compute()[0])
    for cls in (jimage.InceptionScore, InceptionScore):
        with pytest.raises(ModuleNotFoundError, match="logits_unbiased"):
            cls(**({} if cls is jimage.InceptionScore else {"device": "cpu"}))


@pytest.mark.parametrize("batches", [SPLIT, [(REAL, True), (FAKE, False), (REAL[:16] * 0.9, False)]],
                         ids=["split", "extra_fake"])
def test_mifid_matches_jax(batches):
    pair = _pair("MemorizationInformedFrechetInceptionDistance", normalize=True)
    _feed_two_sided(pair, batches)
    _close(pair[0].compute(), pair[1].compute())


def test_mifid_memorized_fakes_and_zero_rows_match_jax():
    """Fakes close to the reals take the memorization branch; an all-zero image is left out
    of the cosine distances."""
    pair = _pair("MemorizationInformedFrechetInceptionDistance", cosine_distance_eps=0.5)
    zero = np.zeros((1, 3, 8, 8), np.float32)
    _feed_two_sided(pair, [(np.concatenate([REAL, zero]), True), (REAL * 1.001 + 1e-3, False)])
    _close(pair[0].compute(), pair[1].compute())


@pytest.mark.parametrize("name", ["KernelInceptionDistance", "MemorizationInformedFrechetInceptionDistance"])
def test_reset_real_features(name):
    kw = {"subsets": 2, "subset_size": 10} if name == "KernelInceptionDistance" else {}
    for reset_real in (True, False):
        _, metric = _pair(name, reset_real_features=reset_real, **kw)
        metric.update(torch.from_numpy(REAL), real=True)
        metric.update(torch.from_numpy(FAKE), real=False)
        metric.reset()
        kept = sum(t.shape[0] for t in metric._state["real_features"])
        assert kept == (0 if reset_real else 48) and metric._state["fake_features"] == []


def test_feature_network_and_argument_checks():
    for cls in (KernelInceptionDistance, InceptionScore, MemorizationInformedFrechetInceptionDistance):
        assert cls.feature_network == "inception"
    with pytest.raises(ValueError, match="subsets"):
        KernelInceptionDistance(feature=TorchExtractor(), subsets=0, device="cpu")
    with pytest.raises(ValueError, match="cosine_distance_eps"):
        MemorizationInformedFrechetInceptionDistance(feature=TorchExtractor(), cosine_distance_eps=1.5, device="cpu")
    with pytest.raises(ModuleNotFoundError, match="convert_torchvision_inception_weights"):
        KernelInceptionDistance(device="cpu")


def test_converter_writes_the_jax_pickle_and_the_trunk_matches_the_twin(tmp_path):
    """Both converters write leaf-identical pickles from a torchvision twin's state dict,
    and the port's trunk on them matches the twin within the JAX test's bounds."""
    torch.manual_seed(14)
    twin = TorchInceptionV3().eval()
    _randomize_bn(twin, seed=15)
    imgs = np.random.default_rng(16).random((2, 3, 299, 299)).astype(np.float32)
    with torch.no_grad():
        want = twin(torch.as_tensor((imgs * 255.0 - 128.0) / 128.0)).numpy()
    ours, theirs = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    convert_torchvision_inception_weights(twin.state_dict(), str(ours))
    jax_convert(twin.state_dict(), str(theirs))
    with open(ours, "rb") as f_ours, open(theirs, "rb") as f_theirs:
        a, b = pickle.load(f_ours), pickle.load(f_theirs)

    def leaves(tree, prefix=""):
        for key in sorted(tree):
            value = tree[key]
            yield from leaves(value, f"{prefix}{key}.") if isinstance(value, dict) else [(prefix + key, value)]

    pairs = list(zip(leaves(a), leaves(b)))
    assert len(pairs) == len(list(leaves(b))) and all(ka == kb for (ka, _), (kb, _) in pairs)
    for (key, va), (_, vb) in pairs:
        assert va.dtype == vb.dtype and va.shape == vb.shape and np.array_equal(va, vb), key
    got = InceptionV3Features(weights_path=str(ours), device="cpu")(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
