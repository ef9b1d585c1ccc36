"""The port's ``FrechetInceptionDistance`` against the JAX package's, on the CPU.

Both packages load one params pickle into their InceptionV3 trunks; the same seeded
images go through ``update`` (quantized to uint8 levels, resized to 299x299, trunk,
feature statistics inside the update) and ``compute`` in each. The state leaves and the
final value are compared. A second test holds the FID algebra alone to the JAX package
with a toy feature extractor.
"""

from __future__ import annotations

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.image import FrechetInceptionDistance as JaxFID
from torchmetrics_tpu.image._extractors import InceptionV3Features as JaxInception
from torchmetrics_tpu_torch.image import FrechetInceptionDistance, InceptionV3Features

SIDES = ("real", "fake")
# Feature sums and cross-product sums: f32 trunks that agree to ~1e-7 relative (see
# test_torch_inception.py), summed over a few images -> 1e-4 of each leaf's scale.
STATE_REL = 1e-4
# The final value: the eigenvalue form in f64 on both sides, from states that agree to
# STATE_REL; with few samples the covariances are near-singular, so allow 1e-3 relative.
FID_RTOL = 1e-3


def _trunk_pickle(tmp_path):
    path = tmp_path / "inception.pkl"
    with open(path, "wb") as f:
        pickle.dump(InceptionV3Features._random_params(7), f)
    return str(path)


def _images(seed, n):
    return np.random.default_rng(seed).random((n, 3, 64, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def both_fids(tmp_path_factory):
    path = _trunk_pickle(tmp_path_factory.mktemp("fid"))
    jax_fid = JaxFID(feature=JaxInception(weights_path=path), normalize=True)
    torch_fid = FrechetInceptionDistance(
        feature=InceptionV3Features(weights_path=path, device="cpu"), normalize=True, device="cpu"
    )
    batches = [(_images(1, 3), True), (_images(2, 3), False), (_images(3, 2), True), (_images(4, 2), False)]
    for imgs, real in batches:
        jax_fid.update(jnp.asarray(imgs), real=real)
        torch_fid.update(torch.from_numpy(imgs), real=real)
    return jax_fid, torch_fid


@pytest.mark.parametrize("leaf", ["features_sum", "features_cov_sum", "features_num_samples"])
@pytest.mark.parametrize("side", SIDES)
def test_fid_state_matches_jax(both_fids, side, leaf):
    jax_fid, torch_fid = both_fids
    name = f"{side}_{leaf}"
    want = np.asarray(jax_fid._state[name])
    got = torch_fid._state[name].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if leaf == "features_num_samples":
        assert int(got) == int(want) == 5
    else:
        assert np.abs(got - want).max() <= STATE_REL * np.abs(want).max()


def test_fid_value_matches_jax(both_fids):
    jax_fid, torch_fid = both_fids
    want = float(jax_fid.compute())
    got = torch_fid.compute()
    assert got.dtype == torch.float32 and got.shape == ()
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), want, rtol=FID_RTOL)


def _toy_extractor_jax(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :8].astype(jnp.float32)


def _toy_extractor_torch(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :8].float()


@pytest.mark.parametrize("normalize", [True, False])
def test_fid_algebra_matches_jax_with_toy_extractor(normalize):
    """The documented toy-extractor example, plus more batches: same states (exact:
    the same f32 sums of the same few products) and the same value in f64."""
    jax_fid = JaxFID(feature=_toy_extractor_jax, normalize=normalize)
    torch_fid = FrechetInceptionDistance(feature=_toy_extractor_torch, normalize=normalize, device="cpu")
    rng = np.random.default_rng(9)
    for i in range(4):
        imgs = rng.random((6, 3, 16, 16)).astype(np.float32)
        jax_fid.update(jnp.asarray(imgs), real=i % 2 == 0)
        torch_fid.update(torch.from_numpy(imgs), real=i % 2 == 0)
    for name in torch_fid._state:
        np.testing.assert_allclose(torch_fid._state[name].numpy(), np.asarray(jax_fid._state[name]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(torch_fid.compute()), float(jax_fid.compute()), rtol=1e-5)


def test_fid_reset_keeps_real_features_when_asked():
    fid = FrechetInceptionDistance(feature=_toy_extractor_torch, reset_real_features=False, device="cpu")
    imgs = torch.from_numpy(_images(5, 4))
    fid.update(imgs, real=True)
    fid.update(imgs, real=False)
    real_sum = fid.real_features_sum.clone()
    fid.reset()
    torch.testing.assert_close(fid.real_features_sum, real_sum)
    assert int(fid.fake_features_num_samples) == 0 and int(fid.real_features_num_samples) == 4


def test_fid_integer_feature_needs_weights():
    with pytest.raises(ModuleNotFoundError, match="weights"):
        FrechetInceptionDistance(feature=2048, device="cpu")
    with pytest.raises(ValueError, match="2048"):
        FrechetInceptionDistance(feature=64, device="cpu")
