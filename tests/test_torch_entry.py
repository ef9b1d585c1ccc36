"""The port's entry points (``torchmetrics_tpu_torch.entry``) against the JAX package's
``__graft_entry__``, on the CPU.

- ``entry(device="cpu")`` against ``__graft_entry__.entry()``: the same seed-0 inputs,
  integer states bit for bit, values within 1e-6.
- ``_flagship_step_fn(8, device="cpu")`` (a world of one takes the whole input) against
  ``_flagship_step_fn(mesh, 8)`` on the conftest CPU mesh: the same inputs, ``acc``,
  ``f1`` and ``map`` equal; ``fid`` within 1e-4 relative of the JAX package's FID on the
  same images behind the same numpy projection (``tests/test_torch_flagship.py``'s
  tolerance: the float32 products and covariance sums round differently in XLA and in
  torch).
- ``dryrun_multichip(2, device="cpu")``: two spawned gloo ranks, each rank's synced
  collection and flagship equal to one process's step over the whole batch (FID within
  1e-4 relative: the ranks' float32 sums are added by the group).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from torchmetrics_tpu_torch.entry import (
    FID_RTOL,
    _flagship_step_fn,
    dryrun_multichip,
    entry,
    flagship_sync_latency_ms,
    sharded_values,
    toy_projection,
)

from conftest import NUM_DEVICES

VALUE_ATOL = 1e-6


def _np(value) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.array(value)


def test_entry_matches_the_jax_entry():
    jax_fn, jax_args = graft.entry()
    fn, args = entry(device="cpu")
    for got, want in zip(args[1:], jax_args[1:]):
        np.testing.assert_array_equal(_np(got), _np(want))
        assert got.dtype == torch.from_numpy(_np(want)).dtype and got.device.type == "cpu"
    jax_states, jax_values = jax_fn(*jax_args)
    states, values = fn(*args)
    for name, leaves in jax_states.items():
        assert set(states[name]) == set(leaves)
        for leaf, want in leaves.items():
            want = _np(want)
            assert np.array_equal(want, np.round(want)), (name, leaf)
            assert states[name][leaf].dtype == torch.from_numpy(want).dtype, (name, leaf)
            np.testing.assert_array_equal(_np(states[name][leaf]), want, err_msg=f"{name}.{leaf}")
    assert set(values) == set(jax_values) == {"acc", "f1", "confmat"}
    np.testing.assert_array_equal(_np(values["confmat"]), _np(jax_values["confmat"]))
    for name in ("acc", "f1"):
        np.testing.assert_allclose(float(values[name]), float(jax_values[name]), atol=VALUE_ATOL, rtol=VALUE_ATOL)


@pytest.fixture(scope="module")
def jax_flagship():
    mesh = jax.make_mesh((NUM_DEVICES,), ("dp",))
    step, args, finalize = graft._flagship_step_fn(mesh, NUM_DEVICES)
    return args, {k: float(v) for k, v in finalize(step(*args)).items()}


def _jax_fid(imgs_real, imgs_fake, feature_dim: int = 16) -> float:
    """The JAX package's FID on the flagship's images behind the port's numpy projection."""
    from torchmetrics_tpu.image import FrechetInceptionDistance

    proj = jnp.asarray(toy_projection(feature_dim))

    class Projection:
        num_features = feature_dim

        def __call__(self, imgs):
            return jnp.reshape(jnp.asarray(imgs, jnp.float32), (imgs.shape[0], -1)) @ proj

    fid = FrechetInceptionDistance(feature=Projection(), normalize=True)
    fid.update(jnp.asarray(imgs_real), real=True)
    fid.update(jnp.asarray(imgs_fake), real=False)
    return float(fid.compute())


def test_flagship_step_fn_matches_the_jax_flagship_on_the_cpu_mesh(jax_flagship):
    jax_args, want = jax_flagship
    step, args, finalize = _flagship_step_fn(NUM_DEVICES, device="cpu")
    preds, target, det_batch, imgs_real, imgs_fake = args
    for got, ref in zip((preds, target, *det_batch, imgs_real, imgs_fake),
                        (*jax_args[:2], *jax_args[2], *jax_args[3:])):
        np.testing.assert_array_equal(_np(got), _np(ref))
    got = {k: float(v) for k, v in finalize(step(*args)).items()}
    assert set(got) == set(want) == {"acc", "f1", "map", "fid"}
    for key in ("acc", "f1", "map"):
        assert got[key] == want[key], key
    assert 0.0 < want["map"] <= 1.0
    fid = _jax_fid(_np(imgs_real), _np(imgs_fake))
    assert abs(got["fid"] - fid) <= FID_RTOL * abs(fid)


def test_flagship_step_halves_compose_and_the_sync_is_timed():
    step, args, finalize = _flagship_step_fn(2, device="cpu")
    whole = finalize(step(*args))
    halves = finalize(step.sync_only(step.local_step(*args)))
    assert {k: float(v) for k, v in whole.items()} == {k: float(v) for k, v in halves.items()}
    assert step.args is args and flagship_sync_latency_ms(step, iters=2) >= 0.0


def test_dryrun_multichip_over_two_gloo_ranks_equals_the_unsharded_step(monkeypatch):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    result = dryrun_multichip(2, device="cpu")
    assert result["backend"] == "gloo" and len(result["ranks"]) == 2
    want = sharded_values(2, device="cpu")  # a world of one: the whole batch in this process
    assert result["unsharded"] == want
    for rank in result["ranks"]:
        assert rank["collection"] == want["collection"]
        assert {k: rank["flagship"][k] for k in ("acc", "f1", "map")} == {
            k: want["flagship"][k] for k in ("acc", "f1", "map")}
        assert abs(rank["flagship"]["fid"] - want["flagship"]["fid"]) <= FID_RTOL * abs(want["flagship"]["fid"])
    # the unsharded collection is the JAX package's fused collection over the same 8 rows
    rng = np.random.default_rng(0)
    preds = rng.normal(size=(8, 5)).astype(np.float32)
    target = rng.integers(0, 5, 8, dtype=np.int32)
    pure = graft._pure_collection()
    jax_states = pure.update(pure.init(), jnp.asarray(preds), jnp.asarray(target))
    for name, leaves in jax_states.items():
        for leaf, value in leaves.items():
            assert want["collection"]["states"][name][leaf] == _np(value).tolist(), (name, leaf)


def test_dryrun_multichip_backend_is_the_callers_choice(monkeypatch):
    with pytest.raises(ValueError, match="NCCL runs on the card"):
        dryrun_multichip(2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend must be"):
        dryrun_multichip(2, device="cpu", backend="mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 cards but only 1"):
        dryrun_multichip(2)
