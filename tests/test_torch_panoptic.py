"""The port's panoptic quality and modified panoptic quality against the JAX package, on
the CPU.

The same seeded segment maps (blocks of segments, so that predictions match targets
above an IoU of 0.5, with jitter, relabelled segments, void pixels of categories in
neither set, negative instance ids) go through the JAX functional and class and the
port's. Tolerances:

- states (the float32 IoU sums and the int32 counts) bit for bit: both packages build
  each batch's sums by the same float64 numpy algorithm, rounded once to float32;
- per-class qualities bit for bit (elementwise float32 on equal sums); their means over
  the classes seen within 1e-6 (the JAX package adds them in float32, the port in
  float64 rounded once).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import detection as jax_det
from torchmetrics_tpu.functional import detection as jax_fdet
from torchmetrics_tpu_torch import detection as port_det
from torchmetrics_tpu_torch.functional import detection as port_fdet
from torchmetrics_tpu_torch.functional.detection import panoptic_qualities as port_pq

CPU = {"device": "cpu"}
MEAN_ATOL = 1e-6
THINGS, STUFFS = {1, 2, 3}, {6, 7}
UNKNOWN = 9  # in neither set: void in a target, and in a prediction only where allowed
B, H, W, CELL = 3, 12, 16, 4  # one shape for every case: JAX compiles each once


def _segment_maps(rng, b: int = B, things=THINGS, stuffs=STUFFS, unknown_in_preds: bool = False,
                  negative_instances: bool = False):
    """(preds, target), int32 ``(b, H, W, 2)``: blocks of ``CELL`` pixels, each a segment
    of a seeded category; predictions are the targets with jittered pixels and a few
    relabelled segments; about 10% of the target's blocks are void."""
    cats = np.array(sorted(things | stuffs))
    gh, gw = H // CELL, W // CELL
    seg = rng.integers(0, 5, size=(b, gh, gw))
    seg_cat = cats[rng.integers(0, len(cats), size=(b, 5))]
    inst = np.where(np.isin(seg_cat, list(things)), np.arange(1, 6), 0)
    if negative_instances:
        inst = inst - 3
    rows = np.arange(b)[:, None, None]
    target = np.stack([seg_cat[rows, seg], inst[rows, seg]], axis=-1).repeat(CELL, 1).repeat(CELL, 2)
    preds = target.copy()
    jitter = rng.random((b, H, W)) < 0.15
    preds[jitter] = np.roll(target, 1, axis=2)[jitter]
    relabel = rng.random((b, H, W)) < 0.05
    preds[..., 0][relabel] = cats[rng.integers(0, len(cats), size=int(relabel.sum()))]
    void = (rng.random((b, gh, gw)) < 0.1).repeat(CELL, 1).repeat(CELL, 2)
    target[void] = (UNKNOWN, 0)
    if unknown_in_preds:
        preds[rng.random((b, H, W)) < 0.05] = (UNKNOWN, 0)
    return preds.astype(np.int32), target.astype(np.int32)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_value(got, want, per_class: bool):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if per_class:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=MEAN_ATOL)


def _assert_states(port_metric, jax_metric):
    assert list(port_metric._state) == list(jax_metric._state)
    for name, want in jax_metric._state.items():
        got = port_metric._state[name]
        assert got.dtype == getattr(torch, str(np.asarray(want).dtype))
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=name)


FLAGS = [{}, {"return_sq_and_rq": True}, {"return_per_class": True},
         {"return_sq_and_rq": True, "return_per_class": True}]


@pytest.mark.parametrize("flags", FLAGS, ids=["pq", "sq_rq", "per_class", "per_class_sq_rq"])
@pytest.mark.parametrize("seed", [0, 1])
def test_functional_panoptic_quality_matches_the_jax_package(flags, seed):
    preds, target = _segment_maps(np.random.default_rng(seed), unknown_in_preds=True, negative_instances=seed == 1)
    kw = {"things": THINGS, "stuffs": STUFFS, "allow_unknown_preds_category": True, **flags}
    want = jax_fdet.panoptic_quality(jnp.asarray(preds), jnp.asarray(target), **kw)
    got = port_fdet.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    _assert_value(got, want, per_class=flags.get("return_per_class", False))


@pytest.mark.parametrize("seed", [0, 1])
def test_functional_modified_panoptic_quality_matches_the_jax_package(seed):
    preds, target = _segment_maps(np.random.default_rng(seed), negative_instances=seed == 1)
    want = jax_fdet.modified_panoptic_quality(jnp.asarray(preds), jnp.asarray(target), THINGS, STUFFS)
    got = port_fdet.modified_panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS)
    _assert_value(got, want, per_class=False)


def _pair(variant: str, flags: dict):
    if variant == "pq":
        return (jax_det.PanopticQuality(THINGS, STUFFS, **flags),
                port_det.PanopticQuality(THINGS, STUFFS, **flags, **CPU))
    return jax_det.ModifiedPanopticQuality(THINGS, STUFFS), port_det.ModifiedPanopticQuality(THINGS, STUFFS, **CPU)


@pytest.mark.parametrize("variant, flags", [("pq", f) for f in FLAGS] + [("mpq", {})],
                         ids=["pq", "pq_sq_rq", "pq_per_class", "pq_per_class_sq_rq", "mpq"])
def test_class_states_and_values_match_the_jax_package(variant, flags):
    """update, forward and compute over three batches; states after each step bit for bit."""
    rng = np.random.default_rng(5)
    jax_metric, port_metric = _pair(variant, flags)
    per_class = flags.get("return_per_class", False)
    for step in range(3):
        preds, target = _segment_maps(rng)
        if step == 1:
            want = jax_metric.forward(jnp.asarray(preds), jnp.asarray(target))
            _assert_value(port_metric.forward(torch.from_numpy(preds), torch.from_numpy(target)), want, per_class)
        else:
            jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
            port_metric.update(preds, target)  # numpy input is read as it is, on the host
        _assert_states(port_metric, jax_metric)
    assert int(port_metric.true_positives.sum()) > 0 and int(port_metric.false_positives.sum()) > 0
    _assert_value(port_metric.compute(), jax_metric.compute(), per_class)


def test_merge_state_and_checkpoint_cross_over():
    """Shards merged equal one metric over all batches, in both packages; a JAX
    checkpoint loads into the port with the same keys and computes the same value."""
    rng = np.random.default_rng(8)
    batches = [_segment_maps(rng) for _ in range(3)]
    shards = []
    for lib, kw in ((jax_det, {}), (port_det, CPU)):
        parts = [lib.PanopticQuality(THINGS, STUFFS, **kw) for _ in batches]
        for part, (preds, target) in zip(parts, batches):
            part.update(jnp.asarray(preds) if lib is jax_det else torch.from_numpy(preds),
                        jnp.asarray(target) if lib is jax_det else torch.from_numpy(target))
        for part in parts[1:]:
            parts[0].merge_state(part)
        shards.append(parts[0])
    _assert_states(shards[1], shards[0])
    shards[0].persistent(True)
    shards[1].persistent(True)
    jax_sd, port_sd = shards[0].state_dict(), shards[1].state_dict()
    assert set(jax_sd) == set(port_sd)
    restored = port_det.PanopticQuality(THINGS, STUFFS, **CPU)
    restored.load_state_dict(jax_sd)
    _assert_states(restored, shards[0])
    _assert_value(restored.compute(), shards[0].compute(), per_class=False)


@pytest.mark.parametrize("things, stuffs", [({1, 2, 3}, {6, 7}), ({-4, 2, 3}, {6, 1 << 30})],
                         ids=["small", "negative_and_large"])
def test_category_and_instance_ids_of_any_range_give_the_jax_packages_states(things, stuffs):
    """Negative instance ids, and categories that are negative or above 2**24, give the
    JAX package's states."""
    preds, target = _segment_maps(np.random.default_rng(3), things=things, stuffs=stuffs, negative_instances=True)
    jax_metric = jax_det.PanopticQuality(things, stuffs, return_per_class=True)
    port_metric = port_det.PanopticQuality(things, stuffs, return_per_class=True, **CPU)
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    port_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_states(port_metric, jax_metric)


def test_means_over_the_classes_do_not_depend_on_their_order():
    """The means add exactly, so the card's reduction order gives the CPU's bits."""
    rng = np.random.default_rng(5)
    n = 133
    sums = (rng.uniform(0, 40, n).astype(np.float32), rng.integers(0, 50, n).astype(np.int32),
            rng.integers(0, 9, n).astype(np.int32), rng.integers(0, 9, n).astype(np.int32))
    order = rng.permutation(n)
    means = [port_pq._panoptic_quality_compute(*(torch.from_numpy(np.ascontiguousarray(s[perm])) for s in sums))[3:]
             for perm in (np.arange(n), order, order[::-1])]
    for got in means[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got, means[0]))


@pytest.mark.parametrize("build", [
    lambda lib, kw: lib.PanopticQuality({1}, {1}, **kw),
    lambda lib, kw: lib.PanopticQuality({"a"}, {2}, **kw),
    lambda lib, kw: lib.PanopticQuality(set(), set(), **kw),
], ids=["overlap", "not_int", "empty"])
def test_invalid_categories_raise_the_jax_packages_error(build):
    with pytest.raises(Exception) as want:
        build(jax_det, {})
    with pytest.raises(Exception) as got:
        build(port_det, CPU)
    assert type(got.value).__name__ == type(want.value).__name__ and str(got.value) == str(want.value)


def test_unknown_prediction_category_raises_unless_allowed():
    preds, target = _segment_maps(np.random.default_rng(2), unknown_in_preds=True)
    errors = []
    for fn, as_array in ((jax_fdet.panoptic_quality, jnp.asarray), (port_fdet.panoptic_quality, torch.from_numpy)):
        with pytest.raises(ValueError) as err:
            fn(as_array(preds), as_array(target), THINGS, STUFFS)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "Unknown categories" in errors[0]
