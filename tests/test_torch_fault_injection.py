"""The port's state-integrity guards under injected faults, held against the JAX package
(``tests/test_fault_injection.py``'s guard cases): NaN and Inf at ``merge_state`` on
either side, a NaN participant at ``sync``, truncated checkpoints at
``load_state_dict`` for a metric and a collection, the ``validate=False`` escape hatch,
the finiteness scan opted into through ``ReliabilityConfig``, ``DeadRank``'s
tombstone, and legitimate NaN in a cat state passing the sync guard.

Each case runs the same numpy-seeded inputs through both packages: the same guard must
fire (``StateCorruptionError`` with the same leaf named) or both must pass, and the
values that survive are held against each other (counts bit for bit, float values
within 1e-6 relative).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as tm
import torchmetrics_tpu.reliability as jax_rel
import torchmetrics_tpu_torch as tt
from torchmetrics_tpu.utilities.exceptions import StateCorruptionError as JaxStateCorruptionError
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.reliability import (
    DeadRank,
    ReliabilityConfig,
    poison_state_leaf,
    truncate_state_dict,
    validate_state,
)
from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError

pytestmark = pytest.mark.faults

CPU = {"device": "cpu"}
NUM_CLASSES = 5


def _cls_data(n=48, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, NUM_CLASSES)).astype(np.float32), rng.integers(0, NUM_CLASSES, n).astype(np.int32)


def _np(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _close(port, ref, context=""):
    port, ref = _np(port), _np(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape, context
    if np.issubdtype(port.dtype, np.floating):
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0, err_msg=context)
    else:
        np.testing.assert_array_equal(port, ref, err_msg=context)


class Both:
    """Each package's entry points for one case: ``lib`` builds its metrics with ``kw``,
    ``arr`` turns numpy into its array."""

    port = {"lib": tt, "arr": torch.from_numpy, "kw": CPU, "poison": poison_state_leaf,
            "truncate": truncate_state_dict, "error": StateCorruptionError, "config": ReliabilityConfig}
    jax = {"lib": tm, "arr": jnp.asarray, "kw": {}, "poison": jax_rel.poison_state_leaf,
           "truncate": jax_rel.truncate_state_dict, "error": JaxStateCorruptionError, "config": jax_rel.ReliabilityConfig}


SIDES = {"port": Both.port, "jax": Both.jax}


def _raised(call, error):
    """The message of ``error`` that ``call`` raised, or None."""
    try:
        call()
    except error as exc:
        return str(exc)
    return None


# ----------------------------------------------------------------- guards: merge


def _poisoned_mean_merge(side, kind):
    s = SIDES[side]
    mean = s["lib"].MeanMetric(reliability=s["config"](), **s["kw"])
    shard = s["lib"].MeanMetric(**s["kw"])
    mean.update(s["arr"](np.asarray([1.0, 2.0], np.float32)))
    shard.update(s["arr"](np.asarray([3.0, 4.0], np.float32)))
    s["poison"](shard, "mean_value", kind=kind)
    message = _raised(lambda: mean.merge_state(shard), s["error"])
    return message, mean.compute()


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_a_non_finite_incoming_shard_is_caught_at_merge(kind):
    port_msg, port_value = _poisoned_mean_merge("port", kind)
    jax_msg, jax_value = _poisoned_mean_merge("jax", kind)
    assert port_msg == jax_msg and "non-finite" in port_msg and "(incoming)" in port_msg
    _close(port_value, jax_value)  # the accumulator is untouched: 1.5
    assert float(port_value) == 1.5


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_a_non_finite_local_accumulator_is_caught_at_merge(kind):
    messages = []
    for side in ("port", "jax"):
        s = SIDES[side]
        acc = s["lib"].SumMetric(reliability=s["config"](), **s["kw"])
        clean = s["lib"].SumMetric(**s["kw"])
        acc.update(s["arr"](np.asarray([1.0, 2.0], np.float32)))
        clean.update(s["arr"](np.asarray([3.0], np.float32)))
        s["poison"](acc, "sum_value", kind=kind)
        messages.append(_raised(lambda: acc.merge_state(clean), s["error"]))
    assert messages[0] == messages[1] and "(local)" in messages[0]


def test_shape_and_dtype_damage_of_an_int_state_is_caught_at_merge():
    preds, target = _cls_data()
    outcomes = []
    for side in ("port", "jax"):
        s = SIDES[side]
        acc = s["lib"].MulticlassAccuracy(NUM_CLASSES, average="micro", reliability=s["config"](), **s["kw"])
        shard = s["lib"].MulticlassAccuracy(NUM_CLASSES, average="micro", **s["kw"])
        acc.update(s["arr"](preds), s["arr"](target))
        shard.update(s["arr"](preds), s["arr"](target))
        before = {k: _np(v).copy() for k, v in acc.metric_state.items()}
        s["poison"](shard, "tp")  # an int state: cast to float32, then NaN
        outcomes.append(_raised(lambda: acc.merge_state(shard), s["error"]))
        for k, v in before.items():
            np.testing.assert_array_equal(_np(acc.metric_state[k]), v)
    assert outcomes[0] == outcomes[1] and "dtype" in outcomes[0]


def test_a_clean_merge_folds_and_no_config_folds_nan_silently():
    for side in ("port", "jax"):
        s = SIDES[side]
        a = s["lib"].MeanMetric(reliability=s["config"](), **s["kw"])
        b = s["lib"].MeanMetric(**s["kw"])
        a.update(s["arr"](np.asarray([1.0, 2.0], np.float32)))
        b.update(s["arr"](np.asarray([3.0, 4.0], np.float32)))
        a.merge_state(b)
        assert float(a.compute()) == 2.5
        loose, bad = s["lib"].MeanMetric(**s["kw"]), s["lib"].MeanMetric(**s["kw"])
        loose.update(s["arr"](np.asarray(1.0, np.float32)))
        bad.update(s["arr"](np.asarray(2.0, np.float32)))
        s["poison"](bad, "mean_value")
        loose.merge_state(bad)  # no raise: the guards are opt-in
        assert np.isnan(float(loose.compute()))


# ------------------------------------------------------------------ guards: sync


def test_a_nan_participant_is_caught_at_sync_and_the_local_state_survives():
    outcomes = []
    for side in ("port", "jax"):
        s = SIDES[side]

        def nan_gather(value, process_group=None, s=s):
            if s is Both.port:
                v = torch.as_tensor(value)
                return [v, torch.full_like(v.float(), float("nan"))]
            v = jnp.asarray(value)
            return [v, jnp.full_like(v.astype(jnp.float32), jnp.nan)]

        m = s["lib"].MeanMetric(dist_sync_fn=nan_gather, distributed_available_fn=lambda: True,
                                reliability=s["config"](), **s["kw"])
        m.update(s["arr"](np.asarray([2.0, 4.0], np.float32)))
        outcomes.append(_raised(m.sync, s["error"]))
        assert not m._is_synced
        assert float(_np(m._state["mean_value"])) == 6.0  # local intact (the sum-form state)
    assert outcomes[0] == outcomes[1] and ".sync" in outcomes[0] and "non-finite" in outcomes[0]


def test_a_cat_state_with_legitimate_nan_passes_the_sync_guard():
    values = np.asarray([1.0, np.nan, 3.0], np.float32)
    synced = []
    for side in ("port", "jax"):
        s = SIDES[side]
        if s is Both.port:
            gather = lambda value, process_group=None: [torch.as_tensor(value)] * 2  # noqa: E731
        else:
            gather = lambda value, process_group=None: [jnp.asarray(value)] * 2  # noqa: E731
        m = s["lib"].CatMetric(nan_strategy="disable", dist_sync_fn=gather, distributed_available_fn=lambda: True,
                               reliability=s["config"](), **s["kw"])
        m.update(s["arr"](values))
        m.sync()  # must not raise
        assert m._is_synced
        synced.append(np.concatenate([_np(v).reshape(-1) for v in m._state["value"]]))
    np.testing.assert_array_equal(synced[0], synced[1])  # NaN where NaN
    np.testing.assert_array_equal(synced[0], np.concatenate([values, values]))


def test_validate_state_names_the_poisoned_leaf():
    m = tt.MeanMetric(**CPU)
    m.update(torch.tensor([1.0]))
    validate_state(m)
    poison_state_leaf(m, "mean_value")
    with pytest.raises(StateCorruptionError, match="mean_value"):
        validate_state(m)


def test_poisoning_replaces_the_leaf_so_aliased_members_see_it():
    a = tt.MeanMetric(**CPU)
    b = tt.MeanMetric(**CPU)
    a.update(torch.tensor([1.0]))
    b._state = a._state  # compute-group members alias one dict
    kept = a._state["mean_value"]
    poison_state_leaf(a, "mean_value")
    assert b._state["mean_value"] is a._state["mean_value"] is not kept
    assert float(kept) == 1.0 and torch.isnan(b._state["mean_value"])
    with pytest.raises(KeyError, match="no state"):
        poison_state_leaf(a, "missing")


# ----------------------------------------------------------- checkpoint restore


def _saved(side):
    s = SIDES[side]
    preds, target = _cls_data()
    m = s["lib"].MulticlassAccuracy(NUM_CLASSES, average="micro", **s["kw"])
    m.update(s["arr"](preds), s["arr"](target))
    m.persistent(True)
    return m, m.state_dict()


@pytest.mark.parametrize("damage, match", [({"drop_keys": ["fp"]}, "truncated"), ({"slice_keys": ["tp"]}, "shape")])
def test_a_truncated_checkpoint_raises_and_validate_false_forces_the_load(damage, match):
    outcomes = []
    for side in ("port", "jax"):
        s = SIDES[side]
        _, sd = _saved(side)
        bad = s["truncate"](sd, **damage)
        assert set(sd) >= set(bad) and len(sd) >= len(bad)
        fresh = s["lib"].MulticlassAccuracy(NUM_CLASSES, average="micro", **s["kw"])
        outcomes.append(_raised(lambda: fresh.load_state_dict(bad), s["error"]))
        assert fresh.update_count == 0  # nothing adopted
        if "drop_keys" in damage:
            forced = s["lib"].MulticlassAccuracy(NUM_CLASSES, average="micro", **s["kw"])
            forced.load_state_dict(bad, validate=False)
            assert forced.update_count == 1
    assert outcomes[0] == outcomes[1] and match in outcomes[0]


def test_truncation_copies_and_keeps_tensors_tensors():
    m, sd = _saved("port")
    cm = tt.MulticlassConfusionMatrix(NUM_CLASSES, **CPU)
    cm.update(*map(torch.from_numpy, _cls_data()))
    cm.persistent(True)
    sd.update({f"cm.{k}": v for k, v in cm.state_dict().items()})
    bad = truncate_state_dict(sd, drop_keys=["fp"], slice_keys=["tp", "cm.confmat", "_update_count"])
    assert "fp" in sd and "fp" not in bad and torch.equal(sd["tp"], m._state["tp"])
    for key, full in (("tp", m._state["tp"]), ("cm.confmat", cm._state["confmat"])):
        assert isinstance(bad[key], torch.Tensor) and torch.equal(bad[key], full[: NUM_CLASSES // 2])
    assert bad["_update_count"].shape == (1,)  # rank damage for a scalar


def test_a_clean_restore_still_works_and_an_absent_metric_is_a_no_op():
    m, sd = _saved("port")
    fresh = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", **CPU)
    fresh.load_state_dict(sd)
    _close(fresh.compute(), m.compute())
    assert fresh.update_count == m.update_count
    other = tt.MulticlassAccuracy(NUM_CLASSES, average="micro", **CPU)
    other.load_state_dict({"someothermetric.total": np.zeros(())})
    assert other.update_count == 0


def test_a_collections_truncated_checkpoint_raises():
    preds, target = _cls_data()
    outcomes = []
    for side in ("port", "jax"):
        s = SIDES[side]
        extra = CPU if s is Both.port else {}
        collection = MetricCollection if s is Both.port else tm.MetricCollection

        def members():
            return {"acc": s["lib"].MulticlassAccuracy(NUM_CLASSES, average="micro", **extra),
                    "conf": s["lib"].MulticlassConfusionMatrix(NUM_CLASSES, **extra)}

        coll = collection(members(), **extra)
        coll.update(s["arr"](preds), s["arr"](target))
        coll.persistent(True)
        bad = s["truncate"](coll.state_dict(), drop_keys=["acc.tp"])
        outcomes.append(_raised(lambda: collection(members(), **extra).load_state_dict(bad), s["error"]))
    assert outcomes[0] == outcomes[1] and "truncated" in outcomes[0]


def test_the_finiteness_scan_at_restore_is_opted_into_through_the_config():
    outcomes = []
    for side in ("port", "jax"):
        s = SIDES[side]
        m = s["lib"].MeanMetric(**s["kw"])
        m.update(s["arr"](np.asarray([1.0], np.float32)))
        m.persistent(True)
        sd = m.state_dict()
        sd["mean_value"] = np.asarray(np.nan, np.float32)
        s["lib"].MeanMetric(**s["kw"]).load_state_dict(dict(sd))  # structural checks only
        off = s["config"](validate_on_restore=False)
        s["lib"].MeanMetric(reliability=off, **s["kw"]).load_state_dict(dict(sd))
        strict = s["lib"].MeanMetric(reliability=s["config"](), **s["kw"])
        outcomes.append(_raised(lambda: strict.load_state_dict(dict(sd)), s["error"]))
    assert outcomes[0] == outcomes[1] and "non-finite" in outcomes[0]


# ------------------------------------------------------------------ DeadRank


def _world_of_one(lib):
    if lib is tt:
        return lambda value, group=None: [torch.as_tensor(value)]
    return lambda value, group=None: [jnp.asarray(value)]


def _dead_rank_sync(side, revive: bool):
    s = SIDES[side]
    dead = (DeadRank if s is Both.port else jax_rel.DeadRank)(inner=_world_of_one(s["lib"]), world=2, rank=1)
    if revive:
        dead.revive()
    m = s["lib"].SumMetric(dist_sync_fn=dead, distributed_available_fn=lambda: True, **s["kw"])
    m.update(s["arr"](np.asarray([1.5, 2.0], np.float32)))
    m.sync()
    return _np(m._state["sum_value"]), dead.calls, dead.zeroed


@pytest.mark.parametrize("revive", [False, True])
def test_a_dead_ranks_tombstone_folds_the_survivors_only(revive):
    port, jax_ = _dead_rank_sync("port", revive), _dead_rank_sync("jax", revive)
    assert port[1:] == jax_[1:]
    _close(port[0], jax_[0])
    assert float(port[0]) == (7.0 if revive else 3.5)  # a live mirror doubles the sum
    assert port[2] == (0 if revive else port[1])


def test_dead_rank_checks_its_world():
    with pytest.raises(ValueError, match="world of at least 2"):
        DeadRank(inner=_world_of_one(tt), world=1)
    with pytest.raises(ValueError, match="rank must be"):
        DeadRank(inner=_world_of_one(tt), world=2, rank=2)
