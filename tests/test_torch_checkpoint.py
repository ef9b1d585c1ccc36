"""The checkpoint guard of ``load_state_dict`` in the port, held to the JAX package's.

The same numpy inputs go through both packages' ``MulticlassAccuracy(5)``; each
package's ``state_dict()`` is damaged in the same two ways (one state key dropped, one
state sliced to ``[:2]``), and both must raise ``StateCorruptionError`` and leave the
target metric untouched. A partial save that is complete (persistent and
non-persistent states mixed, with the ``_saved_states`` manifest) loads in both, and
``validate=False`` forces a partial load in both.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
from torchmetrics_tpu.utilities.exceptions import StateCorruptionError as JaxStateCorruptionError
from torchmetrics_tpu_torch import Metric, MetricCollection
from torchmetrics_tpu_torch.classification import MulticlassAccuracy
from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError

_RNG = np.random.default_rng(3)
PREDS = _RNG.normal(size=(64, 5)).astype(np.float32)
TARGET = _RNG.integers(0, 5, 64).astype(np.int32)


def _saved(package: str) -> dict:
    if package == "jax":
        metric = jtm.MulticlassAccuracy(5)
        metric.persistent(True)
        metric.update(jnp.asarray(PREDS), jnp.asarray(TARGET))
    else:
        metric = MulticlassAccuracy(5, device="cpu")
        metric.persistent(True)
        metric.update(torch.from_numpy(PREDS), torch.from_numpy(TARGET))
    return metric.state_dict()


def _fresh(package: str):
    return jtm.MulticlassAccuracy(5) if package == "jax" else MulticlassAccuracy(5, device="cpu")


def _drop_tp(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k != "tp"}


def _slice_tp(sd: dict) -> dict:
    return {**sd, "tp": sd["tp"][:2]}


ERRORS = {"jax": JaxStateCorruptionError, "torch": StateCorruptionError}


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("damage, match", [(_drop_tp, "truncated"), (_slice_tp, "shape")], ids=["key_dropped", "sliced"])
def test_damaged_checkpoint_raises_in_both_packages(package, damage, match):
    fresh = _fresh(package)
    with pytest.raises(ERRORS[package], match=match):
        fresh.load_state_dict(damage(_saved(package)))
    assert fresh._update_count == 0  # nothing was adopted


def test_port_error_is_a_runtime_error_and_validate_is_on_by_default():
    import inspect

    assert issubclass(StateCorruptionError, RuntimeError)
    assert inspect.signature(Metric.load_state_dict).parameters["validate"].default is True


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_validate_false_forces_a_partial_load(package):
    fresh = _fresh(package)
    fresh.load_state_dict(_drop_tp(_saved(package)), validate=False)
    assert fresh._update_count == 1
    assert np.asarray(fresh._state["fp"]).sum() > 0  # the surviving states were adopted


def test_intact_checkpoint_loads_the_same_values_in_both_packages():
    values = {}
    for package in ("jax", "torch"):
        fresh = _fresh(package)
        fresh.load_state_dict(_saved(package))
        values[package] = (np.asarray(fresh.compute()), {k: np.asarray(v) for k, v in fresh._state.items()})
    assert values["jax"][0] == pytest.approx(values["torch"][0], abs=1e-7)  # one f32 ratio
    for key, value in values["jax"][1].items():
        np.testing.assert_array_equal(values["torch"][1][key], value)  # counts bit for bit


class _JaxMixed(jtm.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", default=np.zeros((), np.float32), dist_reduce_fx="sum", persistent=True)
        self.add_state("scratch", default=np.zeros((), np.float32), dist_reduce_fx="sum", persistent=False)

    def _batch_state(self, x):
        return {"total": jnp.asarray(x, jnp.float32), "scratch": jnp.asarray(x, jnp.float32)}

    def _compute(self, state):
        return state["total"]


class _TorchMixed(Metric):
    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum", persistent=True)
        self.add_state("scratch", default=torch.zeros(()), dist_reduce_fx="sum", persistent=False)

    def _batch_state(self, x):
        return {"total": torch.as_tensor(x, dtype=torch.float32), "scratch": torch.as_tensor(x, dtype=torch.float32)}

    def _compute(self, state):
        return state["total"]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_complete_partial_save_loads_and_a_lost_key_still_raises(package):
    cls = _JaxMixed if package == "jax" else _TorchMixed
    metric = cls()
    metric.update(2.0)
    sd = metric.state_dict()
    assert "total" in sd and "scratch" not in sd and sd["_saved_states"] == 1
    fresh = cls()
    fresh.load_state_dict(sd)
    assert float(np.asarray(fresh.compute())) == 2.0 and fresh._update_count == 1
    with pytest.raises(ERRORS[package], match="truncated"):
        cls().load_state_dict({k: v for k, v in sd.items() if k != "total"})


def test_collection_checkpoint_is_guarded_member_by_member():
    def build():
        return MetricCollection({"a": MulticlassAccuracy(5, device="cpu"), "b": MulticlassAccuracy(5, device="cpu")},
                                device="cpu", compute_groups=False)

    coll = build()
    coll.persistent(True)
    coll.update(torch.from_numpy(PREDS), torch.from_numpy(TARGET))
    sd = coll.state_dict()
    with pytest.raises(StateCorruptionError, match="'b.\\*'"):
        build().load_state_dict({k: v for k, v in sd.items() if k != "b.fn"})
    partial = build()
    partial.load_state_dict({k: v for k, v in sd.items() if k != "b.fn"}, validate=False)
    assert partial["a"].update_count == 1
