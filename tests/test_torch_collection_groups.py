"""The port's ``MetricCollection`` compute groups, ``forward``, checkpoints, ``clone``,
``merge_state``, grouped ``sync`` and ``on_error`` policies, held to the JAX package's.

Mirrors ``tests/test_collections.py``, ``tests/test_compute_group_fuzz.py`` (group
formation) and ``tests/test_fault_injection.py`` (skip and quarantine). The same numpy
inputs go through the JAX collection and its port twin on the CPU. Counts (tp/fp/tn/fn,
confusion matrices) must match bit for bit; computed float32 ratios within 1e-6
absolute, the two packages' division and mean orders differing by an ulp at most.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
from torchmetrics_tpu import MetricCollection as JaxCollection
from torchmetrics_tpu_torch import Metric, MetricCollection, QuarantinedMetric
from torchmetrics_tpu_torch import classification as tc

C = 5
N = 48
RATIO_ATOL = 1e-6

_rng = np.random.default_rng(23)
PREDS = _rng.normal(size=(4, N, C)).astype(np.float32)
TARGET = _rng.integers(0, C, (4, N)).astype(np.int32)

MEMBERS = {
    "acc": ("MulticlassAccuracy", {"average": "micro"}),
    "prec": ("MulticlassPrecision", {"average": "macro"}),
    "rec": ("MulticlassRecall", {"average": "macro"}),
    "f1": ("MulticlassF1Score", {"average": "macro"}),
    "cm": ("MulticlassConfusionMatrix", {}),
}


def _collections(compute_groups=True, names=tuple(MEMBERS), **kw):
    jax_coll = JaxCollection(
        {n: getattr(jtm, MEMBERS[n][0])(C, **MEMBERS[n][1]) for n in names}, compute_groups=compute_groups, **kw
    )
    torch_coll = MetricCollection(
        {n: getattr(tc, MEMBERS[n][0])(C, device="cpu", **MEMBERS[n][1]) for n in names},
        compute_groups=compute_groups, device="cpu", **kw,
    )
    return jax_coll, torch_coll


def _batch(i):
    return (jnp.asarray(PREDS[i]), jnp.asarray(TARGET[i])), (torch.from_numpy(PREDS[i]), torch.from_numpy(TARGET[i]))


def _hold(jax_values, torch_values):
    assert set(jax_values) == set(torch_values)
    for key, want in jax_values.items():
        got = torch_values[key]
        if isinstance(want, jtm.QuarantinedMetric):
            assert isinstance(got, QuarantinedMetric)
            assert (got.name, got.status, got.stage, got.update_count) == (want.name, want.status, want.stage,
                                                                         want.update_count)
            continue
        want, got = np.asarray(want), got.numpy()
        if np.issubdtype(want.dtype, np.integer) or key.endswith("cm"):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, atol=RATIO_ATOL, rtol=0, err_msg=key)


def _groups(coll):
    return sorted(sorted(g) for g in coll.compute_groups.values())


@pytest.mark.parametrize("compute_groups", [True, False])
def test_updates_match_jax(compute_groups):
    jax_coll, torch_coll = _collections(compute_groups)
    for i in range(4):
        jax_args, torch_args = _batch(i)
        jax_coll.update(*jax_args)
        torch_coll.update(*torch_args)
    _hold(jax_coll.compute(), torch_coll.compute())
    assert _groups(torch_coll) == _groups(jax_coll)


def test_groups_are_formed_as_in_jax_and_alias_one_state():
    jax_coll, torch_coll = _collections()
    jax_coll.update(*_batch(0)[0])
    torch_coll.update(*_batch(0)[1])
    assert _groups(torch_coll) == _groups(jax_coll) == [["acc", "f1", "prec", "rec"], ["cm"]]
    leader = torch_coll["acc"]
    assert all(torch_coll[n]._state is leader._state for n in ("f1", "prec", "rec"))
    assert torch_coll["cm"]._state is not leader._state
    assert len({id(m._state) for m in torch_coll.values()}) == len(torch_coll.compute_groups)


@pytest.mark.parametrize("groups", [[["acc", "f1"], ["prec", "rec"], ["cm"]], [["acc"], ["f1", "prec", "rec"], ["cm"]]],
                         ids=["pairs", "triple"])
def test_explicit_group_lists_match_jax(groups):
    jax_coll, torch_coll = _collections(groups)
    for i in range(3):
        jax_args, torch_args = _batch(i)
        jax_coll.update(*jax_args)
        torch_coll.update(*torch_args)
    assert torch_coll.compute_groups == jax_coll.compute_groups
    _hold(jax_coll.compute(), torch_coll.compute())


def test_explicit_group_with_an_unknown_name_raises():
    _, torch_coll = _collections([["acc", "nope"]])
    with pytest.raises(ValueError, match="does not match a metric"):
        torch_coll.update(*_batch(0)[1])


def test_grouped_values_equal_ungrouped_bit_for_bit():
    _, grouped = _collections(True)
    _, plain = _collections(False)
    for i in range(4):
        grouped.update(*_batch(i)[1])
        plain.update(*_batch(i)[1])
    got, want = grouped.compute(), plain.compute()
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("compute_groups", [True, False])
def test_forward_batch_values_match_jax(compute_groups):
    jax_coll, torch_coll = _collections(compute_groups)
    for i in range(3):  # the first call forms the groups, the later ones run grouped
        jax_args, torch_args = _batch(i)
        _hold(jax_coll(*jax_args), torch_coll(*torch_args))
    _hold(jax_coll.compute(), torch_coll.compute())


def test_forward_batch_value_is_the_batch_alone():
    _, torch_coll = _collections()
    torch_coll(*_batch(0)[1])
    out = torch_coll(*_batch(1)[1])
    alone = tc.MulticlassF1Score(C, average="macro", device="cpu")
    alone.update(*_batch(1)[1])
    assert torch.equal(out["f1"], alone.compute())


def test_merge_state_with_groups_matches_jax():
    jax_a, torch_a = _collections()
    jax_b, torch_b = _collections()
    for i in range(2):
        jax_a.update(*_batch(i)[0])
        torch_a.update(*_batch(i)[1])
        jax_b.update(*_batch(i + 2)[0])
        torch_b.update(*_batch(i + 2)[1])
    jax_a.merge_state(jax_b)
    torch_a.merge_state(torch_b)
    _hold(jax_a.compute(), torch_a.compute())
    assert all(torch_a[n]._state is torch_a["acc"]._state for n in ("f1", "prec", "rec"))
    assert torch_a["f1"].update_count == 4
    whole = _collections()[1]
    for i in range(4):
        whole.update(*_batch(i)[1])
    for key, value in whole.compute().items():
        assert torch.equal(torch_a.compute()[key], value), key


def test_clone_with_prefix_is_independent_and_keeps_groups():
    jax_coll, torch_coll = _collections()
    jax_coll.update(*_batch(0)[0])
    torch_coll.update(*_batch(0)[1])
    jax_clone, torch_clone = jax_coll.clone(prefix="val_"), torch_coll.clone(prefix="val_")
    assert list(torch_clone.compute()) == list(jax_clone.compute())
    assert torch_clone["f1"]._state is torch_clone["acc"]._state
    assert torch_clone["acc"]._state is not torch_coll["acc"]._state
    torch_clone.update(*_batch(1)[1])
    jax_clone.update(*_batch(1)[0])
    _hold(jax_clone.compute(), torch_clone.compute())
    _hold(jax_coll.compute(), torch_coll.compute())  # the original saw one batch only


def test_state_dict_round_trip_matches_jax():
    jax_coll, torch_coll = _collections()
    for coll in (jax_coll, torch_coll):
        coll.persistent(True)
    for i in range(2):
        jax_coll.update(*_batch(i)[0])
        torch_coll.update(*_batch(i)[1])
    jax_sd, torch_sd = jax_coll.state_dict(), torch_coll.state_dict()
    assert set(jax_sd) == set(torch_sd)
    for key, value in jax_sd.items():
        np.testing.assert_array_equal(np.asarray(torch_sd[key]), np.asarray(value), err_msg=key)
    fresh_jax, fresh_torch = _collections()
    fresh_jax.load_state_dict(jax_sd)
    fresh_torch.load_state_dict(torch_sd)
    _hold(fresh_jax.compute(), fresh_torch.compute())
    for key, value in torch_coll.compute().items():
        assert torch.equal(fresh_torch.compute()[key], value), key


def test_reset_relinks_groups():
    _, torch_coll = _collections()
    torch_coll.update(*_batch(0)[1])
    torch_coll.reset()
    assert torch_coll["f1"]._state is torch_coll["acc"]._state
    torch_coll.update(*_batch(1)[1])
    alone = tc.MulticlassPrecision(C, average="macro", device="cpu")
    alone.update(*_batch(1)[1])
    assert torch.equal(torch_coll["prec"].compute(), alone.compute())


def test_set_dtype_and_to_keep_the_alias():
    _, torch_coll = _collections(names=("acc", "f1"))
    torch_coll.update(*_batch(0)[1])
    torch_coll.set_dtype(torch.float64).to("cpu")
    assert torch_coll["f1"]._state is torch_coll["acc"]._state and torch_coll.device == torch.device("cpu")


class _GatherSpy:
    """A ``dist_sync_fn`` for a world of two equal ranks that records what it ships."""

    def __init__(self):
        self.calls = []

    def __call__(self, value, group=None):
        self.calls.append(value.numel())
        return [value, value]


def test_grouped_sync_gathers_each_shared_state_once_and_keeps_the_alias():
    spies, synced = {}, {}
    for groups in (True, False):
        spy = _GatherSpy()
        _, coll = _collections(groups)
        coll.update(*_batch(0)[1])
        coll.sync(dist_sync_fn=spy, distributed_available=lambda: True)
        spies[groups], synced[groups] = spy, {n: dict(m._state) for n, m in coll.items(keep_base=True)}
        if groups:
            assert all(coll[n]._state is coll["acc"]._state for n in ("f1", "prec", "rec"))
            assert all(coll[n]._cache is coll["acc"]._cache for n in ("f1", "prec", "rec"))
        coll.unsync()
        if groups:
            assert all(coll[n]._state is coll["acc"]._state for n in ("f1", "prec", "rec"))
            coll.update(*_batch(1)[1])
            assert coll["f1"].update_count == 2
    # one metadata gather and one payload gather per dtype, either way; the grouped
    # collection ships the shared tp/fp/tn/fn dict once instead of four times
    assert len(spies[True].calls) == len(spies[False].calls) == 2
    distinct = 4 * C + C * C  # one tp/fp/tn/fn dict and one confusion matrix, int32 each
    assert spies[True].calls[1] == distinct and spies[False].calls[1] == 4 * (4 * C) + C * C
    for name, state in synced[True].items():
        for key, value in state.items():
            assert torch.equal(value, synced[False][name][key]), (name, key)


# --------------------------------------------------------------- on_error


class _JaxPoisonAfter(jtm.Metric):
    def __init__(self, healthy_updates=1, **kw):
        super().__init__(**kw)
        self.add_state("n", default=np.zeros(()), dist_reduce_fx="sum")
        self.healthy_updates = healthy_updates

    def _batch_state(self, preds, target):
        return {"n": jnp.ones(())}

    def _prepare_inputs(self, *args, **kwargs):
        if self._update_count >= self.healthy_updates:
            raise RuntimeError("poisoned member: simulated in-metric failure")
        return args, kwargs

    def _compute(self, state):
        return state["n"]


class _PoisonAfter(Metric):
    def __init__(self, healthy_updates=1, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("n", default=torch.zeros((), dtype=torch.float64), dist_reduce_fx="sum")
        self.healthy_updates = healthy_updates

    def _batch_state(self, preds, target):
        return {"n": torch.ones((), dtype=torch.float64)}

    def _prepare_inputs(self, *args, **kwargs):
        if self._update_count >= self.healthy_updates:
            raise RuntimeError("poisoned member: simulated in-metric failure")
        return args, kwargs

    def _compute(self, state):
        return state["n"]


def _quads(on_error, poison_kw=None, **kw):
    members = {"acc": ("MulticlassAccuracy", {"average": "micro"}), "f1": ("MulticlassF1Score", {"average": "macro"}),
               "conf": ("MulticlassConfusionMatrix", {})}
    jax_coll = JaxCollection(
        {**{n: getattr(jtm, c)(C, **a) for n, (c, a) in members.items()}, "poison": _JaxPoisonAfter(**(poison_kw or {}))},
        on_error=on_error, **kw,
    )
    torch_coll = MetricCollection(
        {**{n: getattr(tc, c)(C, device="cpu", **a) for n, (c, a) in members.items()},
         "poison": _PoisonAfter(**(poison_kw or {}))},
        on_error=on_error, device="cpu", **kw,
    )
    return jax_coll, torch_coll


def _quiet(call):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return call()


def test_quarantine_keeps_three_of_four_computing_as_jax():
    jax_coll, torch_coll = _quads("quarantine")
    for i in range(3):
        jax_args, torch_args = _batch(i)
        _quiet(lambda: jax_coll.update(*jax_args))
        _quiet(lambda: torch_coll.update(*torch_args))
    assert list(torch_coll.quarantined) == list(jax_coll.quarantined) == ["poison"]
    out = torch_coll.compute()
    _hold(jax_coll.compute(), out)
    status = out["poison"]
    assert (status.status, status.stage, status.update_count) == ("quarantined", "update", 1)
    assert "poisoned member" in status.error


def test_forward_surfaces_the_status_as_jax():
    jax_coll, torch_coll = _quads("quarantine")
    for i in range(2):
        jax_args, torch_args = _batch(i)
        _hold(_quiet(lambda: jax_coll.forward(*jax_args)), _quiet(lambda: torch_coll.forward(*torch_args)))


def test_raise_mode_propagates():
    _, torch_coll = _quads("raise")
    torch_coll.update(*_batch(0)[1])
    with pytest.raises(RuntimeError, match="poisoned member"):
        torch_coll.update(*_batch(1)[1])


def test_invalid_mode_rejected():
    with pytest.raises(ValueError, match="on_error"):
        _quads("explode")


def test_quarantined_leader_splits_its_group_as_jax():
    def build(collection, mod, **dev):
        # alphabetical order makes the member that will fail the group's leader
        return collection({"a_poison": mod.MulticlassRecall(C, average="micro", **dev),
                           "recall": mod.MulticlassRecall(C, average="micro", **dev),
                           "conf": mod.MulticlassConfusionMatrix(C, **dev)}, on_error="quarantine", **dev)

    jax_coll, torch_coll = build(JaxCollection, jtm), build(MetricCollection, tc, device="cpu")
    jax_coll.update(*_batch(0)[0])
    torch_coll.update(*_batch(0)[1])
    assert _groups(torch_coll) == _groups(jax_coll) == [["a_poison", "recall"], ["conf"]]

    def fail(*args, **kwargs):
        raise RuntimeError("poisoned member: leader fails after grouping")

    jax_coll["a_poison"]._prepare_inputs = fail
    torch_coll["a_poison"]._prepare_inputs = fail
    _quiet(lambda: jax_coll.update(*_batch(1)[0]))
    _quiet(lambda: torch_coll.update(*_batch(1)[1]))
    assert _groups(torch_coll) == _groups(jax_coll) == [["conf"], ["recall"]]
    _hold(jax_coll.compute(), torch_coll.compute())
    assert torch_coll["a_poison"]._state is not torch_coll["recall"]._state


def test_reset_lifts_quarantine_as_jax():
    jax_coll, torch_coll = _quads("quarantine")
    for coll, args in ((jax_coll, _batch(0)[0]), (torch_coll, _batch(0)[1])):
        _quiet(lambda: coll.update(*args))
        _quiet(lambda: coll.update(*args))
        assert coll.quarantined
        coll.reset()
        assert not coll.quarantined
        coll["poison"].healthy_updates = 99
        coll.update(*args)
    _hold(jax_coll.compute(), torch_coll.compute())


def test_skip_misses_only_the_failing_batch_as_jax():
    jax_coll, torch_coll = _quads("skip", poison_kw={"healthy_updates": 1})
    for coll, pkg in ((jax_coll, 0), (torch_coll, 1)):
        _quiet(lambda: coll.update(*_batch(0)[pkg]))
        _quiet(lambda: coll.update(*_batch(1)[pkg]))
        coll["poison"].healthy_updates = 99
        _quiet(lambda: coll.update(*_batch(2)[pkg]))
        assert not coll.quarantined
        assert coll["poison"].update_count == 2 and coll["acc"].update_count == 3
    _hold(jax_coll.compute(), torch_coll.compute())


def test_skip_with_explicit_groups_keeps_updating():
    _, torch_coll = _quads("skip", poison_kw={"healthy_updates": 1}, compute_groups=[["acc"], ["poison"]])
    _quiet(lambda: torch_coll.update(*_batch(0)[1]))
    _quiet(lambda: torch_coll.update(*_batch(1)[1]))
    torch_coll["poison"].healthy_updates = 99
    _quiet(lambda: torch_coll.update(*_batch(2)[1]))
    assert torch_coll["poison"].update_count == 2 and torch_coll["acc"].update_count == 3


class _JaxBadCompute(_JaxPoisonAfter):
    def _compute(self, state):
        raise RuntimeError("compute blew up")


class _BadCompute(_PoisonAfter):
    def _compute(self, state):
        raise RuntimeError("compute blew up")


@pytest.mark.parametrize("on_error", ["skip", "quarantine"])
def test_compute_failure_gives_a_marker_as_jax(on_error):
    jax_coll = JaxCollection({"acc": jtm.MulticlassAccuracy(C, average="micro"), "bad": _JaxBadCompute(99)},
                             on_error=on_error)
    torch_coll = MetricCollection({"acc": tc.MulticlassAccuracy(C, average="micro", device="cpu"),
                                   "bad": _BadCompute(99)}, on_error=on_error, device="cpu")
    jax_coll.update(*_batch(0)[0])
    torch_coll.update(*_batch(0)[1])
    out = _quiet(torch_coll.compute)
    _hold(_quiet(jax_coll.compute), out)
    assert out["bad"].stage == "compute" and out["bad"].status == ("quarantined" if on_error == "quarantine" else "skipped")
    assert ("bad" in torch_coll.quarantined) == (on_error == "quarantine")


def test_first_batch_failure_does_not_fuse_rolled_back_defaults():
    class FailFirst(_PoisonAfter):
        def _prepare_inputs(self, *args, **kwargs):
            self.calls = getattr(self, "calls", 0) + 1
            if self.calls == 1:
                raise RuntimeError("bad first batch")
            return args, kwargs

    coll = MetricCollection({"a": FailFirst(), "b": FailFirst()}, on_error="skip", device="cpu")
    _quiet(lambda: coll.update(*_batch(0)[1]))
    assert not coll._groups_checked
    _quiet(lambda: coll.update(*_batch(1)[1]))
    assert coll["a"].update_count == 1 and coll["b"].update_count == 1


def test_reset_after_degradation_dealiases_the_group():
    _, torch_coll = _collections(names=("prec", "rec"), on_error="skip")
    torch_coll._modules["poison"] = _PoisonAfter(1)
    ref = tc.MulticlassPrecision(C, average="macro", device="cpu")
    _quiet(lambda: torch_coll.update(*_batch(0)[1]))
    _quiet(lambda: torch_coll.update(*_batch(1)[1]))
    torch_coll.reset()
    _quiet(lambda: torch_coll.update(*_batch(2)[1]))  # ungrouped pass: must not double-count
    ref.update(*_batch(2)[1])
    assert torch.equal(torch_coll["prec"].compute(), ref.compute())


def test_merge_skips_quarantined_and_folds_through_a_healthy_groupmate():
    def pair():
        return MetricCollection({"a_poison": tc.MulticlassRecall(C, average="micro", device="cpu"),
                                 "recall": tc.MulticlassRecall(C, average="micro", device="cpu")},
                                on_error="quarantine", device="cpu")

    def fail(*args, **kwargs):
        raise RuntimeError("poisoned")

    shard_a, shard_b = pair(), pair()
    shard_a.update(*_batch(0)[1])
    shard_b.update(*_batch(1)[1])
    shard_b["a_poison"]._prepare_inputs = fail
    _quiet(lambda: shard_b.update(*_batch(1)[1]))
    shard_a.update(*_batch(0)[1])
    _quiet(lambda: shard_a.merge_state(shard_b))
    ref = tc.MulticlassRecall(C, average="micro", device="cpu")
    for i in (0, 0, 1, 1):
        ref.update(*_batch(i)[1])
    assert torch.equal(shard_a["recall"].compute(), ref.compute())
