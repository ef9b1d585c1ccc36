"""The rest of the port's ``Metric`` core held to the JAX package's, on the CPU.

Mirrors ``tests/test_metric_base.py``'s clone, pickle, ``state_dict``, ``metric_state``,
operator, composition, hash, ``set_dtype`` and ``compute_on_cpu`` cases: the same numpy
inputs go through a JAX metric and its port twin, and the values must agree. Sums of a
few float32 values are exact in both packages, so values are compared exactly unless a
case states a tolerance.
"""

from __future__ import annotations

import copy
import operator
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
from torchmetrics_tpu import Metric as JaxMetric
from torchmetrics_tpu_torch import CatMetric, CompositionalMetric, Metric, MetricCollection
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError


class JaxSum(JaxMetric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("x", default=jnp.zeros(()), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"x": jnp.asarray(x, jnp.float32).sum()}

    def _compute(self, state):
        return state["x"]


class JaxList(JaxMetric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("x", default=[], dist_reduce_fx="cat")

    def _batch_state(self, x):
        return {"x": jnp.atleast_1d(jnp.asarray(x, jnp.float32))}

    def _compute(self, state):
        return state["x"]


class JaxIntSum(JaxMetric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("n", default=jnp.zeros((), jnp.int32), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"n": jnp.asarray(x, jnp.int32).sum()}

    def _compute(self, state):
        return state["n"]


class TorchSum(Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", default=torch.zeros(()), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"x": torch.as_tensor(x, dtype=torch.float32).sum()}

    def _compute(self, state):
        return state["x"]


class TorchList(Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", default=[], dist_reduce_fx="cat")

    def _batch_state(self, x):
        return {"x": torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32))}

    def _compute(self, state):
        return state["x"]


class TorchIntSum(Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("n", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _batch_state(self, x):
        return {"n": torch.as_tensor(x, dtype=torch.int32).sum()}

    def _compute(self, state):
        return state["n"]


TWINS = {"sum": (JaxSum, TorchSum), "list": (JaxList, TorchList), "int": (JaxIntSum, TorchIntSum)}


def _pair(kind):
    """One JAX metric and its port twin."""
    jax_cls, torch_cls = TWINS[kind]
    return jax_cls(), torch_cls()


def _feed(pair, values):
    jax_m, torch_m = pair
    arr = np.asarray(values, np.float32)
    jax_m.update(jnp.asarray(arr))
    torch_m.update(torch.from_numpy(arr))


def _same(jax_value, torch_value):
    np.testing.assert_array_equal(np.asarray(torch_value), np.asarray(jax_value))


def test_clone_is_independent_in_both_packages():
    for pair in (_pair("sum"), _pair("list")):
        _feed(pair, [1.0])
        clones = [m.clone() for m in pair]
        _feed(clones, [2.0])
        _same(pair[0].compute(), pair[1].compute())
        _same(clones[0].compute(), clones[1].compute())
        assert not np.array_equal(np.asarray(pair[1].compute()), np.asarray(clones[1].compute()))


def test_deepcopy_copies_states_and_cache_by_value():
    metric = TorchSum(dist_sync_fn=lambda v, g: [v, v], distributed_available_fn=lambda: True)
    metric.update(torch.tensor([3.0]))
    metric.sync()
    copied = copy.deepcopy(metric)
    assert copied._state["x"] is not metric._state["x"] and copied._cache["x"] is not metric._cache["x"]
    copied.unsync()
    assert float(copied.x) == 3.0 and metric._is_synced


def test_pickle_round_trip_matches_jax():
    pair = _pair("sum")
    _feed(pair, [4.0])
    loaded = [pickle.loads(pickle.dumps(m)) for m in pair]
    _same(loaded[0].compute(), loaded[1].compute())
    _feed(loaded, [1.0])
    _same(loaded[0].compute(), loaded[1].compute())
    assert float(loaded[1].compute()) == 5.0


def test_pickle_drops_callables_and_caches():
    metric = TorchSum(dist_sync_fn=lambda v, g: [v], distributed_available_fn=lambda: False)
    metric.update(torch.tensor([1.0]))
    metric.compute()
    loaded = pickle.loads(pickle.dumps(metric))
    assert loaded.dist_sync_fn is None and loaded._computed is None and loaded._cache is None
    assert loaded.distributed_available_fn is not metric.distributed_available_fn


def test_state_dict_persistence_matches_jax():
    pair = _pair("sum")
    assert pair[0].state_dict() == {} and pair[1].state_dict() == {}
    for m in pair:
        m.persistent(True)
    _feed(pair, [2.0])
    sds = [m.state_dict() for m in pair]
    assert sds[0].keys() == sds[1].keys()
    fresh = _pair("sum")
    for m, sd in zip(fresh, sds):
        m.persistent(True)
        m.load_state_dict(sd)
    _same(fresh[0].compute(), fresh[1].compute())


def test_metric_state_and_counters_match_jax():
    pair = _pair("list")
    assert [m.update_called for m in pair] == [False, False]
    _feed(pair, [2.0, 3.0])
    _feed(pair, [4.0])
    assert [m.update_count for m in pair] == [2, 2] and [m.update_called for m in pair] == [True, True]
    jax_state, torch_state = (m.metric_state for m in pair)
    assert len(jax_state["x"]) == len(torch_state["x"]) == 2
    for a, b in zip(jax_state["x"], torch_state["x"]):
        _same(a, b)
    torch_state["x"].append(torch.zeros(1))  # a copy of the containers
    assert len(pair[1]._state["x"]) == 2


BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul, "truediv": operator.truediv,
    "floordiv": operator.floordiv, "mod": operator.mod, "pow": operator.pow, "eq": operator.eq,
    "ne": operator.ne, "lt": operator.lt, "le": operator.le, "gt": operator.gt, "ge": operator.ge,
}


@pytest.mark.parametrize("name", sorted(BINARY))
@pytest.mark.parametrize("operands", ["metric_metric", "metric_const", "const_metric"])
def test_binary_operator_matches_jax(name, operands):
    op = BINARY[name]
    a, b = _pair("sum"), _pair("sum")
    _feed(a, [2.5, 4.0])
    _feed(b, [1.5])
    values = []
    for i in range(2):
        if operands == "metric_metric":
            comp = op(a[i], b[i])
        elif operands == "metric_const":
            comp = op(a[i], 2.0)
        else:
            comp = op(3.0, a[i])
        values.append(np.asarray(comp.compute()))
    np.testing.assert_allclose(values[1], values[0], rtol=1e-6)  # one float32 op: ulp-level
    assert values[1].dtype == values[0].dtype


@pytest.mark.parametrize("name", ["and", "or", "xor"])
def test_bitwise_operators_match_jax(name):
    op = {"and": operator.and_, "or": operator.or_, "xor": operator.xor}[name]
    a, b = _pair("int"), _pair("int")
    _feed(a, [6, 7])
    _feed(b, [5])
    for comp_j, comp_t in ((op(a[0], b[0]), op(a[1], b[1])), (op(a[0], 3), op(a[1], 3)), (op(9, a[0]), op(9, a[1]))):
        _same(comp_j.compute(), comp_t.compute())


@pytest.mark.parametrize("name", ["neg", "abs", "pos", "invert"])
def test_unary_operators_match_jax(name):
    op = {"neg": operator.neg, "abs": abs, "pos": operator.pos, "invert": operator.invert}[name]
    pair = _pair("int" if name == "invert" else "sum")
    _feed(pair, [-2.0, -1.5] if name != "invert" else [5, 8])
    _same(op(pair[0]).compute(), op(pair[1]).compute())


def test_getitem_and_matmul_match_jax():
    a, b = _pair("list"), _pair("list")
    _feed(a, [5.0, 7.0, 1.0])
    _feed(b, [2.0, -1.0, 3.0])
    _same(a[0][1].compute(), a[1][1].compute())
    _same((a[0] @ b[0]).compute(), (a[1] @ b[1]).compute())


def test_composition_forward_update_and_reset_match_jax():
    pairs = [_pair("sum"), _pair("sum")]
    comps = [pairs[0][i] + pairs[1][i] for i in range(2)]
    assert isinstance(comps[1], CompositionalMetric)
    values = [comps[0](jnp.asarray([2.0])), comps[1](torch.tensor([2.0]))]
    _same(values[0], values[1])
    assert float(values[1]) == 4.0
    comps[0].update(jnp.asarray([1.0]))
    comps[1].update(torch.tensor([1.0]))
    _same(comps[0].compute(), comps[1].compute())
    assert float(comps[1].compute()) == 6.0
    comps[1].reset()
    assert pairs[0][1].update_count == 0 and pairs[1][1].update_count == 0
    comps[1].persistent(True)
    assert pairs[0][1]._persistent["x"]


def test_classification_metrics_compose():
    """``MulticlassAccuracy(3) + MulticlassAccuracy(3)`` composes, and the mean of
    two metrics equals the mean of their values."""
    rng = np.random.default_rng(0)
    preds, target = rng.normal(size=(32, 3)).astype(np.float32), rng.integers(0, 3, 32)
    jax_acc, jax_f1 = jtm.MulticlassAccuracy(3), jtm.MulticlassF1Score(3)
    acc, f1 = MulticlassAccuracy(3, device="cpu"), MulticlassF1Score(3, device="cpu")
    jax_mean, mean = (jax_acc + jax_f1) / 2, (acc + f1) / 2
    jax_mean.update(jnp.asarray(preds), jnp.asarray(target))
    mean.update(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_allclose(np.asarray(mean.compute()), np.asarray(jax_mean.compute()), atol=1e-7)
    assert float(mean.compute()) == pytest.approx((float(acc.compute()) + float(f1.compute())) / 2, abs=1e-7)
    summed = MulticlassAccuracy(3, device="cpu") + MulticlassAccuracy(3, device="cpu")
    summed.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert float(summed.compute()) == pytest.approx(2 * float(acc.compute()), abs=1e-7)


def test_hash_follows_state_ids():
    pair = _pair("sum")
    before = [hash(m) for m in pair]
    _feed(pair, [1.0])
    assert [hash(m) for m in pair] != before
    twin = TorchSum()
    twin._state = pair[1]._state  # aliased states hash alike, as compute-group members do
    assert hash(twin) == hash(pair[1])


def test_eq_builds_a_composition_so_collections_compare_by_identity():
    """``==`` between metrics builds a truthy ``CompositionalMetric``; the collection must
    keep members apart by identity all the same."""
    acc, f1 = MulticlassAccuracy(3, device="cpu"), MulticlassF1Score(3, device="cpu")
    assert isinstance(acc == f1, CompositionalMetric)
    coll = MetricCollection({"acc": acc, "f1": f1}, device="cpu")
    coll.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    assert coll["acc"] is acc and coll["f1"] is f1
    assert {k: float(v) for k, v in coll.compute().items()} == {"acc": float(acc.compute()), "f1": float(f1.compute())}


def test_set_dtype_bfloat16_matches_jax():
    pair = _pair("sum")
    pair[0].set_dtype(jnp.bfloat16)
    pair[1].set_dtype(torch.bfloat16)
    _feed(pair, [1.0, 0.1])
    assert pair[1].compute().dtype == torch.bfloat16 and pair[1].dtype == torch.bfloat16
    assert float(pair[1].compute()) == float(pair[0].compute())
    ints = TorchIntSum().set_dtype(torch.bfloat16)
    assert ints.n.dtype == torch.int32 and ints._defaults["n"].dtype == torch.int32


def test_compute_on_cpu_appends_on_the_host_and_matches_jax():
    jax_cat, cat = jtm.CatMetric(compute_on_cpu=True), CatMetric(compute_on_cpu=True, device="cpu")
    for values in ([1.0, 2.0], [3.0]):
        jax_cat.update(jnp.asarray(values))
        cat.update(torch.tensor(values))
    assert cat.compute_on_cpu and all(t.device.type == "cpu" for t in cat._state["value"])
    _same(jax_cat.compute(), cat.compute())


def test_unknown_keyword_still_raises():
    with pytest.raises(ValueError, match="Unexpected keyword arguments"):
        TorchSum(bogus=1)
    with pytest.raises(TorchMetricsUserError):
        TorchList().update_state({"x": []}, torch.tensor([1.0]))


def _aggregators(pkg, **kw):
    return pkg.MeanMetric(**kw), pkg.SumMetric(**kw), pkg.MaxMetric(**kw)


def _collection_values(coll):
    return {k: float(np.asarray(v)) for k, v in coll.compute().items()}


@pytest.mark.parametrize("layout", ["mapping", "sequence"])
def test_nested_collection_flattens_as_in_jax(layout):
    import torchmetrics_tpu_torch as ptm

    def build(pkg, **kw):
        mean, total, top = _aggregators(pkg, **kw)
        inner = pkg.MetricCollection([mean, total], **kw)
        if layout == "mapping":
            return pkg.MetricCollection({"outer": inner, "m": top}, **kw)
        return pkg.MetricCollection([inner, top], **kw)

    jax_c, torch_c = build(jtm), build(ptm, device="cpu")
    assert list(torch_c.keys()) == list(jax_c.keys())
    if layout == "mapping":
        assert list(torch_c.keys()) == ["m", "outer_MeanMetric", "outer_SumMetric"]
    for values in ([1.0, 4.0, 2.5], [-3.0, 0.5]):
        arr = np.asarray(values, np.float32)
        jax_c.update(jnp.asarray(arr))
        torch_c.update(torch.from_numpy(arr))
    assert _collection_values(torch_c) == _collection_values(jax_c)


def test_nested_sequence_duplicate_name_raises_in_both_packages():
    import torchmetrics_tpu_torch as ptm

    for pkg, kw in ((jtm, {}), (ptm, {"device": "cpu"})):
        inner = pkg.MetricCollection([pkg.SumMetric(**kw)], **kw)
        with pytest.raises(ValueError, match="Encountered two metrics both named SumMetric"):
            pkg.MetricCollection([inner, pkg.SumMetric(**kw)], **kw)


def test_readding_a_mapping_key_replaces_the_member_as_in_jax():
    import torchmetrics_tpu_torch as ptm

    colls = []
    for pkg, kw in ((jtm, {}), (ptm, {"device": "cpu"})):
        coll = pkg.MetricCollection({"a": pkg.MeanMetric(**kw), "b": pkg.MaxMetric(**kw)}, **kw)
        replacement = pkg.SumMetric(**kw)
        coll.add_metrics({"a": replacement})
        assert coll["a"] is replacement and list(coll.keys()) == ["a", "b"]
        colls.append(coll)
    for values in ([1.0, 2.0], [5.0]):
        arr = np.asarray(values, np.float32)
        colls[0].update(jnp.asarray(arr))
        colls[1].update(torch.from_numpy(arr))
    assert _collection_values(colls[1]) == _collection_values(colls[0]) == {"a": 8.0, "b": 5.0}


def test_extra_arguments_that_are_not_metrics_warn_as_in_jax():
    import torchmetrics_tpu_torch as ptm

    text = "You have passes extra arguments ['junk'] which are not `Metric` so they will be ignored."
    for pkg, kw in ((jtm, {}), (ptm, {"device": "cpu"})):
        with pytest.warns(UserWarning) as record:
            coll = pkg.MetricCollection([pkg.MeanMetric(**kw)], pkg.SumMetric(**kw), "junk", **kw)
        assert text in [str(w.message) for w in record]
        assert list(coll.keys()) == ["MeanMetric", "SumMetric"]
