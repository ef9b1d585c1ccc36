"""The port's fused classification step and multiclass metrics against the JAX package,
on the CPU.

The main case is ``__graft_entry__.entry()``: ``MetricCollection({acc, f1, confmat})
.as_pure().apply`` on entry()'s own inputs. Counts (tp/fp/tn/fn, the confusion matrix)
must match bit for bit. Accuracy, F1 and averaged stat scores are float32 ratios or
means of the same counts, computed in another order: they must agree within 1e-6
absolute or 1e-6 relative (a few float32 ulps at the values' scale).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from torchmetrics_tpu import classification as jax_cls
from torchmetrics_tpu_torch import Metric, MetricCollection
from torchmetrics_tpu_torch.classification import (
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MulticlassStatScores,
)

VALUE_ATOL = 1e-6
VALUE_RTOL = 1e-6
NUM_CLASSES = 5


def _entry_collection(device="cpu"):
    return MetricCollection({
        "acc": MulticlassAccuracy(NUM_CLASSES, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(NUM_CLASSES, average="macro", validate_args=False, device=device),
        "confmat": MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, device=device),
    }, device=device)


def _assert_counts_equal(got: torch.Tensor, want) -> None:
    """Counts equal bit for bit, in the reference's dtype (int32, or float32 where the
    JAX package sums weights)."""
    want = np.asarray(want)
    assert np.array_equal(want, np.round(want)), "reference counts must be integral"
    assert got.dtype == torch.from_numpy(np.zeros(0, want.dtype)).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_pure_apply_matches_jax():
    fn, (states, preds, target) = graft.entry()
    jax_states, jax_values = fn(states, preds, target)
    pure = _entry_collection().as_pure()
    states_t, values = pure.apply(pure.init(), torch.from_numpy(np.array(preds)), torch.from_numpy(np.array(target)))
    assert set(values) == set(jax_values) == {"acc", "f1", "confmat"}
    _assert_counts_equal(values["confmat"], jax_values["confmat"])
    for name in ("acc", "f1"):
        assert values[name].dtype == torch.float32 and values[name].shape == ()
        np.testing.assert_allclose(float(values[name]), float(jax_values[name]), atol=VALUE_ATOL, rtol=VALUE_RTOL)
        for leaf in ("tp", "fp", "tn", "fn"):
            _assert_counts_equal(states_t[name][leaf], jax_states[name][leaf])
    _assert_counts_equal(states_t["confmat"]["confmat"], jax_states["confmat"]["confmat"])


def test_entry_pure_apply_confmat_is_float32_like_jax():
    """The pure path folds the int32 default state with the float32 weighted counts, so
    the ``confmat`` state and value are float32 after one ``apply`` in both packages."""
    fn, (states, preds, target) = graft.entry()
    jax_states, jax_values = fn(states, preds, target)
    pure = _entry_collection().as_pure()
    init = pure.init()
    assert init["confmat"]["confmat"].dtype == torch.int32
    states_t, values = pure.apply(init, torch.from_numpy(np.array(preds)), torch.from_numpy(np.array(target)))
    assert np.asarray(jax_states["confmat"]["confmat"]).dtype == np.float32
    assert np.asarray(jax_values["confmat"]).dtype == np.float32
    assert states_t["confmat"]["confmat"].dtype == values["confmat"].dtype == torch.float32
    _assert_counts_equal(values["confmat"], jax_values["confmat"])


BINCOUNT_CASES = {
    # name: (x, y, weights or None), nx = 2, ny = 3; -1, 2 (for x) and 3 (for y) are out of range
    "unweighted": ([0, 1, 1, 0, 1], [0, 2, 2, 1, 0], None),
    "unweighted-out-of-range": ([0, -1, 1, 2, 1], [0, 1, 3, 0, 2], None),
    "weight-two": ([0, 1, 1], [0, 1, 1], [1, 2, 2]),
    "weights-with-out-of-range": ([0, 1, 2, 1, -1, 0], [0, 1, 0, 3, 2, 2], [1, 2, 5, 7, 3, 0]),
    "fractional-weights": ([0, 0, 1, 1], [2, 2, 0, 1], [0.5, 0.25, 1.5, 3.0]),
}


@pytest.mark.parametrize("case", sorted(BINCOUNT_CASES))
def test_bincount_2d_matches_jax(case):
    from torchmetrics_tpu.utilities.data import _bincount_2d as jax_bincount_2d
    from torchmetrics_tpu_torch.utilities.data import _bincount_2d

    x, y, weights = (None if v is None else np.asarray(v) for v in BINCOUNT_CASES[case])
    want = np.asarray(jax_bincount_2d(jnp.asarray(x), jnp.asarray(y), 2, 3,
                                      None if weights is None else jnp.asarray(weights)))
    got = _bincount_2d(torch.from_numpy(x), torch.from_numpy(y), 2, 3,
                       None if weights is None else torch.from_numpy(weights))
    assert want.dtype == (np.int32 if weights is None else np.float32)
    assert got.dtype == torch.from_numpy(np.zeros(0, want.dtype)).dtype and tuple(got.shape) == want.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stateful_confusion_matrix_stays_int32_like_jax():
    """The stateful class casts each float32 batch count back to its int32 state; the
    batch value that ``forward`` returns is the float32 count, in both packages."""
    rng = np.random.default_rng(7)
    jax_metric = jax_cls.MulticlassConfusionMatrix(NUM_CLASSES, ignore_index=2)
    metric = MulticlassConfusionMatrix(NUM_CLASSES, ignore_index=2, device="cpu")
    for n in (31, 12):
        preds = rng.normal(size=(n, NUM_CLASSES)).astype(np.float32)
        target = rng.integers(0, NUM_CLASSES, n).astype(np.int64)
        _assert_counts_equal(metric(torch.from_numpy(preds), torch.from_numpy(target)),
                             jax_metric(jnp.asarray(preds), jnp.asarray(target)))
    assert metric.confmat.dtype == torch.int32
    _assert_counts_equal(metric.compute(), jax_metric.compute())
    assert metric.compute().dtype == torch.int32


def test_entry_pure_apply_folds_a_second_batch():
    fn, (states, preds, target) = graft.entry()
    rng = np.random.default_rng(1)
    preds2 = rng.normal(size=(48, NUM_CLASSES)).astype(np.float32)
    target2 = rng.integers(0, NUM_CLASSES, 48).astype(np.int32)
    jax_states, _ = fn(states, preds, target)
    _, jax_values = fn(jax_states, jnp.asarray(preds2), jnp.asarray(target2))
    pure = _entry_collection().as_pure()
    states_t, _ = pure.apply(pure.init(), torch.from_numpy(np.array(preds)), torch.from_numpy(np.array(target)))
    _, values = pure.apply(states_t, torch.from_numpy(preds2), torch.from_numpy(target2))
    _assert_counts_equal(values["confmat"], jax_values["confmat"])
    for name in ("acc", "f1"):
        np.testing.assert_allclose(float(values[name]), float(jax_values[name]), atol=VALUE_ATOL, rtol=VALUE_RTOL)


CASES = [
    # (jax class, torch class, kwargs)
    ("MulticlassAccuracy", MulticlassAccuracy, {"average": "macro", "ignore_index": 0}),
    ("MulticlassAccuracy", MulticlassAccuracy, {"average": "micro", "ignore_index": -1}),
    ("MulticlassAccuracy", MulticlassAccuracy, {"average": "weighted", "top_k": 2}),
    ("MulticlassAccuracy", MulticlassAccuracy, {"average": "none", "top_k": 3, "ignore_index": 4}),
    ("MulticlassF1Score", MulticlassF1Score, {"average": "macro", "top_k": 2, "ignore_index": 1}),
    ("MulticlassF1Score", MulticlassF1Score, {"average": "weighted"}),
    ("MulticlassF1Score", MulticlassF1Score, {"average": "none", "zero_division": 1}),
    ("MulticlassFBetaScore", MulticlassFBetaScore, {"beta": 2.0, "average": "micro"}),
    ("MulticlassStatScores", MulticlassStatScores, {"average": "macro"}),
    ("MulticlassStatScores", MulticlassStatScores, {"average": "none", "ignore_index": 2}),
    ("MulticlassStatScores", MulticlassStatScores, {"average": "micro", "multidim_average": "samplewise"}),
    ("MulticlassConfusionMatrix", MulticlassConfusionMatrix, {"ignore_index": 3}),
    ("MulticlassConfusionMatrix", MulticlassConfusionMatrix, {"normalize": "true"}),
    ("MulticlassConfusionMatrix", MulticlassConfusionMatrix, {"normalize": "all", "ignore_index": -1}),
]


def _batches(seed, samplewise):
    rng = np.random.default_rng(seed)
    out = []
    for n in (24, 17):
        shape = (n, NUM_CLASSES, 3) if samplewise else (n, NUM_CLASSES)
        preds = rng.normal(size=shape).astype(np.float32)
        target = rng.integers(-1, NUM_CLASSES, (n, 3) if samplewise else n).astype(np.int64)
        out.append((preds, target))
    return out


@pytest.mark.parametrize("case", range(len(CASES)), ids=lambda i: f"{CASES[i][0]}-{CASES[i][2]}")
def test_stateful_metric_matches_jax(case):
    jax_name, torch_cls, kwargs = CASES[case]
    samplewise = kwargs.get("multidim_average") == "samplewise"
    # labels of -1 only where ignore_index=-1 asks for them, else remap them to class 0
    ignore = kwargs.get("ignore_index")
    jax_metric = getattr(jax_cls, jax_name)(num_classes=NUM_CLASSES, **kwargs)
    metric = torch_cls(num_classes=NUM_CLASSES, device="cpu", **kwargs)
    for preds, target in _batches(case, samplewise):
        target = target if ignore == -1 else np.where(target < 0, 0, target)
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    want = np.asarray(jax_metric.compute())
    got = metric.compute()
    assert tuple(got.shape) == want.shape
    if np.issubdtype(want.dtype, np.integer):
        _assert_counts_equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=VALUE_ATOL, rtol=VALUE_RTOL)


def test_forward_returns_the_batch_value_and_accumulates():
    metric = MulticlassAccuracy(NUM_CLASSES, average="micro", device="cpu")
    jax_metric = jax_cls.MulticlassAccuracy(NUM_CLASSES, average="micro")
    for preds, target in _batches(3, False):
        target = np.where(target < 0, 0, target)
        batch_value = metric(torch.from_numpy(preds), torch.from_numpy(target))
        jax_batch_value = jax_metric(jnp.asarray(preds), jnp.asarray(target))
        np.testing.assert_allclose(float(batch_value), float(jax_batch_value), atol=VALUE_ATOL, rtol=VALUE_RTOL)
    np.testing.assert_allclose(float(metric.compute()), float(jax_metric.compute()), atol=VALUE_ATOL, rtol=VALUE_RTOL)


def test_label_preds_take_the_one_hot_path():
    rng = np.random.default_rng(4)
    preds = rng.integers(0, NUM_CLASSES, 40)
    target = rng.integers(0, NUM_CLASSES, 40)
    for jax_metric, metric in (
        (jax_cls.MulticlassStatScores(NUM_CLASSES, average="none"), MulticlassStatScores(NUM_CLASSES, average="none", device="cpu")),
        (jax_cls.MulticlassConfusionMatrix(NUM_CLASSES), MulticlassConfusionMatrix(NUM_CLASSES, device="cpu")),
    ):
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        _assert_counts_equal(metric.compute(), jax_metric.compute())


def test_tensor_validation_rejects_out_of_range_labels():
    metric = MulticlassAccuracy(NUM_CLASSES, device="cpu")
    with pytest.raises(RuntimeError, match="unique values"):
        metric.update(torch.randn(4, NUM_CLASSES), torch.tensor([0, 1, 2, NUM_CLASSES]))
    with pytest.raises(ValueError, match="number of classes"):
        metric.update(torch.randn(4, NUM_CLASSES + 1), torch.tensor([0, 1, 2, 3]))


def test_collection_stateful_path_prefix_and_reset():
    collection = MetricCollection(
        [MulticlassAccuracy(NUM_CLASSES, device="cpu"), MulticlassConfusionMatrix(NUM_CLASSES, device="cpu")],
        prefix="val_", device="cpu",
    )
    preds, target = _batches(5, False)[0]
    target = np.where(target < 0, 0, target)
    collection.update(torch.from_numpy(preds), torch.from_numpy(target))
    values = collection.compute()
    assert set(values) == {"val_MulticlassAccuracy", "val_MulticlassConfusionMatrix"}
    assert int(values["val_MulticlassConfusionMatrix"].sum()) == len(target)
    collection.reset()
    assert int(collection["MulticlassConfusionMatrix"].confmat.sum()) == 0


class _SumAndMean(Metric):
    """A minimal metric over the port's core: a sum state, a count-weighted mean state
    and a concat state."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum", persistent=True)
        self.add_state("avg", torch.zeros(()), dist_reduce_fx="mean", persistent=True)
        self.add_state("seen", [], dist_reduce_fx="cat")

    def _batch_state(self, x):
        return {"total": x.sum(), "avg": x.mean(), "seen": x}

    def _compute(self, state):
        return state["total"], state["avg"], state["seen"]


def test_metric_core_folds_sum_mean_and_cat_states():
    metric = _SumAndMean(device="cpu")
    batches = [torch.tensor([1.0, 2.0]), torch.tensor([3.0]), torch.tensor([4.0, 5.0, 6.0])]
    for x in batches:
        metric.update(x)
    total, avg, seen = metric.compute()
    assert float(total) == 21.0
    assert abs(float(avg) - np.mean([1.5, 3.0, 5.0])) < 1e-6  # exact running mean over updates
    torch.testing.assert_close(seen, torch.cat(batches))
    with pytest.raises(Exception, match="concat states"):
        metric.update_state(metric.init_state(), batches[0])


def test_metric_core_state_dict_round_trip():
    metric = _SumAndMean(device="cpu")
    metric.update(torch.tensor([2.0, 4.0]))
    saved = metric.state_dict()
    assert saved["_update_count"] == 1 and saved["_saved_states"] == 2
    fresh = _SumAndMean(device="cpu")
    fresh.load_state_dict(saved)
    assert fresh._update_count == 1
    assert float(fresh.total) == 6.0 and float(fresh.avg) == 3.0
    metric.reset()
    assert float(metric.total) == 0.0 and metric._update_count == 0
    with pytest.raises(ValueError, match="Unexpected keyword"):
        _SumAndMean(device="cpu", jit=False)
