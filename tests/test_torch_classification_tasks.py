"""The port's binary, multiclass and multilabel stat-score family, its task facades and
its task-dispatch functions against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function or class and the
port's counterpart. Counts (tp/fp/tn/fn, stat scores without a float average, confusion
matrices) must be equal bit for bit, in the JAX package's dtype. Float results (ratios,
macro and weighted averages) are the same counts reduced in another order: they must
agree within 1e-6 absolute or 1e-6 relative, the tolerance of
``tests/test_torch_classification.py``, and have the JAX package's dtype too.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tmt
from torchmetrics_tpu import MetricCollection as JaxMetricCollection
from torchmetrics_tpu import classification as jax_cls
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu.utilities.compute import normalize_logits_if_needed as jax_normalize
from torchmetrics_tpu.utilities.data import select_topk as jax_select_topk
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch import classification as port_cls
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import select_topk

VALUE_ATOL = 1e-6
VALUE_RTOL = 1e-6
N, C, S = 16, 4, 3


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _assert_matches(got: torch.Tensor, want, exact: bool = False) -> None:
    """Same shape and the JAX dtype; integer (or ``exact``) values equal bit for bit,
    float values within the stated tolerance."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert got.dtype == _torch_dtype(want.dtype)
    if exact or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=VALUE_ATOL, rtol=VALUE_RTOL)


def _data(task: str, kind: str, samplewise: bool, ignore_index, absent: bool, seed: int, n: int = N):
    """(preds, target) as numpy arrays. ``kind``: float ``logits`` (sigmoid needed),
    ``probs`` (in [0, 1]), int ``labels``, or ``ties`` (multiclass scores in quarters).
    ``absent``: a class or label with no support, so ``zero_division`` matters."""
    rng = np.random.default_rng(seed)
    extra = (S,) if samplewise else ()
    if task == "multiclass":
        target = rng.integers(0, C - 1 if absent else C, (n, *extra))
        if kind == "labels":
            preds = rng.integers(0, C, (n, *extra))
        elif kind == "ties":
            preds = (rng.integers(0, 5, (n, C, *extra)) / 4).astype(np.float32)
        else:
            preds = rng.normal(size=(n, C, *extra)).astype(np.float32)
    else:
        shape = (n, *extra) if task == "binary" else (n, C, *extra)
        target = rng.integers(0, 2, shape)
        if absent:  # binary: the first sample has no positive; multilabel: label 0 has none
            target[0 if task == "binary" else (slice(None), 0)] = 0
        if kind == "labels":
            preds = rng.integers(0, 2, shape)
        elif kind == "probs":
            preds = rng.uniform(size=shape).astype(np.float32)
        else:
            preds = (2 * rng.normal(size=shape)).astype(np.float32)
    if ignore_index is not None:
        target = np.where(rng.uniform(size=target.shape) < 0.2, ignore_index, target)
    return preds, target.astype(np.int64)


# (task, preds kind, average, multidim_average, ignore_index, zero_division, top_k, absent)
CASES = {
    "b-logits": ("binary", "logits", None, "global", None, 0, 1, False),
    "b-probs-sw-ign-1": ("binary", "probs", None, "samplewise", -1, 1, 1, True),
    "b-labels-ign255": ("binary", "labels", None, "global", 255, 1, 1, False),
    "b-logits-sw": ("binary", "logits", None, "samplewise", None, 0, 1, True),
    "mc-micro": ("multiclass", "logits", "micro", "global", None, 0, 1, False),
    "mc-macro-sw-ign-1": ("multiclass", "logits", "macro", "samplewise", -1, 1, 1, True),
    "mc-labels-weighted-ign0": ("multiclass", "labels", "weighted", "global", 0, 0, 1, False),
    "mc-ties-none-top2": ("multiclass", "ties", "none", "global", None, 1, 2, True),
    "mc-ties-macro-top3-ign2": ("multiclass", "ties", "macro", "global", 2, 0, 3, False),
    "mc-weighted-sw": ("multiclass", "logits", "weighted", "samplewise", None, 1, 1, False),
    "mc-labels-none-sw-ign-1": ("multiclass", "labels", "none", "samplewise", -1, 0, 1, True),
    "ml-micro": ("multilabel", "logits", "micro", "global", None, 0, 1, False),
    "ml-probs-macro-sw-ign-1": ("multilabel", "probs", "macro", "samplewise", -1, 1, 1, True),
    "ml-labels-weighted-ign255": ("multilabel", "labels", "weighted", "global", 255, 0, 1, False),
    "ml-none-sw": ("multilabel", "logits", "none", "samplewise", None, 1, 1, True),
    "ml-probs-weighted-sw": ("multilabel", "probs", "weighted", "samplewise", None, 0, 1, False),
    "ml-macro-ign-1": ("multilabel", "logits", "macro", "global", -1, 1, 1, True),
}
CLASS_CASES = ["b-probs-sw-ign-1", "b-labels-ign255", "mc-macro-sw-ign-1", "mc-ties-none-top2",
               "ml-probs-macro-sw-ign-1", "ml-labels-weighted-ign255"]

# family: (functional stem, class stem, takes zero_division, extra arguments)
FAMILIES = {
    "stat_scores": ("stat_scores", "StatScores", False, {}),
    "accuracy": ("accuracy", "Accuracy", False, {}),
    "precision": ("precision", "Precision", True, {}),
    "recall": ("recall", "Recall", True, {}),
    "fbeta": ("fbeta_score", "FBetaScore", True, {"beta": 2.0}),
    "f1": ("f1_score", "F1Score", True, {}),
    "specificity": ("specificity", "Specificity", True, {}),
    "npv": ("negative_predictive_value", "NegativePredictiveValue", True, {}),
    "hamming": ("hamming_distance", "HammingDistance", True, {}),
}


def _task_kwargs(case: str, zero_division: bool) -> dict:
    task, _, average, mda, ignore_index, zd, top_k, _ = CASES[case]
    kwargs = {"multidim_average": mda, "ignore_index": ignore_index}
    if task == "multiclass":
        kwargs.update(num_classes=C, average=average, top_k=top_k)
    elif task == "multilabel":
        kwargs.update(num_labels=C, average=average)
    if zero_division:
        kwargs["zero_division"] = zd
    return kwargs


def _case_data(case: str, seed: int, n: int = N):
    task, kind, _, mda, ignore_index, _, _, absent = CASES[case]
    return _data(task, kind, mda == "samplewise", ignore_index, absent, seed, n)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_functional_entry_matches_jax(family, case):
    """Each ``binary_*``/``multiclass_*``/``multilabel_*`` function, and the task
    dispatch over it, against the JAX package's."""
    stem, _, takes_zd, extra = FAMILIES[family]
    task = CASES[case][0]
    kwargs = {**extra, **_task_kwargs(case, takes_zd)}
    preds, target = _case_data(case, seed=len(case))
    name = f"{task}_{stem}"
    want = getattr(jax_fn, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(port_fn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    _assert_matches(got, want)
    dispatched = getattr(port_fn, stem)(torch.from_numpy(preds), torch.from_numpy(target), task=task, **kwargs)
    _assert_matches(dispatched, want)


@pytest.mark.parametrize("case", CLASS_CASES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stateful_class_matches_jax(family, case):
    """Each Binary/Multiclass/Multilabel class over two batches: ``forward`` on the
    first (the batch value), ``update`` on the second, then ``compute``."""
    _, stem, takes_zd, extra = FAMILIES[family]
    task = CASES[case][0]
    kwargs = {**extra, **_task_kwargs(case, takes_zd)}
    name = f"{task.capitalize()}{stem}"
    jax_metric = getattr(jax_cls, name)(**kwargs)
    metric = getattr(port_cls, name)(device="cpu", **kwargs)
    (p1, t1), (p2, t2) = _case_data(case, seed=1), _case_data(case, seed=2, n=9)
    _assert_matches(metric(torch.from_numpy(p1), torch.from_numpy(t1)), jax_metric(jnp.asarray(p1), jnp.asarray(t1)))
    jax_metric.update(jnp.asarray(p2), jnp.asarray(t2))
    metric.update(torch.from_numpy(p2), torch.from_numpy(t2))
    _assert_matches(metric.compute(), jax_metric.compute())
    if CASES[case][3] == "global":
        for leaf in ("tp", "fp", "tn", "fn"):
            assert getattr(metric, leaf).dtype == torch.int32


# (task, preds kind, normalize, ignore_index, extra trailing axis)
CONFMAT_CASES = {
    "b-logits": ("binary", "logits", None, None, False),
    "b-probs-true-ign-1": ("binary", "probs", "true", -1, True),
    "b-labels-all-ign255": ("binary", "labels", "all", 255, False),
    "mc-ign0": ("multiclass", "logits", None, 0, True),
    "mc-labels-pred-ign-1": ("multiclass", "labels", "pred", -1, False),
    "ml-logits": ("multilabel", "logits", None, None, False),
    "ml-probs-true-ign-1": ("multilabel", "probs", "true", -1, False),
    "ml-labels-extra-axis-ign255": ("multilabel", "labels", None, 255, True),
}


def _confmat_args(case: str, seed: int, n: int = N):
    task, kind, normalize, ignore_index, extra_axis = CONFMAT_CASES[case]
    preds, target = _data(task, kind, extra_axis, ignore_index, False, seed, n)
    kwargs = {"normalize": normalize, "ignore_index": ignore_index}
    if task == "multiclass":
        kwargs["num_classes"] = C
    elif task == "multilabel":
        kwargs["num_labels"] = C
    return task, preds, target, kwargs


@pytest.mark.parametrize("case", sorted(CONFMAT_CASES))
def test_confusion_matrix_matches_jax(case):
    """Functional (float32 for binary and multiclass, int32 for multilabel) and the task
    dispatch, then the class over two batches (int32 state), all as in the JAX package."""
    task, preds, target, kwargs = _confmat_args(case, seed=3)
    name = f"{task}_confusion_matrix"
    want = getattr(jax_fn, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    exact = kwargs["normalize"] is None
    _assert_matches(getattr(port_fn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs), want, exact)
    _assert_matches(port_fn.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target), task=task, **kwargs),
                    want, exact)
    cls_name = f"{task.capitalize()}ConfusionMatrix"
    jax_metric = getattr(jax_cls, cls_name)(**kwargs)
    metric = getattr(port_cls, cls_name)(device="cpu", **kwargs)
    for seed, n in ((4, N), (5, 9)):
        _, p, t, _ = _confmat_args(case, seed, n)
        _assert_matches(metric(torch.from_numpy(p), torch.from_numpy(t)), jax_metric(jnp.asarray(p), jnp.asarray(t)),
                        exact)
    assert metric.confmat.dtype == torch.int32
    _assert_matches(metric.compute(), jax_metric.compute(), exact)


def test_confusion_matrix_dtypes_and_shapes():
    """Functional binary is float32 (a weighted bincount), the stateful class int32;
    multilabel is (C, 2, 2) laid out [[tn, fp], [fn, tp]], int32 on both paths."""
    preds = torch.tensor([0.9, 0.1, 0.8, 0.3, 0.7])
    target = torch.tensor([1, 0, 0, 1, 1])
    functional = port_fn.binary_confusion_matrix(preds, target)
    assert functional.dtype == torch.float32
    metric = port_cls.BinaryConfusionMatrix(device="cpu")
    metric.update(preds, target)
    assert metric.compute().dtype == torch.int32
    torch.testing.assert_close(metric.compute(), functional.to(torch.int32))
    ml = port_fn.multilabel_confusion_matrix(torch.tensor([[0.9, 0.2], [0.3, 0.7], [0.8, 0.6]]),
                                             torch.tensor([[1, 0], [1, 0], [0, 1]]), num_labels=2)
    assert ml.dtype == torch.int32 and tuple(ml.shape) == (2, 2, 2)
    # label 0: preds 1, 0, 1 against 1, 1, 0 -> tn 0, fp 1, fn 1, tp 1
    assert ml[0].tolist() == [[0, 1], [1, 1]]


def test_binary_stat_scores_squeeze():
    """``_binary_stat_scores_compute`` ends in ``.squeeze()``: (5,) for a global result
    and for one sample, (N, 5) for N samples."""
    rng = np.random.default_rng(6)
    for n, mda in ((5, "global"), (1, "samplewise"), (3, "samplewise")):
        preds = rng.uniform(size=(n, 4)).astype(np.float32)
        target = rng.integers(0, 2, (n, 4))
        want = jax_fn.binary_stat_scores(jnp.asarray(preds), jnp.asarray(target), multidim_average=mda)
        got = port_fn.binary_stat_scores(torch.from_numpy(preds), torch.from_numpy(target), multidim_average=mda)
        _assert_matches(got, want)
        assert tuple(got.shape) == ((n, 5) if mda == "samplewise" and n > 1 else (5,))


@pytest.mark.parametrize("task", ["binary", "multilabel"])
def test_one_value_outside_unit_interval_sends_the_whole_batch_through_sigmoid(task):
    """A batch in [0, 1] except one value: both packages apply sigmoid to every value,
    so 0.3 counts as positive (sigmoid(0.3) > 0.5), which a per-element rule would not."""
    preds = np.array([[0.3, 0.1, 0.9, 0.0], [0.6, 0.2, 1.5, 0.4]], np.float32)
    target = np.array([[1, 1, 1, 0], [1, 0, 1, 0]])
    np.testing.assert_allclose(normalize_logits_if_needed(torch.from_numpy(preds)).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(preds))), atol=VALUE_ATOL, rtol=VALUE_RTOL)
    np.testing.assert_allclose(normalize_logits_if_needed(torch.from_numpy(preds)).numpy(),
                               torch.sigmoid(torch.from_numpy(preds)).numpy(), atol=0, rtol=0)
    if task == "binary":
        args, kwargs = (preds.reshape(-1), target.reshape(-1)), {}
    else:
        args, kwargs = (preds, target), {"num_labels": 4, "average": "micro"}
    name = f"{task}_stat_scores"
    want = getattr(jax_fn, name)(*(jnp.asarray(a) for a in args), **kwargs)
    got = getattr(port_fn, name)(*(torch.from_numpy(a) for a in args), **kwargs)
    _assert_matches(got, want)
    # every value but sigmoid(0.0) = 0.5 is above the threshold: 7 positives, 5 of them
    # true; a per-element rule would give 3 positives, all true
    assert got[:2].tolist() == [5, 2]


def test_in_range_batch_is_not_normalised_and_softmax_is_over_dim_1():
    preds = torch.tensor([0.0, 0.25, 1.0])
    assert torch.equal(normalize_logits_if_needed(preds), preds)
    assert normalize_logits_if_needed(torch.tensor([0, 1, 2])).dtype == torch.float32
    logits = np.random.default_rng(9).normal(size=(6, 4)).astype(np.float32)
    for batch in (logits, np.abs(logits) / 4):  # outside [0, 1], inside it
        _assert_matches(normalize_logits_if_needed(torch.from_numpy(batch), "softmax"),
                        jax_normalize(jnp.asarray(batch), "softmax"))


@pytest.mark.parametrize("threshold", [0.5, 0.25])
def test_preds_equal_to_the_threshold_count_as_negative(threshold):
    preds = np.array([threshold, threshold, 0.9, 0.1], np.float32)
    target = np.array([1, 0, 1, 0])
    want = jax_fn.binary_stat_scores(jnp.asarray(preds), jnp.asarray(target), threshold=threshold)
    got = port_fn.binary_stat_scores(torch.from_numpy(preds), torch.from_numpy(target), threshold=threshold)
    _assert_matches(got, want)
    assert got.tolist() == [1, 0, 2, 1, 2]  # tp, fp, tn, fn, support


def _collection(task: str):
    if task == "binary":
        names = ("BinaryAccuracy", "BinaryF1Score", "BinaryConfusionMatrix")
        kwargs = {"ignore_index": -1}
    else:
        names = ("MultilabelAccuracy", "MultilabelF1Score", "MultilabelConfusionMatrix")
        kwargs = {"num_labels": C}
    keys = ("acc", "f1", "confmat")
    port = MetricCollection({k: getattr(port_cls, n)(device="cpu", **kwargs) for k, n in zip(keys, names)},
                            device="cpu")
    jax = JaxMetricCollection({k: getattr(jax_cls, n)(**kwargs) for k, n in zip(keys, names)})
    return port.as_pure(), jax.as_pure()


@pytest.mark.parametrize("task", ["binary", "multilabel"])
def test_pure_collection_dtypes_match_jax(task):
    """``as_pure().apply`` twice: the binary confmat state becomes float32 (int32 default
    plus float32 batch counts), the multilabel one stays int32, the stat-score states
    stay int32, in both packages."""
    pure, jax_pure = _collection(task)
    states, jax_states = pure.init(), jax_pure.init()
    for seed in (7, 8):
        preds, target = _data(task, "logits", False, -1 if task == "binary" else None, False, seed)
        states, values = pure.apply(states, torch.from_numpy(preds), torch.from_numpy(target))
        jax_states, jax_values = jax_pure.apply(jax_states, jnp.asarray(preds), jnp.asarray(target))
    assert set(values) == set(jax_values) == {"acc", "f1", "confmat"}
    for key in values:
        _assert_matches(values[key], jax_values[key], exact=key == "confmat")
        for leaf, value in states[key].items():
            _assert_matches(value, jax_states[key][leaf], exact=True)
    assert states["confmat"]["confmat"].dtype == (torch.float32 if task == "binary" else torch.int32)
    assert states["acc"]["tp"].dtype == torch.int32


FACADES = ["Accuracy", "ConfusionMatrix", "F1Score", "FBetaScore", "HammingDistance", "NegativePredictiveValue",
           "Precision", "Recall", "Specificity", "StatScores"]


@pytest.mark.parametrize("facade", FACADES)
def test_task_facade_returns_the_tasks_class(facade):
    port_facade, jax_facade = getattr(tmt, facade), getattr(jax_cls, facade)
    for task, kwargs in (("binary", {}), ("multiclass", {"num_classes": 3}), ("multilabel", {"num_labels": 3})):
        metric = port_facade(task=task, device="cpu", **kwargs)
        assert isinstance(metric, tmt.Metric)
        assert type(metric).__name__ == type(jax_facade(task=task, **kwargs)).__name__
        assert type(metric) is getattr(port_cls, type(metric).__name__)
    with pytest.raises(ValueError, match="Invalid Task"):
        port_facade(task="multiregression", device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        port_facade(task="multiclass", device="cpu")
    with pytest.raises(ValueError, match="num_labels"):
        port_facade(task="multilabel", device="cpu")
    with pytest.raises(NotImplementedError):
        port_cls.base._ClassificationTaskWrapper()


def test_facade_defaults_and_arguments_reach_the_class():
    metric = tmt.FBetaScore(task="multiclass", beta=0.5, num_classes=3, top_k=2, zero_division=1, device="cpu")
    assert (metric.beta, metric.top_k, metric.average, metric.zero_division) == (0.5, 2, "micro", 1)
    metric = tmt.ConfusionMatrix(task="multilabel", num_labels=3, threshold=0.25, normalize="all", device="cpu")
    assert (metric.threshold, metric.normalize, tuple(metric.confmat.shape)) == (0.25, "all", (3, 2, 2))


@pytest.mark.parametrize("top_k", [2, 3])
def test_topk_ties_resolve_to_the_lower_index_like_jax(top_k):
    """Scores in quarters tie often; ``select_topk`` must keep the lower index among
    equal values, as ``jax.lax.top_k`` does, and every count built on it must match."""
    rng = np.random.default_rng(top_k)
    scores = (rng.integers(0, 5, (64, 5)) / 4).astype(np.float32)
    target = rng.integers(0, 5, 64)
    _assert_matches(select_topk(torch.from_numpy(scores), top_k), jax_select_topk(jnp.asarray(scores), top_k))
    example = torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.0]])
    assert torch.nonzero(select_topk(example, 3)[0]).flatten().tolist() == [0, 1, 3]
    for name, kwargs in (("MulticlassStatScores", {"average": "none"}), ("MulticlassAccuracy", {"average": "none"}),
                         ("MulticlassF1Score", {"average": "macro"})):
        jax_metric = getattr(jax_cls, name)(num_classes=5, top_k=top_k, **kwargs)
        metric = getattr(port_cls, name)(num_classes=5, top_k=top_k, device="cpu", **kwargs)
        jax_metric.update(jnp.asarray(scores), jnp.asarray(target))
        metric.update(torch.from_numpy(scores), torch.from_numpy(target))
        for leaf in ("tp", "fp", "tn", "fn"):
            _assert_matches(getattr(metric, leaf), getattr(jax_metric, leaf))
        _assert_matches(metric.compute(), jax_metric.compute())


def _neg_nan_f32() -> float:
    """A NaN with the sign bit set, made from its bits (arithmetic on CUDA makes only +NaN)."""
    return float(np.array([0xFFC00000], np.uint32).view(np.float32)[0])


def _same_bits(scores: np.ndarray, dtype: str):
    """``scores`` (float32) as a torch tensor and a JAX array of ``dtype`` holding the same
    bits: the frameworks' own float32-to-bfloat16 casts give a NaN different signs."""
    values = scores.astype(getattr(jnp, dtype))  # numpy's (ml_dtypes) cast, once
    if dtype == "float32":
        return torch.from_numpy(values.copy()), jnp.asarray(values)
    bits = values.view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16), jnp.asarray(values)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_ranks_signed_zeros_nans_and_infs_in_total_order_like_jax(dtype):
    """``jax.lax.top_k`` ranks by IEEE total order: +0.0 above -0.0, +NaN above +inf and
    -NaN below -inf. Fixed rows, then a seeded fuzz over {±0, ±1, ±inf, ±NaN, 0.5}."""
    nneg = _neg_nan_f32()
    fixed = [
        ([[-0.0, 0.5, 0.0, -1.0]], 2, [[0, 1, 1, 0]]),
        ([[nneg, -np.inf, -1.0, 0.0]], 2, [[0, 0, 1, 1]]),
        ([[nneg, -np.inf, -1.0, 0.0]], 3, [[0, 1, 1, 1]]),
        ([[np.nan, np.inf, 1.0, -0.0]], 2, [[1, 1, 0, 0]]),
        ([[1.0, 2.0, nneg, 0.0]], 2, [[1, 1, 0, 0]]),
    ]
    for row, k, want in fixed:
        scores, jax_scores = _same_bits(np.asarray(row, np.float32), dtype)
        got = select_topk(scores, k)
        assert got.tolist() == want, (row, k)
        _assert_matches(got, jax_select_topk(jax_scores, k))
    pool = np.asarray([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, nneg, 0.5], np.float32)
    rng = np.random.default_rng(11)
    for k in (2, 3):
        draws = pool[rng.integers(0, pool.size, (500, 6))]
        scores, jax_scores = _same_bits(draws, dtype)
        _assert_matches(select_topk(scores, k), jax_select_topk(jax_scores, k))
        scores, jax_scores = _same_bits(np.ascontiguousarray(draws.T), dtype)
        _assert_matches(select_topk(scores, k, dim=0), jax_select_topk(jax_scores, k, dim=0))


def test_tensor_validation_rejects_bad_values_and_shapes():
    with pytest.raises(RuntimeError, match="values in `target`"):
        port_fn.binary_accuracy(torch.tensor([0.2, 0.7]), torch.tensor([0, 2]))
    with pytest.raises(RuntimeError, match="values in `preds`"):
        port_fn.multilabel_accuracy(torch.tensor([[0, 2]]), torch.tensor([[0, 1]]), num_labels=2)
    with pytest.raises(RuntimeError, match="same shape"):
        port_fn.binary_stat_scores(torch.tensor([0.2, 0.7]), torch.tensor([0, 1, 1]))
    with pytest.raises(ValueError, match="threshold"):
        port_cls.BinaryAccuracy(threshold=2.0, device="cpu")
    with pytest.raises(ValueError, match="beta"):
        port_fn.binary_fbeta_score(torch.tensor([0.2]), torch.tensor([0]), beta=-1.0)
    assert float(port_fn.binary_accuracy(torch.tensor([0.2, 0.7]), torch.tensor([0, 255]), ignore_index=255)) == 1.0


def test_non_tensor_input_goes_to_the_default_device(monkeypatch):
    """A list becomes a tensor on ``resolve_device(None)`` (CUDA): without CUDA the
    functional entry point raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_fn.binary_accuracy([0.2, 0.7], [0, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmt.Accuracy(task="binary")
