"""The port's retrieval metrics against the JAX package, on the CPU: the query padding,
the nine row-wise kernels, the ten functions and the eleven classes.

The same numpy inputs, made from a seed, go through the JAX package and the port.
Tolerances:

- the padded ``(Q, L)`` layout, the cat states (indexes int32, preds float32, target
  int32), ``ks`` and ``best_k`` equal bit for bit;
- values within ``VALUE_ATOL`` (1e-6): the JAX package adds AP's precisions and DCG's
  gains and discounts in float32 in XLA's order, the port in float64 rounded once, and
  the two ``log2`` of the discounts may differ in the last bit.

Scores carry ties (rounded to a few levels), zeros of both signs, and in one set NaN
and infinities, so every sort's tie order and key are held to the JAX package's.
"""

from __future__ import annotations

import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sync import PortCoalescedWorld

from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu import retrieval as jax_ret
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch import retrieval as port_ret

jax_utils = importlib.import_module("torchmetrics_tpu.functional.retrieval.utils")
port_utils = importlib.import_module("torchmetrics_tpu_torch.functional.retrieval.utils")
jax_kernels = importlib.import_module("torchmetrics_tpu.functional.retrieval._kernels")
port_kernels = importlib.import_module("torchmetrics_tpu_torch.functional.retrieval._kernels")
jax_base = importlib.import_module("torchmetrics_tpu.retrieval.base")
port_base = importlib.import_module("torchmetrics_tpu_torch.retrieval.base")

CPU = {"device": "cpu"}
VALUE_ATOL = 1e-6
NB = 3  # updates per class run


def _corpus(seed: int, rows: int = 240, queries: int = 14, kind: str = "ties", graded: bool = False):
    """(indexes int64 sparse ids, preds float32, target int64) for ``rows`` documents of
    ``queries`` queries of uneven length; ``kind`` picks the scores. The query layout is
    the same for every seed, so the JAX package compiles each op for one shape."""
    layout = np.random.default_rng(0)
    ids = layout.choice(1_100_000, size=queries, replace=False)
    weights = layout.uniform(0.2, 1.0, queries)
    idx = ids[layout.choice(queries, size=rows, p=weights / weights.sum())]
    rng = np.random.default_rng(seed)
    if kind == "ties":  # a few levels, zeros of both signs
        preds = rng.choice(np.asarray([-0.5, -0.0, 0.0, 0.25, 0.5, 1.0], np.float32), size=rows)
    elif kind == "nonfinite":
        preds = rng.normal(size=rows).astype(np.float32)
        special = rng.choice(rows, size=rows // 8, replace=False)
        preds[special] = rng.choice(np.asarray([np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32), size=special.size)
    else:
        preds = rng.normal(size=rows).astype(np.float32)
    target = rng.integers(0, 4 if graded else 2, size=rows)
    target[rng.random(rows) < 0.4] = 0
    # one all-negative and one all-positive query
    target[idx == ids[0]] = 0
    target[idx == ids[1]] = 1
    return idx.astype(np.int64), preds.astype(np.float32), target.astype(np.int64)


CORPORA = {
    "ties": _corpus(0),
    "normal": _corpus(1, kind="normal"),
    "nonfinite": _corpus(2, kind="nonfinite"),
}
GRADED = _corpus(3, graded=True)
# queries of one length: ``max_fpr`` runs the JAX package's ``binary_auroc`` per query,
# compiled per length
EVEN = (np.repeat(np.asarray([41, 7, 1009, 3]), 10), *_corpus(4, rows=40)[1:])


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape, context
    np.testing.assert_allclose(p.astype(np.float64), r.astype(np.float64), rtol=0, atol=VALUE_ATOL, err_msg=context)


def _bitwise(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    np.testing.assert_array_equal(p, r, err_msg=context)


def _padded(corpus):
    idx, p, t = corpus
    t = t.astype(np.int32)
    jax_out = jax_utils._pad_queries(jnp.asarray(idx.astype(np.int32)), jnp.asarray(p), jnp.asarray(t))
    port_out = port_utils._pad_queries(torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(p), torch.from_numpy(t))
    return jax_out, port_out


# ------------------------------------------------------------------ padding


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_pad_queries_layout_is_the_jax_packages_bit_for_bit(name):
    (jp, jt, jm), (pp, pt, pm) = _padded(CORPORA[name])
    for got, want, what in ((pp, jp, "preds"), (pt, jt, "target"), (pm, jm, "mask")):
        _bitwise(got, want, what)
    np.testing.assert_array_equal(_np(pp).view(np.int32), np.asarray(jp).view(np.int32))  # signed zeros, NaN bits


def test_pad_queries_keeps_the_input_order_within_a_query():
    idx = torch.tensor([7, 3, 7, 3, 9, 7], dtype=torch.int32)
    preds = torch.arange(6, dtype=torch.float32)
    p2, t2, m2 = port_utils._pad_queries(idx, preds, torch.zeros(6, dtype=torch.int32))
    assert p2.tolist() == [[1.0, 3.0, 0.0], [0.0, 2.0, 5.0], [4.0, 0.0, 0.0]]
    assert m2.tolist() == [[True, True, False], [True, True, True], [True, False, False]]


# ------------------------------------------------------------------ kernels

KERNELS = ["_ap_kernel", "_rr_kernel", "_precision_kernel", "_recall_kernel", "_hit_rate_kernel", "_fall_out_kernel",
           "_ndcg_kernel", "_auroc_kernel"]
TOP_KS = [None, 1, 5, 80]  # 80 is beyond the longest query


@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernels_match_the_jax_package(kernel, name):
    (jp, jt, jm), (pp, pt, pm) = _padded(CORPORA[name])
    for top_k in TOP_KS:
        _close(getattr(port_kernels, kernel)(pp, pt, pm, top_k), getattr(jax_kernels, kernel)(jp, jt, jm, top_k),
               f"{kernel} top_k={top_k}")


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_r_precision_and_adaptive_precision_kernels(name):
    (jp, jt, jm), (pp, pt, pm) = _padded(CORPORA[name])
    _close(port_kernels._r_precision_kernel(pp, pt, pm), jax_kernels._r_precision_kernel(jp, jt, jm))
    for top_k in TOP_KS[1:]:
        _close(port_kernels._precision_kernel(pp, pt, pm, top_k, True),
               jax_kernels._precision_kernel(jp, jt, jm, top_k, True), f"adaptive top_k={top_k}")


@pytest.mark.parametrize("top_k", TOP_KS)
def test_ndcg_kernel_graded_gains(top_k):
    (jp, jt, jm), (pp, pt, pm) = _padded(GRADED)
    _close(port_kernels._ndcg_kernel(pp, pt, pm, top_k), jax_kernels._ndcg_kernel(jp, jt, jm, top_k))


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_tie_average_ranks_equal_the_jax_packages_bit_for_bit(name):
    (jp, _, jm), (pp, _, pm) = _padded(CORPORA[name])
    _bitwise(port_utils._tie_average_ranks(pp, pm), jax_utils._tie_average_ranks(jp, jm))
    ordered = np.sort(np.asarray(jp), axis=-1)
    _bitwise(port_utils._row_segment_ids(torch.from_numpy(ordered)), jax_utils._row_segment_ids(jnp.asarray(ordered)))
    jr, jmask = jax_utils._ranked_by_preds(jp, jnp.arange(jp.size, dtype=jnp.int32).reshape(jp.shape), jm)
    pr, pmask = port_utils._ranked_by_preds(pp, torch.arange(pp.numel(), dtype=torch.int32).reshape(pp.shape), pm)
    _bitwise(pr, jr, "rank order")
    _bitwise(pmask, jmask, "ranked mask")


# ---------------------------------------------------------------- functions

FUNCTIONS = ["retrieval_average_precision", "retrieval_reciprocal_rank", "retrieval_precision", "retrieval_recall",
             "retrieval_hit_rate", "retrieval_fall_out", "retrieval_normalized_dcg", "retrieval_auroc"]


def _queries():
    """Single queries: random, tied, signed zeros, one document, all positive, all
    negative, graded."""
    rng = np.random.default_rng(5)
    out = []
    p = rng.random(8).astype(np.float32)  # few lengths: the JAX package compiles each op per shape
    t = rng.integers(0, 2, 8)
    t[0] = 1
    out.append((p, t))
    out.append((np.asarray([0.5, 0.5, 0.7, 0.2, 0.5, 0.0, -0.0, 0.7], np.float32), np.asarray([1, 0, 1, 0, 1, 0, 1, 1])))
    out.append((np.asarray([0.3], np.float32), np.asarray([1])))
    out.append((np.asarray([0.3, 0.1, 0.3], np.float32), np.asarray([1, 1, 1])))
    out.append((np.asarray([0.3, 0.1, 0.3], np.float32), np.asarray([0, 0, 0])))
    return out


QUERIES = _queries()


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_functions_match_the_jax_package(fn):
    for i, (p, t) in enumerate(QUERIES):
        for top_k in (None, 1, 50):  # the kernel tests take a k inside the longest query
            kw = {} if top_k is None else {"top_k": top_k}
            _close(getattr(port_fn, fn)(torch.from_numpy(p), torch.from_numpy(t), **kw),
                   getattr(jax_fn, fn)(jnp.asarray(p), jnp.asarray(t), **kw), f"{fn} query {i} top_k={top_k}")
    for p, t in QUERIES:
        _close(port_fn.retrieval_r_precision(torch.from_numpy(p), torch.from_numpy(t)),
               jax_fn.retrieval_r_precision(jnp.asarray(p), jnp.asarray(t)))


def test_precision_adaptive_k_and_graded_ndcg():
    for p, t in QUERIES:
        for top_k in (1, 3, 50):
            _close(port_fn.retrieval_precision(torch.from_numpy(p), torch.from_numpy(t), top_k, True),
                   jax_fn.retrieval_precision(jnp.asarray(p), jnp.asarray(t), top_k, True))
    rng = np.random.default_rng(9)
    p = np.round(rng.random(15), 1).astype(np.float32)
    t = rng.integers(0, 5, 15)
    for top_k in (None, 3):
        _close(port_fn.retrieval_normalized_dcg(torch.from_numpy(p), torch.from_numpy(t), top_k),
               jax_fn.retrieval_normalized_dcg(jnp.asarray(p), jnp.asarray(t), top_k))


@pytest.mark.parametrize("max_fpr", [0.1, 0.5, 1.0])
def test_auroc_max_fpr_through_binary_auroc(max_fpr):
    for i, (p, t) in enumerate(QUERIES):
        for top_k in (None, 4):
            _close(port_fn.retrieval_auroc(torch.from_numpy(p), torch.from_numpy(t), top_k, max_fpr),
                   jax_fn.retrieval_auroc(jnp.asarray(p), jnp.asarray(t), top_k, max_fpr), f"query {i} top_k={top_k}")


@pytest.mark.parametrize("max_k, adaptive_k", [(None, False), (3, False), (30, False), (30, True)])
def test_precision_recall_curve_function(max_k, adaptive_k):
    for p, t in QUERIES:
        got = port_fn.retrieval_precision_recall_curve(torch.from_numpy(p), torch.from_numpy(t), max_k, adaptive_k)
        want = jax_fn.retrieval_precision_recall_curve(jnp.asarray(p), jnp.asarray(t), max_k, adaptive_k)
        _close(got[0], want[0])
        _close(got[1], want[1])
        _bitwise(got[2], want[2], "ks")


@pytest.mark.parametrize(
    "call",
    [
        lambda f: f.retrieval_average_precision([0.1], [1], top_k=-1),
        lambda f: f.retrieval_average_precision([0.1, 0.2], [1]),
        lambda f: f.retrieval_average_precision([0.1], [2]),
        lambda f: f.retrieval_average_precision([1, 2], [1, 0]),
        lambda f: f.retrieval_average_precision([0.1, 0.2], [0.5, 1.0]),
        lambda f: f.retrieval_precision([0.1], [1], adaptive_k=1),
        lambda f: f.retrieval_precision_recall_curve([0.1], [1], max_k=0),
        lambda f: f.retrieval_average_precision([], []),
    ],
    ids=["top_k", "shape", "non_binary", "int_preds", "float_target", "adaptive_k", "max_k", "empty"],
)
def test_function_errors_like_the_jax_package(call):
    with pytest.raises(ValueError) as jax_err:
        call(_JaxLists(jax_fn))
    with pytest.raises(ValueError) as port_err:
        call(_PortLists(port_fn))
    assert str(port_err.value) == str(jax_err.value)


class _JaxLists:
    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        fn = getattr(self.module, name)
        return lambda p, t, **kw: fn(jnp.asarray(p), jnp.asarray(t), **kw)


class _PortLists(_JaxLists):
    def __getattr__(self, name):
        fn = getattr(self.module, name)
        return lambda p, t, **kw: fn(torch.tensor(p), torch.tensor(t), **kw)


# ------------------------------------------------------------------ classes

CLASSES = [
    ("map", "RetrievalMAP", {}),
    ("map_top3", "RetrievalMAP", {"top_k": 3}),
    ("mrr", "RetrievalMRR", {}),
    ("mrr_top1", "RetrievalMRR", {"top_k": 1}),
    ("precision", "RetrievalPrecision", {}),
    ("precision_top5", "RetrievalPrecision", {"top_k": 5}),
    ("precision_adaptive", "RetrievalPrecision", {"top_k": 80, "adaptive_k": True}),
    ("recall_top5", "RetrievalRecall", {"top_k": 5}),
    ("hit_rate_top3", "RetrievalHitRate", {"top_k": 3}),
    ("fall_out_top5", "RetrievalFallOut", {"top_k": 5}),
    ("r_precision", "RetrievalRPrecision", {}),
    ("ndcg", "RetrievalNormalizedDCG", {}),
    ("ndcg_top5", "RetrievalNormalizedDCG", {"top_k": 5}),
    ("auroc", "RetrievalAUROC", {}),
    ("auroc_top5", "RetrievalAUROC", {"top_k": 5}),
]
ACTIONS = ["neg", "pos", "skip"]


def _pair(cls: str, kw: dict):
    return getattr(jax_ret, cls)(**kw), getattr(port_ret, cls)(**kw, **CPU)


def _feed(jax_metric, port_metric, corpus, forward: bool = False):
    idx, p, t = corpus
    outs = []
    for chunk in np.array_split(np.arange(idx.size), NB):
        j_args = (jnp.asarray(p[chunk]), jnp.asarray(t[chunk]), jnp.asarray(idx[chunk]))
        p_args = (torch.from_numpy(p[chunk]), torch.from_numpy(t[chunk]), torch.from_numpy(idx[chunk]))
        if forward:
            outs.append((port_metric(*p_args), jax_metric(*j_args)))
        else:
            jax_metric.update(*j_args)
            port_metric.update(*p_args)
    return outs


def _states_bitwise(port_metric, jax_metric) -> None:
    for key in ("indexes", "preds", "target"):
        assert len(port_metric._state[key]) == len(jax_metric._state[key])
        for got, want in zip(port_metric._state[key], jax_metric._state[key]):
            _bitwise(got, want, key)


def _values_close(got, want, context=""):
    for g, w in zip(*((list(v) if isinstance(v, tuple) else [v]) for v in (got, want))):
        _close(g, w, context)


@pytest.mark.parametrize("action", ACTIONS)
@pytest.mark.parametrize("case, cls, kw", CLASSES, ids=[c[0] for c in CLASSES])
def test_classes_match_the_jax_package(case, cls, kw, action):
    corpus = GRADED if cls == "RetrievalNormalizedDCG" else CORPORA["ties"]
    jax_metric, port_metric = _pair(cls, {**kw, "empty_target_action": action})
    _feed(jax_metric, port_metric, corpus)
    _states_bitwise(port_metric, jax_metric)
    _values_close(port_metric.compute(), jax_metric.compute(), case)


@pytest.mark.parametrize("name", ["normal", "nonfinite"])
@pytest.mark.parametrize("cls", ["RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG", "RetrievalAUROC"])
def test_classes_on_other_scores(cls, name):
    jax_metric, port_metric = _pair(cls, {"top_k": 5})
    _feed(jax_metric, port_metric, CORPORA[name])
    _values_close(port_metric.compute(), jax_metric.compute(), f"{cls} {name}")


@pytest.mark.parametrize("action", ACTIONS)
def test_auroc_max_fpr_class_loops_over_the_queries(action):
    idx, p, t = EVEN
    t = t.copy()
    t[:10] = 0  # one query without a positive
    jax_metric, port_metric = _pair("RetrievalAUROC", {"max_fpr": 0.5, "empty_target_action": action})
    _feed(jax_metric, port_metric, (idx, p, t))
    _close(port_metric.compute(), jax_metric.compute(), action)


def test_error_action_raises_like_the_jax_package():
    jax_metric, port_metric = _pair("RetrievalMAP", {"empty_target_action": "error"})
    _feed(jax_metric, port_metric, CORPORA["ties"])
    with pytest.raises(ValueError, match="no positive target"):
        jax_metric.compute()
    with pytest.raises(ValueError, match="no positive target"):
        port_metric.compute()


def test_skip_of_every_query_gives_zero():
    idx, p, t = np.asarray([0, 0, 1]), np.asarray([0.3, 0.2, 0.5], np.float32), np.asarray([0, 0, 0])
    for cls in ("RetrievalMAP", "RetrievalPrecisionRecallCurve"):
        jax_metric, port_metric = _pair(cls, {"empty_target_action": "skip", **({"max_k": 2} if "Curve" in cls else {})})
        jax_metric.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(idx))
        port_metric.update(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(idx))
        _values_close(port_metric.compute(), jax_metric.compute(), cls)


def _mean_of_top_two(values):
    return values.sort().values[-2:].mean() if isinstance(values, torch.Tensor) else jnp.sort(values)[-2:].mean()


@pytest.mark.parametrize("aggregation", ["mean", "median", "min", "max", "callable"])
def test_aggregations_match_the_jax_package(aggregation):
    agg = _mean_of_top_two if aggregation == "callable" else aggregation
    jax_metric, port_metric = _pair("RetrievalMAP", {"aggregation": agg})
    _feed(jax_metric, port_metric, CORPORA["normal"])
    _close(port_metric.compute(), jax_metric.compute(), aggregation)


def test_median_of_an_even_count_is_the_mean_of_the_middle_two():
    """The docstring's two queries: JAX's median is (1.0 + 0.5833) / 2, where
    ``torch.median`` would give the lower value."""
    idx = np.asarray([0, 0, 0, 1, 1, 1, 1])
    p = np.asarray([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2], np.float32)
    t = np.asarray([0, 0, 1, 0, 1, 0, 1])
    jax_metric, port_metric = _pair("RetrievalMAP", {"aggregation": "median"})
    jax_metric.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(idx))
    port_metric.update(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(idx))
    _bitwise(port_metric.compute(), jax_metric.compute())
    assert float(port_metric.compute()) == pytest.approx(0.7916667, abs=1e-7)
    for values in ([3.0, 1.0, 2.0, 4.0], [2.0], [1.0, float("nan"), 3.0], [0.5, -0.0, 0.0, 0.25]):
        _bitwise(port_base._median(torch.tensor(values)), jax_base._retrieval_aggregate(jnp.asarray(values), "median"))


def test_ignore_index_drops_the_rows_before_the_states():
    idx = np.asarray([0, 0, 0, 0, 1, 1, 1])
    p = np.asarray([0.9, 0.8, 0.3, 0.2, 0.4, 0.6, 0.1], np.float32)
    t = np.asarray([1, -1, 0, -1, 0, 1, -1])
    jax_metric, port_metric = _pair("RetrievalMAP", {"ignore_index": -1})
    jax_metric.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(idx))
    port_metric.update(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(idx))
    _states_bitwise(port_metric, jax_metric)
    _close(port_metric.compute(), jax_metric.compute())


@pytest.mark.parametrize("max_k, adaptive_k", [(None, False), (4, False), (60, True), (60, False)])
@pytest.mark.parametrize("action", ACTIONS)
def test_precision_recall_curve_class(max_k, adaptive_k, action):
    kw = {"max_k": max_k, "adaptive_k": adaptive_k, "empty_target_action": action}
    jax_metric, port_metric = _pair("RetrievalPrecisionRecallCurve", kw)
    _feed(jax_metric, port_metric, CORPORA["ties"])
    got, want = port_metric.compute(), jax_metric.compute()
    _close(got[0], want[0], "precision")
    _close(got[1], want[1], "recall")
    _bitwise(got[2], want[2], "ks")


@pytest.mark.parametrize("min_precision", [0.0, 0.2, 0.45, 0.99])
@pytest.mark.parametrize("max_k", [None, 6])
def test_recall_at_fixed_precision_picks_the_jax_packages_k(min_precision, max_k):
    jax_metric, port_metric = _pair("RetrievalRecallAtFixedPrecision", {"min_precision": min_precision, "max_k": max_k})
    _feed(jax_metric, port_metric, CORPORA["ties"])
    (got_r, got_k), (want_r, want_k) = port_metric.compute(), jax_metric.compute()
    _close(got_r, want_r)
    _bitwise(got_k, want_k, "best_k")


def test_recall_at_fixed_precision_clamps_a_zero_recall_to_max_k():
    idx, p, t = np.asarray([0, 0, 0]), np.asarray([-0.3, -0.2, -0.5], np.float32), np.asarray([1, 0, 0])
    jax_metric, port_metric = _pair("RetrievalRecallAtFixedPrecision", {"min_precision": 0.0, "max_k": 2})
    jax_metric.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(idx))
    port_metric.update(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(idx))
    (got_r, got_k), (want_r, want_k) = port_metric.compute(), jax_metric.compute()
    _bitwise(got_r, want_r)
    _bitwise(got_k, want_k)
    assert int(got_k) == 2


def test_state_dtypes_are_the_jax_packages():
    jax_metric, port_metric = _pair("RetrievalMAP", {})
    _feed(jax_metric, port_metric, CORPORA["ties"])
    for key, dtype in (("indexes", torch.int32), ("preds", torch.float32), ("target", torch.int32)):
        assert all(x.dtype == dtype for x in port_metric._state[key])
        assert all(str(x.dtype) == str(dtype).replace("torch.", "") for x in jax_metric._state[key])
    curve = port_ret.RetrievalRecallAtFixedPrecision(max_k=3, **CPU)
    curve.update(torch.tensor([0.5, 0.2]), torch.tensor([1, 0]), torch.tensor([0, 0]))
    assert curve.compute()[1].dtype == torch.int32


def test_multi_update_merge_and_forward_match_the_jax_package():
    """``forward`` gives each batch's own value (a fresh metric's) and accumulates; the
    accumulated states and value, and a merge of two halves, are the JAX package's."""
    idx, p, t = GRADED
    jax_metric, port_metric = _pair("RetrievalNormalizedDCG", {"empty_target_action": "neg"})
    for chunk in np.array_split(np.arange(idx.size), NB):
        args = (torch.from_numpy(p[chunk]), torch.from_numpy(t[chunk]), torch.from_numpy(idx[chunk]))
        alone = port_ret.RetrievalNormalizedDCG(**CPU)
        alone.update(*args)
        _bitwise(port_metric(*args), alone.compute(), "forward")
        jax_metric.update(jnp.asarray(p[chunk]), jnp.asarray(t[chunk]), jnp.asarray(idx[chunk]))
    _states_bitwise(port_metric, jax_metric)
    _close(port_metric.compute(), jax_metric.compute())
    half = idx.size // 2
    a, b = port_ret.RetrievalNormalizedDCG(**CPU), port_ret.RetrievalNormalizedDCG(**CPU)
    a.update(torch.from_numpy(p[:half]), torch.from_numpy(t[:half]), torch.from_numpy(idx[:half]))
    b.update(torch.from_numpy(p[half:]), torch.from_numpy(t[half:]), torch.from_numpy(idx[half:]))
    a.merge_state(b)
    _close(a.compute(), jax_metric.compute(), "merged")


def test_cat_states_through_the_coalesced_sync():
    """Two simulated ranks with uneven halves: the synced states are rank 0's rows then
    rank 1's, and the value is the whole corpus's in the JAX package."""
    idx, p, t = CORPORA["ties"]
    cut = idx.size // 3
    ranks = []
    for part in (slice(0, cut), slice(cut, None)):
        m = port_ret.RetrievalMAP(top_k=5, **CPU)
        m.update(torch.from_numpy(p[part]), torch.from_numpy(t[part]), torch.from_numpy(idx[part]))
        ranks.append(m)
    world = PortCoalescedWorld([m._state for m in ranks], ranks[0]._reductions)
    ranks[0].sync(dist_sync_fn=world, distributed_available=lambda: True)
    jax_metric = jax_ret.RetrievalMAP(top_k=5)
    jax_metric.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(idx))
    for key in ("indexes", "preds", "target"):
        synced = torch.cat([torch.atleast_1d(x) for x in ranks[0]._state[key]])
        _bitwise(synced, np.concatenate([np.asarray(x) for x in jax_metric._state[key]]), key)
    _close(ranks[0].compute(), jax_metric.compute())
    ranks[0].unsync()


@pytest.mark.parametrize("cls, kw", [("RetrievalMAP", {}), ("RetrievalNormalizedDCG", {"top_k": 5})])
def test_jax_state_dict_loads_into_the_port(cls, kw):
    jax_metric = getattr(jax_ret, cls)(**kw)
    jax_metric.persistent(True)
    _feed(jax_metric, getattr(port_ret, cls)(**kw, **CPU), GRADED if "DCG" in cls else CORPORA["ties"])
    port_metric = getattr(port_ret, cls)(**kw, **CPU)
    port_metric.load_state_dict(jax_metric.state_dict())
    _states_bitwise(port_metric, jax_metric)
    _close(port_metric.compute(), jax_metric.compute())
    damaged = {k: v for k, v in jax_metric.state_dict().items() if k != "preds"}
    from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError

    with pytest.raises(StateCorruptionError):
        getattr(port_ret, cls)(**kw, **CPU).load_state_dict(damaged)


def test_metric_parity_hook_and_pickle():
    p, t = QUERIES[1]
    jax_metric, port_metric = _pair("RetrievalMAP", {})
    _close(port_metric._metric(torch.from_numpy(p), torch.from_numpy(t)), jax_metric._metric(jnp.asarray(p), jnp.asarray(t)))
    _feed(jax_metric, port_metric, CORPORA["ties"])
    clone = pickle.loads(pickle.dumps(port_metric))
    _close(clone.compute(), jax_metric.compute())


@pytest.mark.parametrize(
    "build",
    [
        lambda m, **d: m.RetrievalMAP(empty_target_action="bogus", **d),
        lambda m, **d: m.RetrievalMAP(ignore_index="x", **d),
        lambda m, **d: m.RetrievalPrecision(top_k=-2, **d),
        lambda m, **d: m.RetrievalMAP(aggregation="bogus", **d),
        lambda m, **d: m.RetrievalPrecision(adaptive_k=2, **d),
        lambda m, **d: m.RetrievalAUROC(max_fpr=1.5, **d),
        lambda m, **d: m.RetrievalPrecisionRecallCurve(max_k=0, **d),
        lambda m, **d: m.RetrievalRecallAtFixedPrecision(min_precision=2.0, **d),
    ],
    ids=["action", "ignore_index", "top_k", "aggregation", "adaptive_k", "max_fpr", "max_k", "min_precision"],
)
def test_constructor_errors_like_the_jax_package(build):
    with pytest.raises(ValueError) as jax_err:
        build(jax_ret)
    with pytest.raises(ValueError) as port_err:
        build(port_ret, **CPU)
    assert str(port_err.value) == str(jax_err.value)


def test_update_errors_like_the_jax_package():
    for args in (([0.1, 0.2], [1, 0], None), ([0.1, 0.2], [1, 0], [0.5, 1.5]), ([0.1, 0.2], [2, 0], [0, 0]),
                 ([0.1, 0.2], [1, 0], [0])):
        p, t, i = args
        with pytest.raises(ValueError) as jax_err:
            jax_ret.RetrievalMAP().update(jnp.asarray(p), jnp.asarray(t),
                                          None if i is None else jnp.asarray(i))
        with pytest.raises(ValueError) as port_err:
            port_ret.RetrievalMAP(**CPU).update(torch.tensor(p), torch.tensor(t), None if i is None else torch.tensor(i))
        assert str(port_err.value) == str(jax_err.value)


def test_exports_equal_the_jax_packages():
    import torchmetrics_tpu as jtm
    import torchmetrics_tpu_torch as ttm

    assert sorted(port_ret.__all__) == sorted(jax_ret.__all__)
    assert sorted(port_fn.retrieval.__all__) == sorted(jax_fn.retrieval.__all__)
    for name in port_ret.__all__:
        assert getattr(ttm, name) is getattr(port_ret, name)
        assert name in jtm.__all__ and name in ttm.__all__
    for name in port_fn.retrieval.__all__:
        assert getattr(port_fn, name) is getattr(port_fn.retrieval, name)
