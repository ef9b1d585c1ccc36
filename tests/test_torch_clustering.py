"""The port's clustering metrics against the JAX package, on the CPU: the contingency
helpers, the ten extrinsic and three intrinsic functions, and the thirteen classes.

The same numpy inputs, made from a seed, go through the JAX package and the port.
Tolerances:

- contingency tables, pair matrices, margins and ``ClusterAccuracy``'s state bit for
  bit, and the classes' label and data states bit for bit (int32 labels, float32 data);
- values (float64 computed, rounded to float32) within 1e-6 relative above 0.1 and
  1e-7 absolute below: the port adds in another order (on the device) than numpy, and
  its ``lgamma`` is torch's, not scipy's. AMI, close to 0 on random clusterings, is held
  absolutely (1e-7);
- the float64 entropies and expected mutual information within 1e-12 relative.
"""

from __future__ import annotations

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError

jax_utils = importlib.import_module("torchmetrics_tpu.functional.clustering.utils")
port_utils = importlib.import_module("torchmetrics_tpu_torch.functional.clustering.utils")
jax_extrinsic = importlib.import_module("torchmetrics_tpu.functional.clustering.extrinsic")
port_extrinsic = importlib.import_module("torchmetrics_tpu_torch.functional.clustering.extrinsic")
port_pairwise_helpers = importlib.import_module("torchmetrics_tpu_torch.functional.pairwise.helpers")

CPU = {"device": "cpu"}
_RNG = np.random.default_rng(42)  # the inputs of tests/test_clustering_nominal.py
NUM_BATCHES, BATCH = 4, 48
LABELS_P = _RNG.integers(0, 5, (NUM_BATCHES, BATCH))
LABELS_T = _RNG.integers(0, 5, (NUM_BATCHES, BATCH))
DATA = _RNG.normal(size=(NUM_BATCHES, BATCH, 3)).astype(np.float32)

EXTRINSIC = ("mutual_info_score", "adjusted_mutual_info_score", "normalized_mutual_info_score", "rand_score",
             "adjusted_rand_score", "fowlkes_mallows_index", "homogeneity_score", "completeness_score",
             "v_measure_score")
INTRINSIC = ("calinski_harabasz_score", "davies_bouldin_score", "dunn_index")
CLASSES = {"mutual_info_score": "MutualInfoScore", "adjusted_mutual_info_score": "AdjustedMutualInfoScore",
           "normalized_mutual_info_score": "NormalizedMutualInfoScore", "rand_score": "RandScore",
           "adjusted_rand_score": "AdjustedRandScore", "fowlkes_mallows_index": "FowlkesMallowsIndex",
           "homogeneity_score": "HomogeneityScore", "completeness_score": "CompletenessScore",
           "v_measure_score": "VMeasureScore", "calinski_harabasz_score": "CalinskiHarabaszScore",
           "davies_bouldin_score": "DaviesBouldinScore", "dunn_index": "DunnIndex"}
# label pairs beyond the shared inputs
EDGES = {
    "one_cluster": (np.zeros(12, np.int64), np.arange(12) % 3),
    "one_class": (np.arange(12) % 4, np.zeros(12, np.int64)),
    "all_distinct": (np.arange(12), np.arange(12) % 2),
    "identical": (np.arange(12) % 3, np.arange(12) % 3),
    "integral_floats": ((np.arange(12) % 3).astype(np.float32), (np.arange(12) % 4).astype(np.float64)),
    "sparse_large_labels": (np.asarray([2**40, 7, -3, 7, 2**40, -3]), np.asarray([5, 5, 9, 9, 1, 1])),
}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, context: str = "", absolute: bool = False) -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    p64, r64 = p.astype(np.float64), r.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(p64), np.isnan(r64), err_msg=context)
    tol = np.full(r64.shape, 1e-7) if absolute else np.where(np.abs(r64) < 0.1, 1e-7, 1e-6 * np.abs(r64))
    keep = ~np.isnan(r64) & (p64 != r64)  # equal values, infinities included, pass
    assert np.all(np.abs(p64[keep] - r64[keep]) <= tol[keep]), f"{context}: {p} against {r}"


def _bitwise(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    np.testing.assert_array_equal(p, r, err_msg=context)


def _both(fn_name: str, *arrays, **kw):
    """(JAX, port) results of ``fn_name``. The JAX functions read numpy arrays as they are
    (``jnp.asarray`` would wrap int64 labels to int32 first)."""
    jax_out = getattr(jax_fn, fn_name)(*[np.asarray(a) for a in arrays], **kw)
    port_out = getattr(port_fn, fn_name)(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw)
    return jax_out, port_out


# ------------------------------------------------------------------ the helpers

LABEL_CASES = {"batch0": (LABELS_P[0], LABELS_T[0]), "all": (LABELS_P.reshape(-1), LABELS_T.reshape(-1)), **EDGES}


@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_contingency_and_pair_matrices_are_the_jax_packages_bit_for_bit(case):
    preds, target = LABEL_CASES[case]
    jax_table = jax_utils.calculate_contingency_matrix(preds, target)
    port_table = port_utils.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    _bitwise(port_table, jax_table, "contingency")
    _bitwise(port_utils.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target), eps=0.5),
             jax_utils.calculate_contingency_matrix(preds, target, eps=0.5), "eps")
    jax_pairs = jax_utils.calculate_pair_cluster_confusion_matrix(preds, target)
    _bitwise(port_utils.calculate_pair_cluster_confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target)),
             jax_pairs, "pairs from labels")
    _bitwise(port_utils.calculate_pair_cluster_confusion_matrix(contingency=port_table), jax_pairs, "pairs from table")
    cells = port_utils._contingency_cells(torch.from_numpy(preds), torch.from_numpy(target))
    _bitwise(cells.row_sums.double(), jax_table.sum(1), "row margins")
    _bitwise(cells.col_sums.double(), jax_table.sum(0), "column margins")
    nz_rows, nz_cols = np.nonzero(jax_table)
    _bitwise(cells.rows, nz_rows.astype(np.int64), "cell rows (row-major order)")
    _bitwise(cells.cols, nz_cols.astype(np.int64), "cell columns")
    _bitwise(cells.counts.double(), jax_table[nz_rows, nz_cols], "cell counts")


@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_entropy_and_expected_mutual_information(case):
    preds, target = LABEL_CASES[case]
    for x in (preds, target):
        np.testing.assert_allclose(port_utils.calculate_entropy(torch.from_numpy(x)), jax_utils.calculate_entropy(x),
                                   rtol=1e-12)
    table = jax_utils.calculate_contingency_matrix(preds, target)
    want = jax_extrinsic.expected_mutual_info_score(table, preds.size)
    cells = port_utils._contingency_cells(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_allclose(port_extrinsic.expected_mutual_info_score(cells, preds.size), want, rtol=1e-12)
    np.testing.assert_allclose(port_extrinsic.expected_mutual_info_score(torch.from_numpy(table), preds.size), want,
                               rtol=1e-12)


def test_entropy_edges():
    assert port_utils.calculate_entropy(torch.zeros(0)) == 1.0 == jax_utils.calculate_entropy(np.zeros(0))
    assert port_utils.calculate_entropy(torch.full((5,), 3)) == 0.0


@pytest.mark.parametrize("p", ["min", "geometric", "arithmetic", "max", 2, 0.5])
def test_generalized_mean(p):
    x = np.asarray([0.5, 2.0, 3.0])
    assert port_utils.calculate_generalized_mean(torch.from_numpy(x), p) == jax_utils.calculate_generalized_mean(x, p)


def test_expected_mutual_information_in_small_chunks(monkeypatch):
    """Chunks of a few terms and blocks of a few pairs give the one-chunk sum."""
    preds, target = LABELS_P.reshape(-1), LABELS_T.reshape(-1)
    cells = port_utils._contingency_cells(torch.from_numpy(preds), torch.from_numpy(target))
    whole = port_extrinsic.expected_mutual_info_score(cells, preds.size)
    monkeypatch.setattr(port_extrinsic, "_CHUNK_BYTES", 64 * port_extrinsic._TERM_BYTES)
    monkeypatch.setattr(port_extrinsic, "_PAIR_BLOCK", 7)
    np.testing.assert_allclose(port_extrinsic.expected_mutual_info_score(cells, preds.size), whole, rtol=1e-13)


def test_term_chunks_take_whole_pairs_greedily():
    ends = np.cumsum([3, 0, 4, 10, 1, 1, 2])
    chunks = list(port_extrinsic._term_chunks(ends, 5))
    assert chunks == [(0, 2, 3), (2, 3, 4), (3, 4, 10), (4, 7, 4)]
    assert sum(c[2] for c in chunks) == ends[-1]


@pytest.mark.parametrize("preds, target", [(np.asarray([0.5, 1.0]), np.asarray([0, 1])),
                                           (np.asarray([np.nan, 1.0]), np.asarray([0, 1])),
                                           (np.asarray([1, 0]), np.asarray([np.inf, 1.0])),
                                           (np.asarray([True, False]), np.asarray([0, 1]))],
                         ids=["fraction", "nan", "inf", "bool"])
def test_check_cluster_labels_rejects_what_the_jax_package_rejects(preds, target):
    with pytest.raises(ValueError, match="Expected real, discrete values"):
        jax_utils.check_cluster_labels(preds, target)
    with pytest.raises(ValueError, match="Expected real, discrete values"):
        port_utils.check_cluster_labels(torch.from_numpy(preds), torch.from_numpy(target))


# ------------------------------------------------------------------ the functions

@pytest.mark.parametrize("name", EXTRINSIC)
@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_extrinsic_functions_match_the_jax_package(name, case):
    preds, target = LABEL_CASES[case]
    jax_out, port_out = _both(name, preds, target)
    _close(port_out, jax_out, f"{name} {case}", absolute=name == "adjusted_mutual_info_score")


@pytest.mark.parametrize("average_method", ["min", "geometric", "max"])
@pytest.mark.parametrize("name", ["adjusted_mutual_info_score", "normalized_mutual_info_score"])
def test_average_methods(name, average_method):
    jax_out, port_out = _both(name, LABELS_P[1], LABELS_T[1], average_method=average_method)
    _close(port_out, jax_out, name, absolute=name == "adjusted_mutual_info_score")


def test_v_measure_beta_and_empty_target():
    jax_out, port_out = _both("v_measure_score", LABELS_P[2], LABELS_T[2], beta=0.5)
    _close(port_out, jax_out)
    empty = np.zeros(0, np.int64)
    for name in ("homogeneity_score", "completeness_score", "v_measure_score", "mutual_info_score"):
        jax_out, port_out = _both(name, empty, empty)
        _close(port_out, jax_out, name)


@pytest.mark.parametrize("case", ["batch0", "all", "identical"])
def test_cluster_accuracy_matches_the_jax_package(case):
    preds, target = LABEL_CASES[case]
    jax_out, port_out = _both("cluster_accuracy", preds, target, num_classes=5)
    _close(port_out, jax_out)


def test_functions_read_int64_labels_without_the_states_wrap():
    """The functions take the labels as they are: 2**33 is a label of its own."""
    preds, target = np.asarray([2**33, 1, 0]), np.asarray([0, 1, 1])
    jax_out, port_out = _both("mutual_info_score", preds, target)
    _close(port_out, jax_out)
    assert abs(float(port_out) - 0.6365142) < 1e-6


@pytest.mark.parametrize("p", [1, 2, 3, float("inf")])
@pytest.mark.parametrize("batch", [0, 3])
def test_intrinsic_functions_match_the_jax_package(batch, p):
    for name in INTRINSIC:
        kw = {"p": p} if name == "dunn_index" else {}
        if p != 2 and not kw:
            continue
        jax_out, port_out = _both(name, DATA[batch], LABELS_T[batch], **kw)
        _close(port_out, jax_out, name)


def test_intrinsic_degenerate_clusters():
    """Clusters of one repeated point: zero spread (Davies-Bouldin 0, Calinski-Harabasz
    1 when nothing spreads), integer data taken as float64 as in the JAX package."""
    data = np.repeat(np.asarray([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]]), 4, axis=0)
    labels = np.repeat(np.arange(3), 4)
    for name in INTRINSIC:
        jax_out, port_out = _both(name, data, labels)
        _close(port_out, jax_out, name)
        jax_out, port_out = _both(name, data.astype(np.int64), labels)
        _close(port_out, jax_out, f"{name} int data")


def test_intrinsic_in_row_blocks(monkeypatch):
    """Blocks of a few rows give the one-block values."""
    args = (torch.from_numpy(DATA.reshape(-1, 3)), torch.from_numpy(LABELS_T.reshape(-1)))
    whole = [getattr(port_fn, name)(*args) for name in INTRINSIC]
    monkeypatch.setattr(port_pairwise_helpers, "_CHUNK_BYTES", 200)
    for name, want in zip(INTRINSIC, whole):
        _close(getattr(port_fn, name)(*args), want, name)


@pytest.mark.parametrize(
    "call",
    [
        lambda f, a: f.calinski_harabasz_score(a(DATA[0][:, 0]), a(LABELS_T[0])),
        lambda f, a: f.davies_bouldin_score(a(DATA[0]), a(LABELS_T[:2])),
        lambda f, a: f.dunn_index(a(DATA[0]), a(np.zeros(BATCH, np.int64))),
        lambda f, a: f.calinski_harabasz_score(a(DATA[0][:3]), a(np.arange(3))),
        lambda f, a: f.adjusted_mutual_info_score(a(LABELS_P[0]), a(LABELS_T[0]), average_method="median"),
        lambda f, a: f.mutual_info_score(a(LABELS_P[0]), a(LABELS_T[0] + 0.5)),
    ],
    ids=["data_1d", "labels_2d", "one_cluster", "every_sample_a_cluster", "average_method", "fractional"],
)
def test_function_errors_like_the_jax_package(call):
    with pytest.raises(ValueError) as jax_err:
        call(jax_fn, jnp.asarray)
    with pytest.raises(ValueError) as port_err:
        call(port_fn, torch.from_numpy)
    if "Expected real, discrete" not in str(jax_err.value):  # the dtypes print as numpy's and torch's names
        assert str(port_err.value) == str(jax_err.value)


def test_shape_mismatch_raises_runtime_error_like_the_jax_package():
    with pytest.raises(RuntimeError):
        jax_fn.rand_score(jnp.zeros(3), jnp.zeros(4))
    with pytest.raises(RuntimeError):
        port_fn.rand_score(torch.zeros(3), torch.zeros(4))


# --------------------------------------------------------------------- the classes

def _feed(jax_metric, port_metric, inputs) -> None:
    for args in inputs:
        jax_metric.update(*[jnp.asarray(a) for a in args])
        port_metric.update(*[torch.from_numpy(np.asarray(a)) for a in args])


def _inputs(name: str):
    if name in INTRINSIC:
        return [(DATA[i], LABELS_T[i]) for i in range(NUM_BATCHES)]
    return [(LABELS_P[i], LABELS_T[i]) for i in range(NUM_BATCHES)]


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_classes_match_the_jax_package(name):
    cls = CLASSES[name]
    jax_metric, port_metric = getattr(jtm, cls)(), getattr(ttm, cls)(**CPU)
    assert port_metric._jittable_compute is jax_metric._jittable_compute is False
    assert port_metric.full_state_update is True
    _feed(jax_metric, port_metric, _inputs(name))
    for key in port_metric._state:
        got = torch.cat(port_metric._state[key])
        _bitwise(got, np.concatenate([np.asarray(x) for x in jax_metric._state[key]]), key)
    _close(port_metric.compute(), jax_metric.compute(), cls, absolute=cls == "AdjustedMutualInfoScore")
    # forward gives the batch's own value; merge of two halves gives the whole's
    first = _inputs(name)[0]
    fresh = getattr(ttm, cls)(**CPU)
    batch_value = fresh(*[torch.from_numpy(np.asarray(a)) for a in first])
    _close(batch_value, getattr(jax_fn, name)(*[jnp.asarray(a) for a in first]), f"{cls} forward",
           absolute=cls == "AdjustedMutualInfoScore")
    a, b = getattr(ttm, cls)(**CPU), getattr(ttm, cls)(**CPU)
    for i, args in enumerate(_inputs(name)):
        (a if i < 2 else b).update(*[torch.from_numpy(np.asarray(x)) for x in args])
    a.merge_state(b)
    _bitwise(a.compute(), port_metric.compute(), f"{cls} merged")


def test_label_states_wrap_int64_to_int32_in_both_packages():
    """JAX-side quirk kept: a class state holds labels as ``jnp.asarray`` makes them, so a
    label of 2**33 wraps to 0 and meets the label 0; the functions do not wrap."""
    preds, target = np.asarray([2**33, 1, 0]), np.asarray([0, 1, 1])
    jax_metric, port_metric = jtm.MutualInfoScore(), ttm.MutualInfoScore(**CPU)
    _feed(jax_metric, port_metric, [(preds, target)])
    _bitwise(port_metric.preds[0], np.asarray(jax_metric._state["preds"][0]), "wrapped preds")
    assert port_metric.preds[0].tolist() == [0, 1, 0]
    _close(port_metric.compute(), jax_metric.compute())
    assert abs(float(port_metric.compute()) - 0.17441605) < 1e-6


def test_float64_data_states_are_float32():
    jax_metric, port_metric = jtm.DunnIndex(), ttm.DunnIndex(**CPU)
    _feed(jax_metric, port_metric, [(DATA[0].astype(np.float64), LABELS_T[0])])
    assert port_metric.data[0].dtype == torch.float32 and port_metric.labels[0].dtype == torch.int32
    _close(port_metric.compute(), jax_metric.compute())


def test_cluster_accuracy_class():
    jax_metric, port_metric = jtm.ClusterAccuracy(5), ttm.ClusterAccuracy(5, **CPU)
    assert port_metric.confmat.dtype == torch.int32 and port_metric.confmat.shape == (5, 5)
    _feed(jax_metric, port_metric, _inputs("rand_score"))
    _bitwise(port_metric.confmat, jax_metric._state["confmat"], "confmat")
    _close(port_metric.compute(), jax_metric.compute())
    jax_metric.persistent(True)
    restored = ttm.ClusterAccuracy(5, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _bitwise(restored.confmat, jax_metric._state["confmat"], "restored")
    with pytest.raises(StateCorruptionError):
        ttm.ClusterAccuracy(4, **CPU).load_state_dict(jax_metric.state_dict())
    for preds in (np.asarray([0, 5]), np.asarray([-1, 2])):
        with pytest.raises(ValueError) as jax_err:
            jtm.ClusterAccuracy(5).update(jnp.asarray(preds), jnp.asarray([0, 1]))
        with pytest.raises(ValueError) as port_err:
            ttm.ClusterAccuracy(5, **CPU).update(torch.from_numpy(preds), torch.tensor([0, 1]))
        assert str(port_err.value) == str(jax_err.value)


def test_jax_label_states_load_into_the_port():
    jax_metric = jtm.AdjustedRandScore()
    jax_metric.persistent(True)
    _feed(jax_metric, ttm.AdjustedRandScore(**CPU), _inputs("adjusted_rand_score"))
    port_metric = ttm.AdjustedRandScore(**CPU)
    port_metric.load_state_dict(jax_metric.state_dict())
    _close(port_metric.compute(), jax_metric.compute())


@pytest.mark.parametrize(
    "build",
    [
        lambda m, **d: m.VMeasureScore(beta=1, **d),
        lambda m, **d: m.VMeasureScore(beta=-0.5, **d),
        lambda m, **d: m.AdjustedMutualInfoScore(average_method="median", **d),
        lambda m, **d: m.NormalizedMutualInfoScore(average_method="mode", **d),
        lambda m, **d: m.ClusterAccuracy(num_classes=0, **d),
    ],
    ids=["beta_int", "beta_negative", "ami_average", "nmi_average", "num_classes"],
)
def test_constructor_errors_like_the_jax_package(build):
    with pytest.raises(ValueError) as jax_err:
        build(jtm)
    with pytest.raises(ValueError) as port_err:
        build(ttm, **CPU)
    assert str(port_err.value) == str(jax_err.value)


def test_exports_equal_the_jax_packages():
    import torchmetrics_tpu.clustering as jax_clustering
    import torchmetrics_tpu.shape as jax_shape
    import torchmetrics_tpu_torch.clustering as port_clustering
    import torchmetrics_tpu_torch.shape as port_shape

    for port_module, jax_module in ((port_clustering, jax_clustering), (port_shape, jax_shape),
                                    (port_fn.clustering, jax_fn.clustering), (port_fn.pairwise, jax_fn.pairwise),
                                    (port_fn.shape, jax_fn.shape)):
        assert port_module.__all__ == jax_module.__all__
        for name in port_module.__all__:
            assert name in (ttm.__all__ if port_module in (port_clustering, port_shape) else port_fn.__all__)
    for name in port_clustering.__all__ + port_shape.__all__:
        assert getattr(ttm, name) is getattr(port_clustering if name in port_clustering.__all__ else port_shape, name)
    import inspect

    for port_module, jax_module in ((port_fn, jax_fn), (ttm, jtm)):
        for name in (port_clustering.__all__ + port_shape.__all__ + ttm.nominal.__all__ if port_module is ttm else
                     port_fn.clustering.__all__ + port_fn.nominal.__all__ + port_fn.pairwise.__all__
                     + port_fn.shape.__all__):
            port_sig = inspect.signature(getattr(port_module, name))
            jax_sig = inspect.signature(getattr(jax_module, name))
            assert list(port_sig.parameters) == list(jax_sig.parameters), name
            assert [p.default for p in port_sig.parameters.values()] == [p.default for p in jax_sig.parameters.values()]
