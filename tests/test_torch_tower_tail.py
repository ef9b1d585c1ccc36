"""The port's calibration error, hinge loss, multilabel ranking metrics and group fairness
against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function or class and the
port's counterpart. Tolerances:

- integer states, and float sums of integers (calibration's weight and accuracy sums,
  coverage error's depths), equal bit for bit;
- other float sums (calibration's confidence sums, hinge and ranking measures) within
  ``SUM_RTOL`` relative: the JAX package adds in float32 in its own order, the port in
  float64 rounded once;
- values within ``VALUE_ATOL`` absolute or ``VALUE_RTOL`` relative;
- dict keys (group fairness's argmin/argmax groups) equal.
"""

from __future__ import annotations

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import classification as jax_cls
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu_torch import classification as port_cls
from torchmetrics_tpu_torch import functional as port_fn

port_ce = importlib.import_module("torchmetrics_tpu_torch.functional.classification.calibration_error")
port_ranking = importlib.import_module("torchmetrics_tpu_torch.functional.classification.ranking")

VALUE_ATOL = 1e-6
VALUE_RTOL = 1e-6
SUM_RTOL = 1e-5  # a float32 sum of up to ~200 terms, added in another order
N, C = 96, 5
EXACT_STATES = {"count_bin", "acc_bin", "total", "tp", "fp", "tn", "fn"}


def _assert_same(got, want, rtol: float = VALUE_RTOL, bitwise: bool = False) -> None:
    """Same structure, shape and dtype; integers (or ``bitwise``) equal bit for bit,
    floats within the tolerance, NaN in the same places."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (list(got), list(want))
        for key in want:
            _assert_same(got[key], want[key], rtol, bitwise)
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w, rtol, bitwise)
        return
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor)
    got = got.cpu().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if bitwise or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got.view(f"u{got.dtype.itemsize}"), want.view(f"u{want.dtype.itemsize}"))
    else:
        np.testing.assert_allclose(got, want, atol=VALUE_ATOL, rtol=rtol)


def _assert_states(port_metric, jax_metric) -> None:
    for name, want in jax_metric._state.items():
        exact = name in EXACT_STATES or (name == "measure" and type(port_metric).__name__ == "MultilabelCoverageError")
        _assert_same(port_metric._state[name], np.asarray(want), rtol=SUM_RTOL, bitwise=exact)


def _binary(rng, kind: str, n: int = N, ignore_index=None):
    """(preds, target): ``probs`` in [0, 1], ``logits`` (sigmoid needed), ``ties`` in quarters."""
    if kind == "logits":
        preds = 2 * rng.normal(size=n)
    elif kind == "ties":
        preds = rng.integers(0, 5, n) / 4
    else:
        preds = rng.uniform(size=n)
    target = (rng.uniform(size=n) < np.clip(preds if kind != "logits" else 1 / (1 + np.exp(-preds)), 0.1, 0.9))
    target = target.astype(np.int64)
    if ignore_index is not None:
        target = np.where(rng.uniform(size=n) < 0.2, ignore_index, target)
    return preds.astype(np.float32), target


def _multiclass(rng, kind: str, n: int = N, c: int = C, ignore_index=None):
    """(preds, target): ``probs`` softmax rows that lean to the target, ``logits``, ``ties``
    (rows in quarters, tied maxima)."""
    target = rng.integers(0, c, n)
    logits = rng.normal(size=(n, c))
    logits[np.arange(n), target] += 1.0
    if kind == "logits":
        preds = logits
    elif kind == "ties":
        preds = rng.integers(0, 3, (n, c)) / 4
    else:
        preds = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    if ignore_index is not None:
        target = np.where(rng.uniform(size=n) < 0.2, ignore_index, target)
    return preds.astype(np.float32), target.astype(np.int64)


def _multilabel(rng, kind: str, n: int = N, c: int = C, ignore_index=None):
    target = rng.integers(0, 2, (n, c))
    if kind == "logits":
        preds = 2 * rng.normal(size=(n, c)) + target
    elif kind == "ties":
        preds = rng.integers(0, 4, (n, c)) / 4
    else:
        preds = np.clip(0.3 * target + 0.7 * rng.uniform(size=(n, c)), 0, 1)
    if ignore_index is not None:
        target = np.where(rng.uniform(size=(n, c)) < 0.15, ignore_index, target)
    return preds.astype(np.float32), target.astype(np.int64)


def _call(fn_jax, fn_port, arrays, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fn_jax(*(jnp.asarray(a) for a in arrays), **kwargs)
        got = fn_port(*(torch.from_numpy(a) for a in arrays), **kwargs)
    return got, want


# ------------------------------------------------------------ calibration


@pytest.mark.parametrize("n_bins", [15, 100])
def test_bin_edges_are_jnp_linspace_bit_for_bit(n_bins):
    want = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
    got = port_ce._bin_boundaries(n_bins, torch.device("cpu"))
    _assert_same(got, want, bitwise=True)
    # the trap: torch.linspace's edges differ in bits
    assert not torch.equal(torch.linspace(0, 1, n_bins + 1).view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("n_bins", [15, 100])
def test_confidences_on_the_bin_edges_fall_in_the_jax_bins(n_bins):
    """Every confidence lies on one of jnp's edges, or on one of ``torch.linspace``'s or
    ``np.linspace``'s where those differ from jnp's by an ulp: the bin counts equal the
    JAX package's bit for bit, where ``torch.linspace``'s edges would move some of them."""
    edges = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
    rng = np.random.default_rng(n_bins)
    preds = np.repeat(np.concatenate([edges, torch.linspace(0, 1, n_bins + 1).numpy(),
                                      np.linspace(0, 1, n_bins + 1, dtype=np.float32)]), 2)
    target = rng.integers(0, 2, preds.size)
    p, t, w = port_ce._binary_calibration_error_format(torch.from_numpy(preds), torch.from_numpy(target))
    got = port_ce._binned_stats_update(p, t, n_bins, w)
    jax_ce = importlib.import_module("torchmetrics_tpu.functional.classification.calibration_error")
    jp, jt, jw = jax_ce._binary_calibration_error_format(jnp.asarray(preds), jnp.asarray(target))
    want = jax_ce._binned_stats_update(jp, jt, n_bins, jw)
    _assert_same(got[2], want[2], bitwise=True)
    _assert_same(got[1], want[1], bitwise=True)
    _assert_same(got[0], want[0], rtol=SUM_RTOL)
    linspace_bins = torch.searchsorted(torch.linspace(0, 1, n_bins + 1), torch.from_numpy(preds), right=True)
    port_bins = torch.searchsorted(port_ce._bin_boundaries(n_bins, torch.device("cpu")), torch.from_numpy(preds),
                                   right=True)
    assert not torch.equal(linspace_bins, port_bins)
    for norm in ("l1", "l2", "max"):
        _assert_same(*_call(jax_fn.binary_calibration_error, port_fn.binary_calibration_error, (preds, target),
                            n_bins=n_bins, norm=norm))


# (task, kind, n_bins, norm, ignore_index)
CE_CASES = [
    ("binary", "probs", 15, "l1", None), ("binary", "logits", 10, "l2", None), ("binary", "ties", 4, "max", -1),
    ("binary", "probs", 100, "l1", 255), ("multiclass", "probs", 15, "l1", None),
    ("multiclass", "logits", 15, "max", -1), ("multiclass", "ties", 7, "l2", None),
    ("multiclass", "probs", 100, "l2", 255),
]


@pytest.mark.parametrize("task, kind, n_bins, norm, ignore_index", CE_CASES)
def test_calibration_error_functional_matches_jax(task, kind, n_bins, norm, ignore_index):
    rng = np.random.default_rng(CE_CASES.index((task, kind, n_bins, norm, ignore_index)))
    arrays = (_binary if task == "binary" else _multiclass)(rng, kind, ignore_index=ignore_index)
    kwargs = {"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index}
    if task == "multiclass":
        kwargs["num_classes"] = C
    _assert_same(*_call(getattr(jax_fn, f"{task}_calibration_error"), getattr(port_fn, f"{task}_calibration_error"),
                        arrays, **kwargs))
    _assert_same(*_call(jax_fn.calibration_error, port_fn.calibration_error, arrays, task=task, **kwargs))


def _run_classes(jax_metric, build_port, batches):
    """Two batches into a port metric, the third into a second one merged into it; all
    three into ``jax_metric``; then a ``state_dict`` round trip into a third."""
    port_metric, other = build_port(), build_port()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, arrays in enumerate(batches):
            jax_metric.update(*(jnp.asarray(a) for a in arrays))
            (port_metric if i < 2 else other).update(*(torch.from_numpy(a) for a in arrays))
        port_metric.merge_state(other)
        _assert_states(port_metric, jax_metric)
        want = jax_metric.compute()
        _assert_same(port_metric.compute(), want)
        restored = build_port()
        restored.persistent(True)
        port_metric.persistent(True)
        restored.load_state_dict(port_metric.state_dict())
        _assert_same(restored.compute(), want)


@pytest.mark.parametrize("task, kind, n_bins, norm, ignore_index", CE_CASES[::2])
def test_calibration_error_classes_match_jax(task, kind, n_bins, norm, ignore_index):
    kwargs = {"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index}
    if task == "multiclass":
        kwargs["num_classes"] = C
    make = _binary if task == "binary" else _multiclass
    batches = [make(np.random.default_rng(50 + i), kind, n=N // 2, ignore_index=ignore_index) for i in range(3)]
    _run_classes(jax_cls.CalibrationError(task=task, **kwargs),
                 lambda: port_cls.CalibrationError(task=task, **kwargs, device="cpu"), batches)


# ------------------------------------------------------------------ hinge

# (task, kind, squared, mode, ignore_index)
HINGE_CASES = [
    ("binary", "probs", False, None, None), ("binary", "logits", True, None, -1), ("binary", "ties", False, None, 255),
    ("multiclass", "probs", False, "crammer-singer", None), ("multiclass", "logits", True, "crammer-singer", -1),
    ("multiclass", "ties", False, "crammer-singer", None), ("multiclass", "probs", False, "one-vs-all", 255),
    ("multiclass", "logits", True, "one-vs-all", None), ("multiclass", "ties", False, "one-vs-all", -1),
]


def _hinge_kwargs(task, squared, mode, ignore_index) -> dict:
    kwargs = {"squared": squared, "ignore_index": ignore_index}
    if task == "multiclass":
        kwargs.update(num_classes=C, multiclass_mode=mode)
    return kwargs


@pytest.mark.parametrize("task, kind, squared, mode, ignore_index", HINGE_CASES)
def test_hinge_loss_functional_matches_jax(task, kind, squared, mode, ignore_index):
    rng = np.random.default_rng(10 + HINGE_CASES.index((task, kind, squared, mode, ignore_index)))
    arrays = (_binary if task == "binary" else _multiclass)(rng, kind, ignore_index=ignore_index)
    kwargs = _hinge_kwargs(task, squared, mode, ignore_index)
    got, want = _call(getattr(jax_fn, f"{task}_hinge_loss"), getattr(port_fn, f"{task}_hinge_loss"), arrays, **kwargs)
    _assert_same(got, want)
    assert got.shape == ((C,) if mode == "one-vs-all" else ())
    _assert_same(*_call(jax_fn.hinge_loss, port_fn.hinge_loss, arrays, task=task, **kwargs))


@pytest.mark.parametrize("task, kind, squared, mode, ignore_index", HINGE_CASES[1::2])
def test_hinge_loss_classes_match_jax(task, kind, squared, mode, ignore_index):
    kwargs = _hinge_kwargs(task, squared, mode, ignore_index)
    make = _binary if task == "binary" else _multiclass
    batches = [make(np.random.default_rng(60 + i), kind, n=N // 2, ignore_index=ignore_index) for i in range(3)]
    _run_classes(jax_cls.HingeLoss(task=task, **kwargs), lambda: port_cls.HingeLoss(task=task, **kwargs, device="cpu"),
                 batches)


def test_multiclass_hinge_clips_out_of_range_targets_after_ignore_index():
    """``ignore_index`` first (those rows weigh 0), then targets clipped into the classes."""
    preds, _ = _multiclass(np.random.default_rng(3), "probs", n=8)
    target = np.array([0, 1, 7, 4, -1, 2, 3, 7])
    for mode in ("crammer-singer", "one-vs-all"):
        _assert_same(*_call(jax_fn.multiclass_hinge_loss, port_fn.multiclass_hinge_loss, (preds, target),
                            num_classes=C, multiclass_mode=mode, ignore_index=7, validate_args=False))


# ---------------------------------------------------------------- ranking

RANKING = ["coverage_error", "ranking_average_precision", "ranking_loss"]
RANKING_CLASSES = {"coverage_error": "MultilabelCoverageError",
                   "ranking_average_precision": "MultilabelRankingAveragePrecision",
                   "ranking_loss": "MultilabelRankingLoss"}


def _edge_rows(rng, c: int = C):
    """Rows with every label relevant, none relevant, all scores tied, and ties across
    relevant and irrelevant labels, after ordinary rows."""
    preds, target = _multilabel(rng, "probs", n=12, c=c)
    target[0], target[1] = 1, 0
    preds[2] = 0.5
    preds[3] = [0.25, 0.75, 0.25, 0.75, 0.5][:c]
    target[3] = [1, 0, 0, 1, 1][:c]
    return preds, target


@pytest.mark.parametrize("metric", RANKING)
@pytest.mark.parametrize("kind, ignore_index", [("probs", None), ("logits", -1), ("ties", 255), ("edges", None)])
def test_ranking_functional_matches_jax(metric, kind, ignore_index):
    rng = np.random.default_rng(20 + RANKING.index(metric))
    arrays = _edge_rows(rng) if kind == "edges" else _multilabel(rng, kind, ignore_index=ignore_index)
    got, want = _call(getattr(jax_fn, f"multilabel_{metric}"), getattr(port_fn, f"multilabel_{metric}"), arrays,
                      num_labels=C, ignore_index=ignore_index)
    _assert_same(got, want)


@pytest.mark.parametrize("metric", RANKING)
def test_ranking_chunks_give_the_unchunked_bits(metric, monkeypatch):
    """Chunks of 3 samples (the default would take them all at once) give the same
    states bit for bit."""
    preds, target = (torch.from_numpy(a) for a in _multilabel(np.random.default_rng(7), "ties", n=40))
    update = getattr(port_ranking, f"_multilabel_{metric}_update")
    whole = update(preds, target.to(torch.int32))
    monkeypatch.setattr(port_ranking, "_PAIR_ENTRIES", 3 * C * C)
    assert len(port_ranking._row_chunks(40, C)) == 14
    _assert_same(update(preds, target.to(torch.int32)), [t.numpy() for t in whole], bitwise=True)


@pytest.mark.parametrize("metric", RANKING)
def test_ranking_classes_match_jax(metric):
    batches = [_multilabel(np.random.default_rng(70 + i), "ties", n=N // 2, ignore_index=-1) for i in range(3)]
    name = RANKING_CLASSES[metric]
    kwargs = {"num_labels": C, "ignore_index": -1}
    _run_classes(getattr(jax_cls, name)(**kwargs), lambda: getattr(port_cls, name)(**kwargs, device="cpu"), batches)


# -------------------------------------------------------------- fairness

GROUPS = 4


def _fairness_inputs(rng, n: int = N, groups: int = GROUPS, ignore_index=None, skew: bool = True):
    preds, target = _binary(rng, "probs", n=n, ignore_index=ignore_index)
    p = np.arange(1, groups + 1, dtype=np.float64) if skew else np.ones(groups)
    group = rng.choice(groups, size=n, p=p / p.sum())
    return preds, target, group.astype(np.int64)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_fairness_functional_matches_jax(threshold, ignore_index):
    preds, target, groups = _fairness_inputs(np.random.default_rng(30), ignore_index=ignore_index)
    kwargs = {"threshold": threshold, "ignore_index": ignore_index}
    _assert_same(*_call(jax_fn.binary_groups_stat_rates, port_fn.binary_groups_stat_rates, (preds, target, groups),
                        num_groups=GROUPS, **kwargs))
    _assert_same(*_call(jax_fn.equal_opportunity, port_fn.equal_opportunity, (preds, target, groups), **kwargs))
    _assert_same(*_call(jax_fn.demographic_parity, port_fn.demographic_parity, (preds, groups), **kwargs))
    for task in ("demographic_parity", "equal_opportunity", "all"):
        _assert_same(*_call(jax_fn.binary_fairness, port_fn.binary_fairness, (preds, target, groups), task=task,
                            **kwargs))


def test_fairness_ties_pick_the_first_group_in_the_keys():
    """Groups 0, 1 and 2 share the lowest positive rate and groups 0, 2 and 3 the highest
    true positive rate: the keys name the first of each, as in the JAX package."""
    preds = np.array([0.9, 0.1, 0.9, 0.1, 0.1, 0.9, 0.1, 0.9, 0.9, 0.9, 0.9, 0.1], np.float32)
    target = np.array([1, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1, 0])
    groups = np.array([0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 3])
    got, want = _call(jax_fn.binary_fairness, port_fn.binary_fairness, (preds, target, groups))
    assert list(want) == ["DP_0_3", "EO_1_0"]
    _assert_same(got, want)


def test_fairness_classes_with_a_group_absent_from_a_batch():
    """Batch 2 holds no sample of group 3; the states stay int32 and equal bit for bit."""
    batches = [_fairness_inputs(np.random.default_rng(80 + i), n=N // 2) for i in range(3)]
    batches[1] = tuple(a[batches[1][2] != 3] for a in batches[1])
    for jax_name, kwargs in (("BinaryGroupStatRates", {}), ("BinaryFairness", {"task": "all"}),
                             ("BinaryFairness", {"task": "equal_opportunity", "threshold": 0.4})):
        _run_classes(getattr(jax_cls, jax_name)(GROUPS, **kwargs),
                     lambda: getattr(port_cls, jax_name)(GROUPS, **kwargs, device="cpu"), batches)


def test_demographic_parity_class_needs_no_target():
    preds, _, groups = _fairness_inputs(np.random.default_rng(5))
    jax_metric = jax_cls.BinaryFairness(GROUPS, task="demographic_parity")
    port_metric = port_cls.BinaryFairness(GROUPS, task="demographic_parity", device="cpu")
    jax_metric.update(jnp.asarray(preds), groups=jnp.asarray(groups))
    port_metric.update(torch.from_numpy(preds), groups=torch.from_numpy(groups))
    _assert_states(port_metric, jax_metric)
    _assert_same(port_metric.compute(), jax_metric.compute())


# ------------------------------------------------------------ validation


def test_validation_errors_match_jax():
    preds, target = torch.rand(8), torch.tensor([0, 1, 1, 0, 1, 0, 1, 0])
    for pkg, kwargs in ((jax_cls, {}), (port_cls, {"device": "cpu"})):
        with pytest.raises(ValueError, match="`n_bins` to be an integer larger than 0"):
            pkg.BinaryCalibrationError(n_bins=0, **kwargs)
        with pytest.raises(ValueError, match="`norm` to be one of"):
            pkg.MulticlassCalibrationError(3, norm="l3", **kwargs)
        with pytest.raises(ValueError, match="`multiclass_mode`"):
            pkg.MulticlassHingeLoss(3, multiclass_mode="all", **kwargs)
        with pytest.raises(ValueError, match="`squared` to be an bool"):
            pkg.BinaryHingeLoss(squared=1, **kwargs)
        with pytest.raises(ValueError, match="`num_groups` to be an int larger than 1"):
            pkg.BinaryFairness(1, **kwargs)
        with pytest.raises(ValueError, match="``demographic_parity``"):
            pkg.BinaryFairness(2, task="parity", **kwargs)
        with pytest.raises(ValueError, match="Invalid"):
            pkg.CalibrationError(task="multilabel", **kwargs)
    with pytest.raises(ValueError, match="out of range for the specified number of groups"):
        port_fn.binary_groups_stat_rates(preds, target, torch.tensor([0, 1, 2, 0, 1, 2, 0, 1]), 2)
    with pytest.raises(ValueError, match="dtype of argument groups to be integer"):
        port_fn.binary_groups_stat_rates(preds, target, torch.zeros(8), 2)
    with pytest.raises(ValueError, match="floating point"):
        port_fn.multilabel_ranking_loss(torch.ones(4, 3, dtype=torch.int64), torch.ones(4, 3, dtype=torch.int64), 3)


@pytest.mark.parametrize("module", ["calibration_error", "hinge", "ranking", "group_fairness"])
@pytest.mark.parametrize("package", ["functional.classification", "classification"])
def test_public_names_match_jax_at_the_same_paths(package, module):
    """Every public function or class of the JAX module exists in the port's module of the
    same path, and in the port's package and top level wherever the JAX package exports it."""
    import inspect

    jax_module = importlib.import_module(f"torchmetrics_tpu.{package}.{module}")
    port_module = importlib.import_module(f"torchmetrics_tpu_torch.{package}.{module}")
    names = [n for n, v in vars(jax_module).items() if not n.startswith("_") and inspect.getmodule(v) is jax_module]
    assert names
    for name in names:
        assert hasattr(port_module, name), name
        for jax_pkg, port_pkg in ((f"torchmetrics_tpu.{package}", f"torchmetrics_tpu_torch.{package}"),
                                  ("torchmetrics_tpu.functional", "torchmetrics_tpu_torch.functional"),
                                  ("torchmetrics_tpu", "torchmetrics_tpu_torch")):
            if hasattr(importlib.import_module(jax_pkg), name):
                assert hasattr(importlib.import_module(port_pkg), name), (port_pkg, name)
