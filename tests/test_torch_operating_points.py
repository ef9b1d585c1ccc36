"""The port's EER, LogAUC and four operating points (precision at fixed recall, recall at
fixed precision, sensitivity at specificity, specificity at sensitivity) against the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function or class and the
port's counterpart. Chosen thresholds equal the JAX package's bit for bit where they are
taken from the state (binned thresholds, and the scores of an exact curve that needed
no activation); the thresholds of scores that went through the batch-wide sigmoid or
softmax are the activation's values, which PyTorch and XLA round differently in the last
place, and like every other value they are held within ``VALUE_ATOL`` absolute or
``VALUE_RTOL`` relative, NaN where the JAX package has NaN.
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

jax_op = importlib.import_module("torchmetrics_tpu.functional.classification._operating_point")
jax_ss = importlib.import_module("torchmetrics_tpu.functional.classification.sensitivity_specificity")
port_op = importlib.import_module("torchmetrics_tpu_torch.functional.classification._operating_point")

VALUE_ATOL = 1e-6
VALUE_RTOL = 1e-6
N, C = 50, 4
UNSORTED = [0.75, 0.25, 0.5, 0.25, 1.0, 0.0]


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(f"u{x.dtype.itemsize}")


def _assert_same(got, want, bitwise: bool = False) -> None:
    """Same structure, shapes and dtypes; floats within the tolerance with NaN in the same
    places, or bit for bit when ``bitwise``."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w, bitwise)
        return
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor)
    got = got.cpu().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if bitwise:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got, want, atol=VALUE_ATOL, rtol=VALUE_RTOL)


def _assert_point(got, want, bitwise_threshold: bool) -> None:
    """An operating point (value, threshold): the threshold bit for bit when asked."""
    assert isinstance(got, tuple) and len(got) == 2
    _assert_same(got[0], want[0])
    _assert_same(got[1], want[1], bitwise=bitwise_threshold)


def _scores(rng, kind: str, shape) -> np.ndarray:
    """float32 scores: ``probs`` in [0, 1], ``logits`` (activation needed), ``ties`` in
    quarters, ``thousandths`` rounded to 0.001."""
    if kind == "logits":
        return (2 * rng.normal(size=shape)).astype(np.float32)
    if kind == "ties":
        return (rng.integers(0, 5, shape) / 4).astype(np.float32)
    preds = rng.uniform(size=shape).astype(np.float32)
    if kind == "thousandths":
        return (np.round(preds * 1000) / 1000).astype(np.float32)
    return preds


def _data(task: str, kind: str, ignore_index, absent: bool, seed: int, n: int = N):
    """(preds, target). ``absent``: binary and multilabel, a target (label 0) without
    positives; multiclass, a class that never occurs."""
    rng = np.random.default_rng(seed)
    if task == "multiclass":
        preds = _scores(rng, kind, (n, C))
        target = rng.integers(0, C - 1 if absent else C, n)
    else:
        shape = (n,) if task == "binary" else (n, C)
        preds = _scores(rng, kind, shape)
        target = rng.integers(0, 2, shape)
        if absent:
            target[(...) if task == "binary" else (slice(None), 0)] = 0
    if ignore_index is not None:  # every fifth entry of each label: the kept shapes repeat, and JAX's compiles with them
        ignored = (np.arange(n)[:, None] + np.arange(C)[None, :])[:, : C if task == "multilabel" else 1] % 5 == 0
        target = np.where(ignored.reshape(target.shape), ignore_index, target)
    return preds, target.astype(np.int64)


def _thresholds(spec):
    if isinstance(spec, np.ndarray):
        return jnp.asarray(spec), torch.from_numpy(spec)
    return spec, spec


# (task, kind, thresholds, ignore_index, absent); the even and the odd cases each hold
# an exact and a binned case of every task
CASES = {
    "b-ties-exact-ign": ("binary", "ties", None, -1, False),
    "b-logits-int": ("binary", "logits", 9, None, False),
    "b-ties-list": ("binary", "ties", UNSORTED, 255, False),
    "b-absent-exact": ("binary", "ties", None, None, True),
    "mc-ties-exact": ("multiclass", "ties", None, None, False),
    "mc-ties-tensor": ("multiclass", "ties", np.array([0.1, 0.3, 0.6, 0.9], np.float32), None, False),
    "mc-thousandths-int-ign": ("multiclass", "thousandths", 7, 255, True),
    "mc-logits-exact-ign": ("multiclass", "logits", None, -1, True),
    "ml-ties-exact-ign": ("multilabel", "ties", None, -1, True),
    "ml-logits-list": ("multilabel", "logits", UNSORTED, None, False),
    "ml-ties-int-ign": ("multilabel", "ties", 5, 255, True),
    "ml-probs-exact": ("multilabel", "probs", None, None, False),
}

# name -> (functional stem, class stem, floor argument or None, extra keyword sets)
FAMILIES = {
    "eer": ("eer", "EER", None, [{}]),
    "logauc": ("logauc", "LogAUC", None, [{}, {"fpr_range": (0.01, 0.5)}]),
    "precision_at_recall": ("precision_at_fixed_recall", "PrecisionAtFixedRecall", "min_recall", [{}]),
    "recall_at_precision": ("recall_at_fixed_precision", "RecallAtFixedPrecision", "min_precision", [{}]),
    "sensitivity_at_specificity": ("sensitivity_at_specificity", "SensitivityAtSpecificity", "min_specificity",
                                   [{}]),
    "specificity_at_sensitivity": ("specificity_at_sensitivity", "SpecificityAtSensitivity", "min_sensitivity",
                                   [{}]),
}
FLOORS = [0.0, 0.5, 0.9, 1.0]
AVERAGES = {"eer": {"multiclass": [None, "micro", "macro"]}, "logauc": {"multiclass": ["macro", None],
                                                                        "multilabel": [None, "macro"]}}


def _kwargs(family: str, task: str, thresholds, ignore_index, variant: int) -> dict:
    stem, _, floor, extras = FAMILIES[family]
    kwargs = {"thresholds": thresholds, "ignore_index": ignore_index, **extras[variant % len(extras)]}
    if floor is not None:
        kwargs[floor] = FLOORS[variant % len(FLOORS)]
    if task == "multiclass":
        kwargs["num_classes"] = C
    if task == "multilabel":
        kwargs["num_labels"] = C
    averages = AVERAGES.get(family, {}).get(task)
    if averages:
        kwargs["average"] = averages[variant % len(averages)]
    return kwargs


def _check(family: str, got, want, kind: str) -> None:
    if FAMILIES[family][2] is None:
        _assert_same(got, want)
    else:
        _assert_point(got, want, bitwise_threshold=kind != "logits")


def _family_cases():
    """Every other case under each family, the even ones and the odd ones in turn (the
    families share the curves and differ in the reduction, and JAX compiles each curve
    length anew), each with a floor and an average taken in turn."""
    for j, family in enumerate(FAMILIES):
        for i, case in enumerate(CASES):
            if (i + j) % 2 == 0:
                yield pytest.param(family, case, i + j, id=f"{family}-{case}-{i + j}")


@pytest.mark.parametrize("family, case, variant", list(_family_cases()))
def test_functional_matches_jax(family, case, variant):
    task, kind, thresholds, ignore_index, absent = CASES[case]
    preds, target = _data(task, kind, ignore_index, absent, seed=list(CASES).index(case))
    jax_thr, port_thr = _thresholds(thresholds)
    stem = FAMILIES[family][0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jax_fn, f"{task}_{stem}")(jnp.asarray(preds), jnp.asarray(target),
                                                 **_kwargs(family, task, jax_thr, ignore_index, variant))
        got = getattr(port_fn, f"{task}_{stem}")(torch.from_numpy(preds), torch.from_numpy(target),
                                                 **_kwargs(family, task, port_thr, ignore_index, variant))
    _check(family, got, want, kind)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_facades_match_jax(family, task):
    preds, target = _data(task, "ties", None, False, seed=5)
    stem, cls_stem, floor, _ = FAMILIES[family]
    kwargs = {"task": task, "thresholds": None}
    if floor is not None:
        kwargs[floor] = 0.5
    if task != "binary":
        kwargs["num_classes" if task == "multiclass" else "num_labels"] = C
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jax_fn, stem)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        got = getattr(port_fn, stem)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        _check(family, got, want, "ties")
        jax_metric = getattr(jax_cls, cls_stem)(**kwargs)
        port_metric = getattr(port_cls, cls_stem)(**kwargs, device="cpu")
        assert type(port_metric).__name__ == type(jax_metric).__name__
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        port_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        _check(family, port_metric.compute(), jax_metric.compute(), "ties")


CLASS_CASES = [(family, case) for i, family in enumerate(FAMILIES) for case in list(CASES)[i::4]]


@pytest.mark.parametrize("family, case", CLASS_CASES, ids=lambda v: str(v))
def test_classes_match_jax_over_updates_merges_and_checkpoints(family, case):
    """Three updates (the third into a second metric merged in), the states bit for bit,
    the value, and a ``state_dict`` round trip."""
    task, kind, thresholds, ignore_index, absent = CASES[case]
    jax_thr, port_thr = _thresholds(thresholds)
    name = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}[task] + FAMILIES[family][1]
    variant = list(CASES).index(case)
    jax_metric = getattr(jax_cls, name)(**_kwargs(family, task, jax_thr, ignore_index, variant))

    def build():
        return getattr(port_cls, name)(**_kwargs(family, task, port_thr, ignore_index, variant), device="cpu")

    port_metric, other = build(), build()
    batches = [_data(task, kind, ignore_index, absent, seed=40 + i, n=N // 2) for i in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, (preds, target) in enumerate(batches):
            jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
            (port_metric if i < 2 else other).update(torch.from_numpy(preds), torch.from_numpy(target))
        port_metric.merge_state(other)
        if "confmat" in port_metric._state:
            _assert_same(port_metric._state["confmat"], jax_metric._state["confmat"], bitwise=True)
        else:
            for key in ("preds", "target"):
                _assert_same(torch.cat(port_metric._state[key]),
                             np.concatenate([np.asarray(x) for x in jax_metric._state[key]]), bitwise=kind != "logits")
        want = jax_metric.compute()
        _check(family, port_metric.compute(), want, kind)
        restored = build()
        restored.persistent(True)
        port_metric.persistent(True)
        restored.load_state_dict(port_metric.state_dict())
        _check(family, restored.compute(), want, kind)


# ------------------------------------------------- the row-wise tie rules


def _rows(seed: int, k: int = 6, width: int = 9):
    """Rows of objectives and constraints in quarters (ties on both), with NaNs, padded
    past each row's length with values that would win every reduction."""
    rng = np.random.default_rng(seed)
    lengths = np.random.default_rng(0).integers(1, width, k)  # one set of lengths: JAX compiles each anew
    obj = (rng.integers(0, 5, (k, width)) / 4).astype(np.float32)
    con = (rng.integers(0, 5, (k, width)) / 4).astype(np.float32)
    thr = np.sort(rng.uniform(size=(k, width)).astype(np.float32), axis=1)
    obj[rng.uniform(size=obj.shape) < 0.1] = np.nan
    con[rng.uniform(size=con.shape) < 0.1] = np.nan
    lengths[0] = width
    obj[1, :] = 0.0  # a best objective of 0: the lexicographic rule's threshold is NaN
    con[2, :] = 0.0  # nothing feasible at a positive floor
    pad = np.arange(width) >= lengths[:, None]
    obj[pad], con[pad], thr[pad] = 2.0, 2.0, 2.0
    return obj, con, thr, lengths


@pytest.mark.parametrize("floor", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("rule", ["lex", "first_argmax"])
def test_row_tie_rules_match_the_jax_per_curve_rules(rule, floor):
    """Each row of the padded layout, against the JAX package's rule on that row alone:
    ties, NaN, no feasible point, a best objective of 0, padding that never wins."""
    obj, con, thr, lengths = _rows(seed=int(floor * 4) + (rule == "lex"))
    port_rule = port_op._masked_lex_best if rule == "lex" else port_op._constrained_first_argmax
    jax_rule = jax_op._masked_lex_best if rule == "lex" else jax_ss._constrained_first_argmax
    got = port_rule(*(torch.from_numpy(x) for x in (obj, con, thr, lengths)), floor)
    for i, n in enumerate(lengths):
        want = jax_rule(*(jnp.asarray(x[i, :n]) for x in (obj, con, thr)), floor)
        _assert_same((got[0][i], got[1][i]), tuple(np.asarray(w, np.float32) for w in want), bitwise=True)
    if rule == "lex" and floor > 0:
        assert np.isnan(got[1][2].item()) and got[0][2].item() == 0.0
    if rule == "first_argmax" and floor > 0:
        assert (got[0][2].item(), got[1][2].item()) == (0.0, 1e6)


def test_nan_precision_and_a_class_without_positives_match_jax():
    """A binned PR curve with NaN precision (no prediction above the top thresholds) and
    a class without positives (NaN recall), through all four operating points."""
    preds, target = _data("multiclass", "probs", None, True, seed=3)
    thresholds = [0.0, 0.5, 0.98, 0.99, 1.0]
    for family in ("precision_at_recall", "recall_at_precision", "sensitivity_at_specificity",
                   "specificity_at_sensitivity"):
        stem, _, floor, _ = FAMILIES[family]
        for thr in (thresholds, None):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = getattr(jax_fn, f"multiclass_{stem}")(jnp.asarray(preds), jnp.asarray(target), C,
                                                             **{floor: 0.5}, thresholds=thr)
                got = getattr(port_fn, f"multiclass_{stem}")(torch.from_numpy(preds), torch.from_numpy(target), C,
                                                             **{floor: 0.5}, thresholds=thr)
            _assert_point(got, want, bitwise_threshold=True)


def test_logauc_with_fewer_than_two_points_scores_zero_as_in_jax():
    """A curve of one threshold (one point) warns and scores 0; a range holding no point
    of the curve integrates its interpolated bounds alone."""
    preds, target = _data("binary", "probs", None, False, seed=8)
    for kwargs in ({"thresholds": [0.5]}, {"fpr_range": (0.0001, 0.0002)}, {"fpr_range": (0.4, 0.41)}):
        with pytest.warns(UserWarning) if "thresholds" in kwargs else warnings.catch_warnings():
            got = port_fn.binary_logauc(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jax_fn.binary_logauc(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        _assert_same(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = port_fn.multilabel_logauc(*(torch.from_numpy(x) for x in _data("multilabel", "probs", None, False, 9)),
                                        C, thresholds=[0.5], average=None)
    assert torch.equal(got, torch.zeros(C))


def test_exact_multilabel_label_with_every_target_ignored_raises_as_in_jax():
    preds, target = _data("multilabel", "probs", None, False, seed=2, n=20)
    target[:, 2] = -1
    for family in FAMILIES:
        stem, _, floor, _ = FAMILIES[family]
        kwargs = {floor: 0.5} if floor else {}
        for fn, as_array in ((getattr(jax_fn, f"multilabel_{stem}"), jnp.asarray),
                             (getattr(port_fn, f"multilabel_{stem}"), torch.from_numpy)):
            with warnings.catch_warnings(), pytest.raises(IndexError, match="out of bounds"):
                warnings.simplefilter("ignore")
                fn(as_array(preds), as_array(target), C, ignore_index=-1, **kwargs)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("thresholds", [None, 11])
def test_compute_runs_the_same_operations_for_any_class_count(family, thresholds):
    """No loop over classes: the traced operator calls of one compute are the same at 3
    classes and at 24."""
    stem, cls_stem, floor, _ = FAMILIES[family]

    def traced_ops(classes: int) -> int:
        rng = np.random.default_rng(classes)
        preds = torch.from_numpy(rng.uniform(size=(64, classes)).astype(np.float32))
        target = torch.from_numpy(rng.integers(0, classes, 64))
        kwargs = {floor: 0.5} if floor else {}
        metric = getattr(port_cls, f"Multiclass{cls_stem}")(classes, thresholds=thresholds, device="cpu", **kwargs)
        metric.update(preds, target)
        with warnings.catch_warnings(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            warnings.simplefilter("ignore")
            metric.compute()
        return sum(1 for e in p.events() if e.name.startswith("aten::"))

    assert traced_ops(3) == traced_ops(24)


def test_validation_errors_match_jax():
    for pkg, kwargs in ((jax_cls, {}), (port_cls, {"device": "cpu"})):
        with pytest.raises(ValueError, match="`min_precision` to be an float in the \\[0,1\\] range"):
            pkg.BinaryRecallAtFixedPrecision(min_precision=1.5, **kwargs)
        with pytest.raises(ValueError, match="`min_specificity` to be an float"):
            pkg.MulticlassSensitivityAtSpecificity(3, min_specificity=1, **kwargs)
        with pytest.raises(ValueError, match="`fpr_range` should be a tuple of two floats in the range"):
            pkg.BinaryLogAUC(fpr_range=(0.5, 0.1), **kwargs)
        with pytest.raises(ValueError, match="`average` to be one of None, 'micro' or 'macro'"):
            pkg.MulticlassEER(3, average="weighted", **kwargs)
    with pytest.raises(ValueError, match="average"):
        port_fn.multiclass_eer(torch.rand(4, 3), torch.tensor([0, 1, 2, 0]), 3, average="weighted")


@pytest.mark.parametrize("thresholds", [None, 7])
@pytest.mark.parametrize("family, average", [("eer", None), ("eer", "micro"), ("eer", "macro"), ("logauc", None),
                                             ("logauc", "macro")])
def test_multiclass_averages_match_jax(family, average, thresholds):
    """Every average of the multiclass EER and LogAUC, exact and binned, functional and class."""
    preds, target = _data("multiclass", "ties", None, False, seed=12)
    stem, cls_stem, _, _ = FAMILIES[family]
    kwargs = {"thresholds": thresholds, "average": average}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jax_fn, f"multiclass_{stem}")(jnp.asarray(preds), jnp.asarray(target), C, **kwargs)
        _assert_same(getattr(port_fn, f"multiclass_{stem}")(torch.from_numpy(preds), torch.from_numpy(target), C,
                                                            **kwargs), want)
        jax_metric = getattr(jax_cls, f"Multiclass{cls_stem}")(C, **kwargs)
        port_metric = getattr(port_cls, f"Multiclass{cls_stem}")(C, **kwargs, device="cpu")
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        port_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        _assert_same(port_metric.compute(), jax_metric.compute())


MODULES = ["eer", "logauc", "precision_fixed_recall", "recall_fixed_precision", "sensitivity_specificity",
           "specificity_sensitivity"]


@pytest.mark.parametrize("package, module", [("functional.classification", m) for m in MODULES]
                         + [("functional.classification", "_operating_point_facades")]
                         + [("classification", m) for m in MODULES])
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
