"""The port's curve family (precision-recall curve, ROC, AUROC, average precision) and
its ``interp`` and ``_auc_compute`` against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function or class and the
port's counterpart. Binned states and the exact curves' thresholds must be equal bit for
bit (thresholds compared as bit patterns, so ``+0.0`` and ``-0.0`` differ); curve points
and scores within 1e-6 absolute or 1e-6 relative, NaN where the JAX package has NaN. The
thresholds of inputs that need the batch-wide sigmoid or softmax are the activation's
values, which PyTorch and XLA round differently in the last place: those are held to the
value tolerance.
"""

from __future__ import annotations

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import MetricCollection as JaxMetricCollection
from torchmetrics_tpu import classification as jax_cls
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu.utilities.compute import _auc_compute as jax_auc_compute
from torchmetrics_tpu.utilities.compute import interp as jax_interp
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch import classification as port_cls
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch.utilities.compute import _auc_compute, interp

# the modules themselves: each package's ``functional.classification`` exports a function
# of the same name
jax_prc = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")
port_prc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")

VALUE_ATOL = 1e-6
VALUE_RTOL = 1e-6
N, C = 48, 4
UNSORTED = [0.75, 0.25, 0.5, 0.25, 1.0, 0.0]  # unsorted, with a repeat


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(f"u{x.dtype.itemsize}")


def _assert_same(got, want, bitwise: bool = False) -> None:
    """Same structure, shapes and JAX dtypes; integers (or ``bitwise``) equal bit for
    bit, floats within the stated tolerance with NaN in the same places."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w, bitwise)
        return
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor)
    got = got.cpu().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    elif bitwise:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got, want, atol=VALUE_ATOL, rtol=VALUE_RTOL)


def _assert_curve(got, want, bitwise_thresholds: bool) -> None:
    """A (x, y, thresholds) curve: thresholds bit for bit when asked."""
    assert isinstance(got, tuple) and len(got) == 3
    _assert_same(got[:2], want[:2])
    _assert_same(got[2], want[2], bitwise=bitwise_thresholds)


def _scores(rng, kind: str, shape) -> np.ndarray:
    """float32 scores: ``probs`` in [0, 1], ``logits`` (sigmoid/softmax needed), ``ties``
    in quarters, ``thousandths`` rounded to 0.001, ``special`` probs with NaN, +0.0 and
    -0.0 mixed in (a NaN stops the batch-wide activation)."""
    if kind == "logits":
        return (2 * rng.normal(size=shape)).astype(np.float32)
    if kind == "ties":
        return (rng.integers(0, 5, shape) / 4).astype(np.float32)
    preds = rng.uniform(size=shape).astype(np.float32)
    if kind == "thousandths":
        return (np.round(preds * 1000) / 1000).astype(np.float32)
    if kind == "special":
        flat = preds.reshape(-1)
        flat[::7] = np.nan
        flat[1::5] = 0.0
        flat[2::5] = -0.0
    return preds


def _data(task: str, kind: str, ignore_index, absent: bool, seed: int, n: int = N):
    """(preds, target) numpy. ``absent``: binary and multilabel, a target (label 0)
    without positives; multiclass, a class that never occurs."""
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
    if ignore_index is not None:
        target = np.where(rng.uniform(size=target.shape) < 0.2, ignore_index, target)
    return preds, target.astype(np.int64)


def _thresholds(spec):
    """(JAX argument, port argument) for a thresholds spec."""
    if isinstance(spec, np.ndarray):
        return jnp.asarray(spec), torch.from_numpy(spec)
    return spec, spec


# (task, preds kind, thresholds, ignore_index, absent)
CASES = {
    "b-probs-exact": ("binary", "probs", None, None, False),
    "b-ties-exact-ign": ("binary", "ties", None, -1, False),
    "b-special-exact": ("binary", "special", None, None, False),
    "b-special-binned": ("binary", "special", 5, None, False),
    "b-logits-int": ("binary", "logits", 7, None, False),
    "b-ties-list": ("binary", "ties", UNSORTED, 255, False),
    "b-probs-tensor": ("binary", "probs", np.array([0.1, 0.3, 0.6, 0.9], np.float32), None, False),
    "b-absent-exact": ("binary", "probs", None, None, True),
    "b-absent-binned-ign": ("binary", "thousandths", 11, -1, True),
    "mc-probs-exact": ("multiclass", "probs", None, None, False),
    "mc-logits-exact-ign": ("multiclass", "logits", None, -1, True),
    "mc-ties-exact": ("multiclass", "ties", None, None, True),
    "mc-special-exact": ("multiclass", "special", None, None, False),
    "mc-special-binned": ("multiclass", "special", 6, None, False),
    "mc-ties-list-ign": ("multiclass", "ties", UNSORTED, 255, False),
    "mc-logits-int-absent": ("multiclass", "logits", 9, None, True),
    "ml-probs-exact": ("multilabel", "probs", None, None, False),
    "ml-ties-exact-ign": ("multilabel", "ties", None, -1, True),
    "ml-special-exact": ("multilabel", "special", None, None, False),
    "ml-logits-list": ("multilabel", "logits", UNSORTED, None, True),
    "ml-ties-int-ign": ("multilabel", "ties", 5, 255, False),
    "ml-special-tensor-ign": ("multilabel", "special", np.array([0.0, 0.2, 0.5, 0.5, 1.0], np.float32), -1, False),
}

# family -> (functional stem, class stem, averages per task)
FAMILIES = {
    "pr_curve": ("precision_recall_curve", "PrecisionRecallCurve",
                 {"binary": [None], "multiclass": [None, "micro"], "multilabel": [None]}),
    "roc": ("roc", "ROC", {"binary": [None], "multiclass": [None, "micro", "macro"], "multilabel": [None]}),
    "auroc": ("auroc", "AUROC", {"binary": [None], "multiclass": ["macro", "weighted", "none"],
                                 "multilabel": ["micro", "macro", "weighted", None]}),
    "ap": ("average_precision", "AveragePrecision", {"binary": [None], "multiclass": ["macro", "weighted", None],
                                                     "multilabel": ["micro", "macro", "weighted", "none"]}),
}


def _bitwise_thresholds(kind: str) -> bool:
    return kind != "logits"


def _kwargs(task: str, thresholds, ignore_index, average, family: str) -> dict:
    kwargs = {"thresholds": thresholds, "ignore_index": ignore_index}
    if task == "multiclass":
        kwargs["num_classes"] = C
    if task == "multilabel":
        kwargs["num_labels"] = C
    if task != "binary" and (family in ("auroc", "ap") or task == "multiclass"):
        kwargs["average"] = average
    return kwargs


def _check_result(family: str, got, want, kind: str) -> None:
    if family in ("auroc", "ap"):
        _assert_same(got, want)
    elif isinstance(want, tuple) and isinstance(want[0], list):  # per-class curves
        assert isinstance(got, tuple) and len(got) == 3
        for g, w in zip(zip(*got), zip(*want)):
            _assert_curve(tuple(g), tuple(w), _bitwise_thresholds(kind))
    else:
        _assert_curve(got, want, _bitwise_thresholds(kind))


def _family_cases():
    """Each case with two of its task's averages, taken in turn, so that every average
    meets several cases without crossing them all."""
    for family, (_, _, averages) in FAMILIES.items():
        for i, (case, (task, *_rest)) in enumerate(CASES.items()):
            choices = averages[task]
            for average in dict.fromkeys(choices[(i + j) % len(choices)] for j in range(2)):
                yield pytest.param(family, case, average, id=f"{family}-{case}-{average}")


@pytest.mark.parametrize("family, case, average", list(_family_cases()))
def test_functional_matches_jax(family, case, average):
    task, kind, thresholds, ignore_index, absent = CASES[case]
    preds, target = _data(task, kind, ignore_index, absent, seed=list(CASES).index(case))
    jax_thr, port_thr = _thresholds(thresholds)
    stem = FAMILIES[family][0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jax_fn, f"{task}_{stem}")(jnp.asarray(preds), jnp.asarray(target),
                                                 **_kwargs(task, jax_thr, ignore_index, average, family))
        got = getattr(port_fn, f"{task}_{stem}")(torch.from_numpy(preds), torch.from_numpy(target),
                                                 **_kwargs(task, port_thr, ignore_index, average, family))
    _check_result(family, got, want, kind)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_facades_match_jax(family, task):
    preds, target = _data(task, "ties", None, False, seed=5)
    stem, cls_stem, averages = FAMILIES[family]
    kwargs = {"task": task, "thresholds": None}
    if task != "binary":
        kwargs["num_classes" if task == "multiclass" else "num_labels"] = C
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jax_fn, stem)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        got = getattr(port_fn, stem)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        _check_result(family, got, want, "ties")
        jax_metric = getattr(jax_cls, cls_stem)(**kwargs)
        port_metric = getattr(port_cls, cls_stem)(**kwargs, device="cpu")
        assert type(port_metric).__name__ == type(jax_metric).__name__
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        port_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        _check_result(family, port_metric.compute(), jax_metric.compute(), "ties")


# (family, case, average) run through the classes: three updates, then the states and
# the value, then merge_state and a state_dict round trip
CLASS_CASES = [
    ("pr_curve", "b-special-exact", None), ("pr_curve", "b-ties-list", None), ("pr_curve", "mc-ties-exact", None),
    ("pr_curve", "mc-ties-list-ign", "micro"), ("pr_curve", "ml-ties-exact-ign", None),
    ("roc", "b-absent-binned-ign", None), ("roc", "mc-special-binned", "macro"), ("roc", "mc-probs-exact", "macro"),
    ("roc", "ml-special-tensor-ign", None), ("auroc", "b-ties-exact-ign", None), ("auroc", "mc-ties-exact", "weighted"),
    ("auroc", "ml-ties-int-ign", "micro"), ("auroc", "ml-ties-exact-ign", "macro"), ("ap", "b-logits-int", None),
    ("ap", "mc-logits-exact-ign", "macro"), ("ap", "mc-ties-list-ign", "none"), ("ap", "ml-special-exact", "weighted"),
]


def _class_kwargs(task, thresholds, ignore_index, average, family) -> dict:
    kwargs = _kwargs(task, thresholds, ignore_index, average, family)
    if task == "multiclass" and family == "pr_curve" and average not in (None, "micro"):
        kwargs.pop("average")
    return kwargs


def _assert_states(port_metric, jax_metric, kind: str) -> None:
    """Binned: the int32 confusion bit for bit; exact: the concatenated raw states (the
    scores bit for bit unless an activation made them)."""
    if "confmat" in port_metric._state:
        _assert_same(port_metric._state["confmat"], jax_metric._state["confmat"])
        return
    for name in ("preds", "target"):
        got = torch.cat(port_metric._state[name])
        want = np.concatenate([np.asarray(x) for x in jax_metric._state[name]])
        _assert_same(got, want, bitwise=_bitwise_thresholds(kind))


@pytest.mark.parametrize("family, case, average", CLASS_CASES, ids=lambda v: str(v))
def test_classes_match_jax_over_updates_merges_and_checkpoints(family, case, average):
    task, kind, thresholds, ignore_index, absent = CASES[case]
    jax_thr, port_thr = _thresholds(thresholds)
    cls_stem = FAMILIES[family][1]
    prefix = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}[task]
    name = prefix + ("AUROC" if family == "auroc" else cls_stem)
    jax_kwargs = _class_kwargs(task, jax_thr, ignore_index, average, family)
    port_kwargs = _class_kwargs(task, port_thr, ignore_index, average, family)
    jax_metric, port_metric = getattr(jax_cls, name)(**jax_kwargs), getattr(port_cls, name)(**port_kwargs, device="cpu")
    other = getattr(port_cls, name)(**port_kwargs, device="cpu")
    batches = [_data(task, kind, ignore_index, absent, seed=40 + i, n=N // 2) for i in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, (preds, target) in enumerate(batches):
            jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
            (port_metric if i < 2 else other).update(torch.from_numpy(preds), torch.from_numpy(target))
        port_metric.merge_state(other)
        _assert_states(port_metric, jax_metric, kind)
        want = jax_metric.compute()
        _check_result(family, port_metric.compute(), want, kind)
        restored = getattr(port_cls, name)(**port_kwargs, device="cpu")
        restored.persistent(True)
        port_metric.persistent(True)
        restored.load_state_dict(port_metric.state_dict())
        _check_result(family, restored.compute(), want, kind)


@pytest.mark.parametrize("thresholds", [None, 7])
def test_auroc_and_ap_share_a_compute_group_as_in_jax(thresholds):
    preds, target = _data("multiclass", "ties", None, False, seed=3)

    def build(pkg, **device):
        return {"auroc": pkg.MulticlassAUROC(C, thresholds=thresholds, **device),
                "ap": pkg.MulticlassAveragePrecision(C, thresholds=thresholds, **device),
                "roc": pkg.MulticlassROC(C, thresholds=thresholds, **device),
                "acc": pkg.MulticlassAccuracy(C, **device)}

    jax_coll = JaxMetricCollection(build(jax_cls), compute_groups=True)
    port_coll = MetricCollection(build(port_cls, device="cpu"), compute_groups=True, device="cpu")
    for _ in range(2):
        jax_coll.update(jnp.asarray(preds), jnp.asarray(target))
        port_coll.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert sorted(map(sorted, port_coll.compute_groups.values())) == sorted(map(sorted, jax_coll.compute_groups.values()))
    assert any(len(group) == 3 for group in port_coll.compute_groups.values())
    want, got = jax_coll.compute(), port_coll.compute()
    for key in ("auroc", "ap", "acc"):
        _assert_same(got[key], want[key])


@pytest.mark.parametrize("max_fpr", [0.1, 0.35, 1.0])
@pytest.mark.parametrize("thresholds", [None, 21])
def test_binary_auroc_max_fpr_matches_jax(max_fpr, thresholds):
    preds, target = _data("binary", "thousandths", None, False, seed=11, n=200)
    want = jax_fn.binary_auroc(jnp.asarray(preds), jnp.asarray(target), max_fpr=max_fpr, thresholds=thresholds)
    got = port_fn.binary_auroc(torch.from_numpy(preds), torch.from_numpy(target), max_fpr=max_fpr,
                               thresholds=thresholds)
    _assert_same(got, want)
    metric = port_cls.BinaryAUROC(max_fpr=max_fpr, thresholds=thresholds, device="cpu")
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_same(metric.compute(), want)


def test_multiclass_all_zero_target_keeps_the_literal_recall_quirk():
    """Every target 0: the JAX package's all-negative test is literal, so every class's
    recall is 1 (and the AP of the classes without positives is not NaN)."""
    preds, _ = _data("multiclass", "probs", None, False, seed=2)
    target = np.zeros(N, np.int64)
    with pytest.warns(UserWarning, match="No positive samples"):
        got = port_fn.multiclass_precision_recall_curve(torch.from_numpy(preds), torch.from_numpy(target), C)
    want = jax_fn.multiclass_precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), C)
    _check_result("pr_curve", got, want, "probs")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _assert_same(port_fn.multiclass_average_precision(torch.from_numpy(preds), torch.from_numpy(target), C,
                                                          average="none"),
                     jax_fn.multiclass_average_precision(jnp.asarray(preds), jnp.asarray(target), C, average="none"))


def test_binned_state_above_the_jax_f32_chunk_is_exact():
    """2**22 + 1000 scores, 3 thresholds: more rows than one exact float32 chunk of the
    JAX package's matmul; the int32 states equal bit for bit."""
    n = jax_prc._EXACT_F32_CHUNK + 1000
    rng = np.random.default_rng(7)
    preds = (rng.integers(0, 1001, n) / 1000).astype(np.float32)
    target = (rng.uniform(size=n) < 0.3).astype(np.int64)
    target[::97] = -1
    thresholds = [0.5, 0.001, 0.999]
    p, t, thr, w = jax_prc._binary_precision_recall_curve_format(jnp.asarray(preds), jnp.asarray(target), thresholds, -1)
    want = jax_prc._binary_precision_recall_curve_update(p, t, thr, w)
    p, t, thr, w = port_prc._binary_precision_recall_curve_format(torch.from_numpy(preds), torch.from_numpy(target),
                                                                  thresholds, -1)
    got = port_prc._binary_precision_recall_curve_update(p, t, thr, w)
    _assert_same(got, want)
    assert int(got[0].sum()) == int((target != -1).sum())


def test_interp_matches_jnp_interp_on_repeated_xp():
    rng = np.random.default_rng(0)
    for _ in range(20):
        xp = np.sort(rng.integers(0, 5, 9) / 4).astype(np.float32)  # repeats
        fp = rng.uniform(size=9).astype(np.float32)
        x = np.concatenate([rng.uniform(-0.25, 1.25, 30), xp]).astype(np.float32)
        want = jax_interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
        _assert_same(interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)), want, bitwise=True)
        padded = np.concatenate([xp, np.full(4, xp[-1], np.float32)])
        rows = interp(torch.from_numpy(x), torch.from_numpy(np.stack([padded, padded])),
                      torch.from_numpy(np.stack([np.concatenate([fp, np.full(4, fp[-1], np.float32)])] * 2)),
                      torch.tensor([9, 9]))
        for row in rows:
            _assert_same(row, want, bitwise=True)


@pytest.mark.parametrize("direction", [None, 1.0, -1.0])
def test_auc_compute_matches_jax(direction):
    rng = np.random.default_rng(1)
    for x in (np.sort(rng.uniform(size=12)), -np.sort(rng.uniform(size=12)), rng.uniform(size=12)):
        x, y = x.astype(np.float32), rng.uniform(size=12).astype(np.float32)
        _assert_same(_auc_compute(torch.from_numpy(x), torch.from_numpy(y), direction),
                     jax_auc_compute(jnp.asarray(x), jnp.asarray(y), direction))


def test_threshold_argument_bits_match_jax():
    for spec in (2, 11, 100, 1000, UNSORTED):
        _assert_same(port_prc._adjust_threshold_arg(spec), jax_prc._adjust_threshold_arg(spec), bitwise=True)


def test_exact_order_puts_nan_last_as_numpy_does():
    """numpy's stable argsort of -preds puts NaN last; a descending torch sort would put
    it first. The exact curve's thresholds must follow numpy."""
    preds = np.array([0.3, np.nan, 0.9, 0.1, np.nan, 0.0, -0.0, 0.9], np.float32)
    target = np.array([1, 0, 1, 0, 1, 1, 0, 0])
    want = jax_fn.binary_roc(jnp.asarray(preds), jnp.asarray(target))
    got = port_fn.binary_roc(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_curve(got, want, bitwise_thresholds=True)
    assert np.isnan(got[2].numpy()[-2:]).all()


def test_validation_errors_match_jax():
    preds, target = torch.rand(8), torch.tensor([0, 1, 2, 0, 1, 0, 1, 0])
    with pytest.raises(RuntimeError, match="Detected the following values in `target`"):
        port_fn.binary_precision_recall_curve(preds, target)
    with pytest.raises(ValueError, match="larger than 1"):
        port_cls.BinaryROC(thresholds=1, device="cpu")
    with pytest.raises(ValueError, match="in the \\[0,1\\] range"):
        port_cls.BinaryAUROC(thresholds=[0.5, 2.0], device="cpu")
    with pytest.raises(ValueError, match="max_fpr"):
        port_cls.BinaryAUROC(max_fpr=1.5, device="cpu")
    with pytest.raises(ValueError, match="average"):
        port_cls.MulticlassAveragePrecision(3, average="micro", device="cpu")
    with pytest.raises(RuntimeError, match="more unique values"):
        port_fn.multiclass_roc(torch.rand(4, 3), torch.tensor([0, 1, 3, 0]), 3)


def test_numpy_order_is_numpys_stable_argsort():
    """Ties (zeros of both signs, NaNs of both signs) keep their order; NaN comes last."""
    rng = np.random.default_rng(4)
    x = (rng.integers(-3, 4, 500) / 2).astype(np.float32)
    x[rng.uniform(size=500) < 0.2] = -0.0
    x[rng.uniform(size=500) < 0.1] = np.nan
    x[rng.uniform(size=500) < 0.05] = -np.float32(np.nan)
    got = port_prc._numpy_order(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.argsort(x, kind="stable"))
    rows = port_prc._numpy_order(torch.from_numpy(np.stack([x, -x])), dim=1)
    np.testing.assert_array_equal(rows.numpy(), np.stack([np.argsort(x, kind="stable"), np.argsort(-x, kind="stable")]))


@pytest.mark.parametrize("stem", ["roc", "precision_recall_curve"])
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_float16_scores_keep_the_jax_dtypes(task, stem):
    """float16 scores: the thresholds stay float16, and a degenerate ROC row (no
    negatives, or no positives) is zeros in the thresholds' dtype, as in the JAX package."""
    preds, target = _data(task, "ties", None, False, seed=6)
    preds = preds.astype(np.float16)
    target = np.ones_like(target) if task == "binary" else np.zeros_like(target)
    kwargs = {"num_classes": C} if task == "multiclass" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jax_fn, f"{task}_{stem}")(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        got = getattr(port_fn, f"{task}_{stem}")(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    _check_result(stem, got, want, "ties")


@pytest.mark.parametrize("family, average", [("pr_curve", None), ("roc", None), ("auroc", "none"), ("auroc", "macro"),
                                             ("ap", "none"), ("ap", "weighted")])
@pytest.mark.parametrize("api", ["functional", "class"])
def test_exact_multilabel_label_with_every_target_ignored_raises_as_in_jax(family, average, api):
    """Label 1's every target is ``ignore_index``: the JAX package's numpy raises an
    ``IndexError`` on its empty curve, and so does the port."""
    preds, target = _data("multilabel", "probs", None, False, seed=9, n=20)
    target[:, 1] = -1
    stem, cls_stem, _ = FAMILIES[family]
    kwargs = _kwargs("multilabel", None, -1, average, family)
    kwargs.pop("num_labels")
    for pkg, as_array, device in ((jax_fn if api == "functional" else jax_cls, jnp.asarray, {}),
                                  (port_fn if api == "functional" else port_cls, torch.from_numpy, {"device": "cpu"})):
        with warnings.catch_warnings(), pytest.raises(IndexError, match="out of bounds"):
            warnings.simplefilter("ignore")
            if api == "functional":
                getattr(pkg, f"multilabel_{stem}")(as_array(preds), as_array(target), C, **kwargs)
            else:
                metric = getattr(pkg, "MultilabelAUROC" if family == "auroc" else f"Multilabel{cls_stem}")(
                    C, **kwargs, **device)
                metric.update(as_array(preds), as_array(target))
                metric.compute()
