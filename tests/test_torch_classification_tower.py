"""The port's exact match, Jaccard index, Matthews correlation coefficient and Cohen's
kappa (functional, classes and task facades) against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function or class and the
port's counterpart. States (confusion matrices, exact-match counts) must be equal bit for
bit in the JAX package's dtype; values within 1e-6 absolute or 1e-6 relative, the
tolerance of ``tests/test_torch_classification_tasks.py``, in the JAX package's dtype.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import classification as jax_cls
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu.functional.classification.cohen_kappa import _cohen_kappa_reduce as jax_kappa_reduce
from torchmetrics_tpu.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce as jax_mcc_reduce
from torchmetrics_tpu_torch import classification as port_cls
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_reduce
from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce

VALUE_ATOL = 1e-6
VALUE_RTOL = 1e-6
N, C, S = 24, 4, 3


def _assert_matches(got: torch.Tensor, want) -> None:
    """Same shape and JAX dtype; integers equal bit for bit, floats within tolerance."""
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=VALUE_ATOL, rtol=VALUE_RTOL)


def _data(task: str, kind: str, ignore_index, absent: bool, seed: int, extra: tuple = (), n: int = N):
    """(preds, target) numpy: ``kind`` is ``logits`` (activation needed), ``probs`` or
    int ``labels``; ``extra`` trailing multidim axes; ``absent``, a class (label) with no
    support, where ``zero_division`` decides."""
    rng = np.random.default_rng(seed)
    if task == "multiclass":
        target = rng.integers(0, C - 1 if absent else C, (n, *extra))
        if kind == "labels":
            preds = rng.integers(0, C, (n, *extra))
        else:
            preds = rng.normal(size=(n, C, *extra)).astype(np.float32)
    else:
        shape = (n, *extra) if task == "binary" else (n, C, *extra)
        target = rng.integers(0, 2, shape)
        if absent:
            target[(...) if task == "binary" else (slice(None), 0)] = 0
        if kind == "labels":
            preds = rng.integers(0, 2, shape)
        elif kind == "probs":
            preds = rng.uniform(size=shape).astype(np.float32)
        else:
            preds = (2 * rng.normal(size=shape)).astype(np.float32)
    if ignore_index is not None:
        target = np.where(rng.uniform(size=target.shape) < 0.2, ignore_index, target)
    return preds, target.astype(np.int64)


def _both(fn_name: str, preds, target, **kwargs):
    want = getattr(jax_fn, fn_name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(port_fn, fn_name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    return got, want


# ------------------------------------------------------------------ Jaccard

# (task, kind, average, ignore_index, zero_division, absent)
JACCARD_CASES = {
    "b-logits": ("binary", "logits", None, None, 0.0, False),
    "b-probs-ign-1-absent": ("binary", "probs", None, -1, 1.0, True),
    "b-labels-ign0": ("binary", "labels", None, 0, 0.0, False),
    "mc-micro-ign-in": ("multiclass", "logits", "micro", 2, 0.0, False),
    "mc-macro-ign-in-absent": ("multiclass", "logits", "macro", 0, 1.0, True),
    "mc-macro-ign-out": ("multiclass", "labels", "macro", -1, 0.0, True),
    "mc-weighted-ign-out": ("multiclass", "logits", "weighted", 255, 1.0, False),
    "mc-none-absent": ("multiclass", "labels", "none", None, 1.0, True),
    "mc-None-ign-in": ("multiclass", "logits", None, 1, 0.0, False),
    "mc-micro-ign-out": ("multiclass", "labels", "micro", -1, 1.0, False),
    "ml-micro": ("multilabel", "logits", "micro", None, 0.0, False),
    "ml-macro-absent": ("multilabel", "probs", "macro", -1, 1.0, True),
    "ml-weighted-ign": ("multilabel", "labels", "weighted", 255, 0.0, False),
    "ml-none-absent": ("multilabel", "logits", "none", None, 1.0, True),
}


def _jaccard_kwargs(task, average, ignore_index, zero_division) -> dict:
    kwargs = {"ignore_index": ignore_index, "zero_division": zero_division}
    if task == "multiclass":
        kwargs["num_classes"] = C
    if task == "multilabel":
        kwargs["num_labels"] = C
    if task != "binary":
        kwargs["average"] = average
    return kwargs


@pytest.mark.parametrize("case", list(JACCARD_CASES))
def test_jaccard_functional_and_class_match_jax(case):
    task, kind, average, ignore_index, zero_division, absent = JACCARD_CASES[case]
    kwargs = _jaccard_kwargs(task, average, ignore_index, zero_division)
    preds, target = _data(task, kind, ignore_index, absent, seed=list(JACCARD_CASES).index(case))
    _assert_matches(*_both(f"{task}_jaccard_index", preds, target, **kwargs))
    name = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}[task] + "JaccardIndex"
    jax_metric, port_metric = getattr(jax_cls, name)(**kwargs), getattr(port_cls, name)(**kwargs, device="cpu")
    for half in (slice(0, N // 2), slice(N // 2, N)):
        jax_metric.update(jnp.asarray(preds[half]), jnp.asarray(target[half]))
        port_metric.update(torch.from_numpy(preds[half]), torch.from_numpy(target[half]))
    _assert_matches(port_metric.confmat, jax_metric.confmat)
    _assert_matches(port_metric.compute(), jax_metric.compute())


# ---------------------------------------------------------------------- MCC

MCC_CASES = {
    "b-logits": ("binary", "logits", None, False),
    "b-probs-ign-1-absent": ("binary", "probs", -1, True),
    "mc-logits": ("multiclass", "logits", None, False),
    "mc-labels-ign-in-absent": ("multiclass", "labels", 2, True),
    "mc-logits-ign-out": ("multiclass", "logits", -1, False),
    "ml-probs-ign": ("multilabel", "probs", 255, False),
    "ml-logits-absent": ("multilabel", "logits", None, True),
}


@pytest.mark.parametrize("case", list(MCC_CASES))
def test_matthews_corrcoef_functional_and_class_match_jax(case):
    task, kind, ignore_index, absent = MCC_CASES[case]
    kwargs = {"ignore_index": ignore_index}
    if task != "binary":
        kwargs["num_classes" if task == "multiclass" else "num_labels"] = C
    preds, target = _data(task, kind, ignore_index, absent, seed=10 + list(MCC_CASES).index(case))
    _assert_matches(*_both(f"{task}_matthews_corrcoef", preds, target, **kwargs))
    name = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}[task] + "MatthewsCorrCoef"
    jax_metric, port_metric = getattr(jax_cls, name)(**kwargs), getattr(port_cls, name)(**kwargs, device="cpu")
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    port_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_matches(port_metric.confmat, jax_metric.confmat)
    _assert_matches(port_metric.compute(), jax_metric.compute())


# binary confusion matrices [[tn, fp], [fn, tp]] for every branch of the reduce: the two
# early returns, the four zero-denominator cases of real counts, and the three later
# cases with their fallback to 0, which only counts of mixed sign reach (the reduce
# accepts any matrix, so the port must agree on them too)
MCC_BRANCHES = {
    "all-correct": [[5, 0], [0, 3]],
    "all-wrong": [[0, 4], [2, 0]],
    "empty": [[0, 0], [0, 0]],
    "fn0-tn0": [[0, 2], [0, 3]],
    "fp0-tn0": [[0, 0], [2, 3]],
    "tp0-fn0": [[3, 2], [0, 0]],
    "tp0-fp0": [[3, 0], [2, 0]],
    "tp0": [[2, -2], [3, 0]],
    "tn0": [[0, 1], [-2, 2]],
    "fp0-or-fn0": [[2, 0], [-2, 3]],
    "fallback-0": [[1, -1], [2, 3]],
    "regular": [[7, 2], [3, 5]],
    "multiclass-degenerate": [[0, 0, 0], [0, 4, 0], [0, 0, 0]],
    "multiclass": [[5, 1, 0], [2, 6, 1], [0, 2, 3]],
    "multilabel": [[[3, 1], [0, 2]], [[0, 0], [1, 5]]],
}


@pytest.mark.parametrize("branch", list(MCC_BRANCHES))
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_matthews_corrcoef_reduce_branches_match_jax(branch, dtype):
    confmat = np.asarray(MCC_BRANCHES[branch], dtype)
    _assert_matches(_matthews_corrcoef_reduce(torch.from_numpy(confmat)), jax_mcc_reduce(jnp.asarray(confmat)))


@pytest.mark.parametrize("task, preds, target", [
    ("binary", [1, 1, 0, 0], [1, 1, 0, 0]),  # all correct
    ("binary", [0, 0, 1, 1], [1, 1, 0, 0]),  # all wrong
    ("binary", [1, 1, 1, 1], [1, 0, 1, 0]),  # every prediction positive
    ("binary", [0, 0, 0, 0], [1, 1, 0, 0]),  # every prediction negative
    ("binary", [1, 0, 1, 0], [1, 1, 1, 1]),  # every target positive
    ("multiclass", [2, 2, 2, 2], [0, 1, 2, 2]),
])
def test_matthews_corrcoef_degenerate_inputs_match_jax(task, preds, target):
    kwargs = {"num_classes": 3} if task == "multiclass" else {}
    _assert_matches(*_both(f"{task}_matthews_corrcoef", np.asarray(preds), np.asarray(target), **kwargs))


# ---------------------------------------------------------------- Cohen's kappa

KAPPA_CASES = {
    "b-logits": ("binary", "logits", None, False),
    "b-labels-ign-1": ("binary", "labels", -1, True),
    "mc-logits": ("multiclass", "logits", None, False),
    "mc-labels-ign-in-absent": ("multiclass", "labels", 0, True),
    "mc-logits-ign-out": ("multiclass", "logits", 255, False),
}


@pytest.mark.parametrize("weights", [None, "none", "linear", "quadratic"])
@pytest.mark.parametrize("case", list(KAPPA_CASES))
def test_cohen_kappa_functional_and_class_match_jax(case, weights):
    task, kind, ignore_index, absent = KAPPA_CASES[case]
    kwargs = {"ignore_index": ignore_index, "weights": weights}
    if task == "multiclass":
        kwargs["num_classes"] = C
    preds, target = _data(task, kind, ignore_index, absent, seed=20 + list(KAPPA_CASES).index(case))
    _assert_matches(*_both(f"{task}_cohen_kappa", preds, target, **kwargs))
    name = {"binary": "BinaryCohenKappa", "multiclass": "MulticlassCohenKappa"}[task]
    jax_metric, port_metric = getattr(jax_cls, name)(**kwargs), getattr(port_cls, name)(**kwargs, device="cpu")
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    port_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_matches(port_metric.confmat, jax_metric.confmat)
    _assert_matches(port_metric.compute(), jax_metric.compute())


@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
def test_cohen_kappa_reduce_counts_above_2048_match_jax(weights):
    """Counts above TF32's exact range: the expected matrix is a broadcast product, so
    it holds them as the JAX package's float32 outer product does."""
    confmat = np.random.default_rng(3).integers(1000, 40000, (5, 5)).astype(np.int32)
    _assert_matches(_cohen_kappa_reduce(torch.from_numpy(confmat), weights), jax_kappa_reduce(jnp.asarray(confmat),
                                                                                               weights))


# -------------------------------------------------------------- exact match

# (task, kind, extra axes, multidim_average, ignore_index)
EXACT_CASES = {
    "mc-scores-global": ("multiclass", "logits", (), "global", None),
    "mc-labels-multidim-global-ign": ("multiclass", "labels", (S,), "global", -1),
    "mc-scores-multidim-samplewise": ("multiclass", "logits", (S,), "samplewise", None),
    "mc-labels-multidim-samplewise-ign": ("multiclass", "labels", (S, 2), "samplewise", 0),
    "ml-probs-global": ("multilabel", "probs", (), "global", None),
    "ml-logits-global-ign": ("multilabel", "logits", (), "global", 255),
    "ml-labels-multidim-samplewise": ("multilabel", "labels", (S,), "samplewise", None),
    "ml-probs-multidim-samplewise-ign": ("multilabel", "probs", (S,), "samplewise", -1),
}


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_exact_match_functional_and_class_match_jax(case):
    task, kind, extra, multidim_average, ignore_index = EXACT_CASES[case]
    kwargs = {"multidim_average": multidim_average, "ignore_index": ignore_index}
    kwargs["num_classes" if task == "multiclass" else "num_labels"] = C
    preds, target = _data(task, kind, ignore_index, False, seed=30 + list(EXACT_CASES).index(case), extra=extra)
    if kind == "labels" and task == "multiclass":
        preds = np.where(np.random.default_rng(0).uniform(size=preds.shape) < 0.7, np.maximum(target, 0), preds)
    _assert_matches(*_both(f"{task}_exact_match", preds, target, **kwargs))
    name = {"multiclass": "MulticlassExactMatch", "multilabel": "MultilabelExactMatch"}[task]
    jax_metric, port_metric = getattr(jax_cls, name)(**kwargs), getattr(port_cls, name)(**kwargs, device="cpu")
    for half in (slice(0, N // 2), slice(N // 2, N)):
        jax_metric.update(jnp.asarray(preds[half]), jnp.asarray(target[half]))
        port_metric.update(torch.from_numpy(preds[half]), torch.from_numpy(target[half]))
    for name in ("correct", "total"):
        got, want = port_metric._state[name], jax_metric._state[name]
        if isinstance(want, list):
            got, want = torch.cat(got), np.concatenate([np.asarray(w) for w in want])
        _assert_matches(got, want)
    _assert_matches(port_metric.compute(), jax_metric.compute())


# ------------------------------------------------------------------ facades


@pytest.mark.parametrize("stem, cls_name, task, kwargs", [
    ("jaccard_index", "JaccardIndex", "binary", {}),
    ("jaccard_index", "JaccardIndex", "multiclass", {"num_classes": C, "average": "weighted", "ignore_index": 1}),
    ("jaccard_index", "JaccardIndex", "multilabel", {"num_labels": C, "average": "micro"}),
    ("matthews_corrcoef", "MatthewsCorrCoef", "binary", {}),
    ("matthews_corrcoef", "MatthewsCorrCoef", "multiclass", {"num_classes": C}),
    ("matthews_corrcoef", "MatthewsCorrCoef", "multilabel", {"num_labels": C}),
    ("cohen_kappa", "CohenKappa", "binary", {"weights": "linear"}),
    ("cohen_kappa", "CohenKappa", "multiclass", {"num_classes": C, "weights": "quadratic"}),
    ("exact_match", "ExactMatch", "multiclass", {"num_classes": C}),
    ("exact_match", "ExactMatch", "multilabel", {"num_labels": C, "multidim_average": "samplewise"}),
])
def test_task_facades_match_jax(stem, cls_name, task, kwargs):
    extra = (S,) if kwargs.get("multidim_average") == "samplewise" else ()
    preds, target = _data(task, "logits", kwargs.get("ignore_index"), False, seed=50, extra=extra)
    _assert_matches(*_both(stem, preds, target, task=task, **kwargs))
    jax_metric = getattr(jax_cls, cls_name)(task=task, **kwargs)
    port_metric = getattr(port_cls, cls_name)(task=task, **kwargs, device="cpu")
    assert type(port_metric).__name__ == type(jax_metric).__name__
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    port_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_matches(port_metric.compute(), jax_metric.compute())


@pytest.mark.parametrize("build", [
    lambda pkg, **device: pkg.ExactMatch(task="binary", **device),
    lambda pkg, **device: pkg.CohenKappa(task="multilabel", **device),
    lambda pkg, **device: pkg.MulticlassCohenKappa(3, weights="cubic", **device),
    lambda pkg, **device: pkg.MulticlassJaccardIndex(3, average="samples", **device),
    lambda pkg, **device: pkg.JaccardIndex(task="multiclass", **device),
    lambda pkg, **device: pkg.MatthewsCorrCoef(task="multilabel", **device),
])
def test_argument_errors_match_jax(build):
    with pytest.raises(ValueError):
        build(jax_cls)
    with pytest.raises(ValueError):
        build(port_cls, device="cpu")
