"""The port's nominal association metrics against the JAX package, on the CPU: Cramer's
V, Pearson's contingency coefficient, Theil's U, Tschuprow's T (functions, ``_matrix``
forms and classes) and Fleiss' kappa.

The same numpy inputs, made from a seed, go through the JAX package and the port.
Tolerances:

- contingency tables and the classes' ``confmat`` states bit for bit, and Fleiss'
  int32 counts bit for bit;
- the four statistics within 1e-6 relative above 0.1 and 1e-7 absolute below: both
  packages run the same float64 numpy on the same table and round to float32 once, so
  in practice they agree bit for bit;
- Fleiss' kappa within 1e-5 relative and 1e-6 absolute: the JAX package adds the items'
  float32 agreements in XLA's order (an error up to ``N * 2**-24`` of their sum, 3e-6 at
  N = 48), the port in float64 rounded once, and kappa's numerator cancels.
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

jax_assoc = importlib.import_module("torchmetrics_tpu.functional.nominal._association")
port_assoc = importlib.import_module("torchmetrics_tpu_torch.functional.nominal._association")
jax_nominal_utils = importlib.import_module("torchmetrics_tpu.functional.nominal.utils")
port_nominal_utils = importlib.import_module("torchmetrics_tpu_torch.functional.nominal.utils")
jax_data = importlib.import_module("torchmetrics_tpu.utilities.data")
port_data = importlib.import_module("torchmetrics_tpu_torch.utilities.data")
jax_fleiss = importlib.import_module("torchmetrics_tpu.functional.nominal.fleiss_kappa")
port_fleiss = importlib.import_module("torchmetrics_tpu_torch.functional.nominal.fleiss_kappa")

CPU = {"device": "cpu"}
_RNG = np.random.default_rng(42)  # the inputs of tests/test_clustering_nominal.py
NUM_BATCHES, BATCH = 4, 48
LABELS_P = _RNG.integers(0, 5, (NUM_BATCHES, BATCH))
LABELS_T = _RNG.integers(0, 5, (NUM_BATCHES, BATCH))


def _with_nan(labels: np.ndarray, seed: int, share: float = 0.1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = labels.astype(np.float64)
    out[rng.random(labels.shape) < share] = np.nan
    return out


P_NAN, T_NAN = _with_nan(LABELS_P[0], 1), _with_nan(LABELS_T[0], 2)
# 2-D inputs: rows of probabilities with ties among the largest and a NaN in some rows
PROBS = np.random.default_rng(3).choice(np.asarray([0.0, 0.25, 0.5], np.float32), size=(BATCH, 5))
PROBS[::7, 2] = np.nan
MATRIX = np.stack([LABELS_P[0], LABELS_T[0], LABELS_P[1], (LABELS_P[0] + LABELS_T[1]) % 3], 1).astype(np.float64)
MATRIX[np.random.default_rng(4).random(MATRIX.shape) < 0.08] = np.nan
STATS = {
    "cramers_v": ("CramersV", True),
    "pearsons_contingency_coefficient": ("PearsonsContingencyCoefficient", False),
    "theils_u": ("TheilsU", False),
    "tschuprows_t": ("TschuprowsT", True),
}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, context
    p64, r64 = p.astype(np.float64), r.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(p64), np.isnan(r64), err_msg=context)
    tol = np.where(np.abs(r64) < 0.1, 1e-7, 1e-6 * np.abs(r64))
    keep = ~np.isnan(r64)
    assert np.all(np.abs(p64 - r64)[keep] <= tol[keep]), f"{context}: {p} against {r}"


def _bitwise(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    np.testing.assert_array_equal(p, r, err_msg=context)


def _both(fn_name: str, *arrays, **kw):
    """(JAX, port) results of the function ``fn_name`` on the same numpy arrays."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_out = getattr(jax_fn, fn_name)(*[jnp.asarray(a) for a in arrays], **kw)
        port_out = getattr(port_fn, fn_name)(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw)
    return jax_out, port_out


# ------------------------------------------------------------------- the tables

@pytest.mark.parametrize(
    "preds, target, kw",
    [
        (LABELS_P[0], LABELS_T[0], {}),
        (P_NAN, T_NAN, {"nan_strategy": "replace", "nan_replace_value": 4}),
        (P_NAN, T_NAN, {"nan_strategy": "drop"}),
        (PROBS, LABELS_T[0], {}),
        (LABELS_P[0] + 0.7, LABELS_T[0] * 1.0, {}),
        (LABELS_P[0], LABELS_T[0], {"num_classes": 3}),
    ],
    ids=["labels", "nan_replace", "nan_drop", "probs_ties_nan", "float_labels_truncated", "out_of_range_drop"],
)
def test_contingency_tables_are_the_jax_packages_bit_for_bit(preds, target, kw):
    """numpy's first-max argmax (a NaN counts as the maximum), the NaN policies, the
    inferred size and the truncation of float labels all give the JAX package's table."""
    kw = {"num_classes": None, **kw}
    jax_table = jax_assoc._nominal_update(np.asarray(preds), np.asarray(target), **kw)
    port_table = port_assoc._nominal_update(torch.from_numpy(np.asarray(preds)), torch.from_numpy(np.asarray(target)),
                                            **kw)
    _bitwise(port_table, jax_table)
    assert port_table.dtype == torch.int32


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_torch_argmax_is_numpys_on_ties_nan_and_infinities(dtype):
    """The nominal and Fleiss updates collapse probabilities with ``torch.argmax``: the
    first maximum, and the first NaN in a row that holds one, as numpy's. Rows of
    integers (many ties) with NaNs, along each axis of 2-D and 3-D arrays and along long
    rows; ``chip_smoke.py``'s nominal phase holds the same on the card."""
    x = np.asarray([[0.5, 1.0, 1.0], [np.nan, 0.0, np.nan], [0.0, np.nan, 1.0], [-np.inf, -np.inf, -np.inf],
                    [-0.0, 0.0, -1.0], [np.inf, np.inf, 0.0]], dtype)
    np.testing.assert_array_equal(_np(torch.from_numpy(x).argmax(1)), x.argmax(1))
    np.testing.assert_array_equal(_np(torch.from_numpy(x.T.copy()).argmax(0)), x.argmax(1))
    rng = np.random.default_rng(5)
    for shape, axis in (((300, 40), 1), ((40, 300), 0), ((50, 5, 7), 1), ((3, 70000), 1)):
        y = rng.integers(0, 4, size=shape).astype(dtype)
        y[rng.random(shape) < 0.02] = np.nan
        np.testing.assert_array_equal(_np(torch.from_numpy(y).argmax(axis)), y.argmax(axis))


def test_bincount_2d_counts_exactly_past_float32s_integers():
    """JAX-side quirk kept: the JAX package's ``_bincount_2d`` adds float32 ones, so one
    bin of one update stops counting at 2**24; the port counts in int64."""
    n = 2**24 + 3
    labels = np.zeros(n, np.int32)
    jax_count = int(np.asarray(jax_data._bincount_2d(jnp.asarray(labels), jnp.asarray(labels), 2, 2))[0, 0])
    port_count = int(port_data._bincount_2d(torch.from_numpy(labels), torch.from_numpy(labels), 2, 2)[0, 0])
    assert port_count == n and jax_count == 2**24


# --------------------------------------------------------------- the statistics

FUNCTION_CASES = [(name, bias) for name in sorted(STATS) for bias in ((True, False) if STATS[name][1] else (None,))]


@pytest.mark.parametrize("name, bias_correction", FUNCTION_CASES, ids=[f"{n}-{b}" for n, b in FUNCTION_CASES])
@pytest.mark.parametrize(
    "preds, target, kw",
    [(LABELS_P[0], LABELS_T[0], {}), (P_NAN, T_NAN, {"nan_strategy": "drop"}),
     (P_NAN, T_NAN, {"nan_replace_value": 2.0}), (PROBS, LABELS_T[1], {})],
    ids=["labels", "drop", "replace", "probs"],
)
def test_functions_match_the_jax_package(name, bias_correction, preds, target, kw):
    if bias_correction is not None:
        kw = {**kw, "bias_correction": bias_correction}
    jax_out, port_out = _both(name, preds, target, **kw)
    _close(port_out, jax_out, name)


@pytest.mark.parametrize("name", sorted(STATS))
def test_matrix_forms_match_the_jax_package(name):
    for kw in ({"nan_strategy": "replace"}, {"nan_strategy": "drop"}):
        jax_out, port_out = _both(f"{name}_matrix", MATRIX, **kw)
        _close(port_out, jax_out, f"{name}_matrix {kw}")
        assert port_out.shape == (4, 4) and torch.equal(port_out.diagonal(), torch.ones(4))


def test_yates_correction_moves_by_at_most_the_difference():
    """A 2 x 2 table whose cells lie within 0.5 of their expected counts: scipy's
    ``min(0.5, |diff|)`` correction, not a flat 0.5, in both packages."""
    from scipy.stats import chi2_contingency

    table = np.asarray([[5.0, 5.0], [5.0, 6.0]])
    expected = np.outer(table.sum(1), table.sum(0)) / table.sum()
    assert np.all(np.abs(expected - table) < 0.5)
    chi2 = port_nominal_utils._compute_chi_squared(table, True)
    assert chi2 == jax_nominal_utils._compute_chi_squared(table, True) == chi2_contingency(table, correction=True)[0]
    preds = np.asarray([0] * 5 + [1] * 5 + [0] * 5 + [1] * 6)
    target = np.asarray([0] * 10 + [1] * 11)
    for name in ("cramers_v", "tschuprows_t"):
        jax_out, port_out = _both(name, preds, target)
        _close(port_out, jax_out, name)


@pytest.mark.parametrize("name", ["cramers_v", "tschuprows_t"])
def test_bias_correction_falls_back_to_nan_with_its_warning(name):
    preds, target = np.asarray([0, 1]), np.asarray([0, 1])
    with pytest.warns(UserWarning, match="Unable to compute"):
        port_out = getattr(port_fn, name)(torch.from_numpy(preds), torch.from_numpy(target))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_out = getattr(jax_fn, name)(jnp.asarray(preds), jnp.asarray(target))
    assert np.isnan(_np(port_out)) and np.isnan(np.asarray(jax_out)) and port_out.dtype == torch.float32


@pytest.mark.parametrize(
    "preds, target",
    [(np.zeros(6, np.int64), np.arange(6) % 3), (np.arange(6) % 2, np.arange(6) % 2), (np.zeros(4), np.zeros(4))],
    ids=["one_predicted_class", "perfect", "single_cell"],
)
@pytest.mark.parametrize("name", sorted(STATS))
def test_degenerate_tables(name, preds, target):
    jax_out, port_out = _both(name, preds, target)
    _close(port_out, jax_out, name)


@pytest.mark.parametrize(
    "call",
    [
        lambda f, a: f.cramers_v(a(LABELS_P[0]), a(LABELS_T[0]), nan_strategy="mean"),
        lambda f, a: f.theils_u(a(LABELS_P[0]), a(LABELS_T[0]), nan_replace_value="x"),
        lambda f, a: f.fleiss_kappa(a(np.zeros((3, 2), np.int64)), mode="votes"),
        lambda f, a: f.fleiss_kappa(a(np.zeros((3, 2), np.float32)), mode="counts"),
        lambda f, a: f.fleiss_kappa(a(np.zeros((3, 2), np.float32)), mode="probs"),
        lambda f, a: f.fleiss_kappa(a(np.zeros((3, 2, 2), np.int64)), mode="probs"),
    ],
    ids=["nan_strategy", "nan_replace_value", "fleiss_mode", "counts_float", "probs_2d", "probs_int"],
)
def test_function_errors_like_the_jax_package(call):
    with pytest.raises(ValueError) as jax_err:
        call(jax_fn, jnp.asarray)
    with pytest.raises(ValueError) as port_err:
        call(port_fn, torch.from_numpy)
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------- Fleiss' kappa

RATINGS = np.random.default_rng(5).multinomial(5, [0.4, 0.3, 0.2, 0.1], size=BATCH)
RATER_PROBS = np.random.default_rng(6).choice(np.asarray([0.1, 0.2, 0.3], np.float32), size=(BATCH, 4, 5))
RATER_PROBS[::5, 1, 0] = np.nan


def _kappa_close(port, ref) -> None:
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert port.dtype == torch.float32


@pytest.mark.parametrize("mode, ratings", [("counts", RATINGS), ("probs", RATER_PROBS)])
def test_fleiss_kappa_matches_the_jax_package(mode, ratings):
    jax_counts = np.asarray(jax_fleiss._fleiss_kappa_update(jnp.asarray(ratings), mode))
    port_counts = port_fleiss._fleiss_kappa_update(torch.from_numpy(ratings), mode)
    _bitwise(port_counts, jax_counts, "counts")
    jax_out, port_out = _both("fleiss_kappa", ratings, mode=mode)
    _kappa_close(port_out, jax_out)
    jax_metric, port_metric = jtm.FleissKappa(mode=mode), ttm.FleissKappa(mode=mode, **CPU)
    for part in np.array_split(np.arange(BATCH), 3):
        jax_metric.update(jnp.asarray(ratings[part]))
        port_metric.update(torch.from_numpy(ratings[part]))
    _kappa_close(port_metric.compute(), jax_metric.compute())
    assert all(c.dtype == torch.int32 for c in port_metric.counts)


# ---------------------------------------------------------------------- classes

def _class_pair(cls: str, **kw):
    return getattr(jtm, cls)(**kw), getattr(ttm, cls)(**kw, **CPU)


@pytest.mark.parametrize("kw", [{}, {"nan_strategy": "drop"}, {"nan_replace_value": 1}], ids=["plain", "drop", "replace"])
@pytest.mark.parametrize("name", sorted(STATS))
def test_classes_match_the_jax_package(name, kw):
    cls = STATS[name][0]
    jax_metric, port_metric = _class_pair(cls, num_classes=5, **kw)
    assert port_metric.confmat.dtype == torch.float32 and port_metric._jittable_compute is False
    for i in range(NUM_BATCHES):
        p, t = _with_nan(LABELS_P[i], 10 + i), _with_nan(LABELS_T[i], 20 + i)
        jax_metric.update(jnp.asarray(p), jnp.asarray(t))
        batch_value = port_metric(torch.from_numpy(p), torch.from_numpy(t))
        alone = getattr(ttm, cls)(num_classes=5, **kw, **CPU)
        alone.update(torch.from_numpy(p), torch.from_numpy(t))
        _bitwise(batch_value, alone.compute(), "forward")
    _bitwise(port_metric.confmat, jax_metric._state["confmat"], "confmat")
    _close(port_metric.compute(), jax_metric.compute(), cls)


def test_class_merge_sync_and_checkpoint():
    jax_metric, port_metric = _class_pair("CramersV", num_classes=5)
    halves = [getattr(ttm, "CramersV")(num_classes=5, **CPU) for _ in range(2)]
    for i in range(NUM_BATCHES):
        jax_metric.update(jnp.asarray(LABELS_P[i]), jnp.asarray(LABELS_T[i]))
        port_metric.update(torch.from_numpy(LABELS_P[i]), torch.from_numpy(LABELS_T[i]))
        halves[i % 2].update(torch.from_numpy(LABELS_P[i]), torch.from_numpy(LABELS_T[i]))
    halves[0].merge_state(halves[1])
    _bitwise(halves[0].confmat, port_metric.confmat, "merged")
    jax_metric.persistent(True)
    restored = ttm.CramersV(num_classes=5, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _bitwise(restored.confmat, jax_metric._state["confmat"], "restored")
    _close(restored.compute(), jax_metric.compute(), "restored")
    with pytest.raises(StateCorruptionError):
        ttm.CramersV(num_classes=4, **CPU).load_state_dict(jax_metric.state_dict())


@pytest.mark.parametrize(
    "build",
    [
        lambda m, **d: m.CramersV(num_classes=0, **d),
        lambda m, **d: m.TheilsU(num_classes=2.5, **d),
        lambda m, **d: m.TschuprowsT(num_classes=3, nan_strategy="zero", **d),
        lambda m, **d: m.PearsonsContingencyCoefficient(num_classes=3, nan_replace_value=None, **d),
        lambda m, **d: m.FleissKappa(mode="votes", **d),
    ],
    ids=["num_classes", "num_classes_float", "nan_strategy", "nan_replace_value", "fleiss_mode"],
)
def test_constructor_errors_like_the_jax_package(build):
    with pytest.raises(ValueError) as jax_err:
        build(jtm)
    with pytest.raises(ValueError) as port_err:
        build(ttm, **CPU)
    assert str(port_err.value) == str(jax_err.value)


def test_exports_equal_the_jax_packages():
    import torchmetrics_tpu.nominal as jax_nominal
    import torchmetrics_tpu_torch.nominal as port_nominal

    assert port_nominal.__all__ == jax_nominal.__all__
    assert port_fn.nominal.__all__ == jax_fn.nominal.__all__
    for name in port_nominal.__all__:
        assert getattr(ttm, name) is getattr(port_nominal, name)
    for name in port_fn.nominal.__all__:
        assert getattr(port_fn, name) is getattr(port_fn.nominal, name)
