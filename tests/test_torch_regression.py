"""The port's regression metrics against the JAX package, on the CPU: the sum-state
errors, R2, relative squared error and explained variance, Pearson and concordance by
running moments, NRMSE, CRPS and CSI (the rank correlations, cosine similarity and the
divergences are in ``test_torch_correlation.py``).

The same numpy batches, made from a seed, go through the JAX functional and class and
the port's. Tolerances:

- counts (``total``, ``n_total``, ``num_obs``, ``num_observations``, CSI's hits, misses
  and false alarms) and min/max states equal bit for bit;
- float sums and moments within ``SUM_RTOL`` relative (``SUM_ATOL`` absolute near 0):
  the JAX package adds in float32 in XLA's order, the port in float64 rounded once;
- values within ``VALUE_RTOL`` relative or ``VALUE_ATOL`` absolute;
- every state is float32, as in the JAX package, after construction and after updates.
"""

from __future__ import annotations

import functools
import importlib
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu import regression as jax_reg
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch import regression as port_reg

port_crps = importlib.import_module("torchmetrics_tpu_torch.functional.regression.crps")
jax_crps = importlib.import_module("torchmetrics_tpu.functional.regression.crps")

VALUE_RTOL = 1e-6
VALUE_ATOL = 1e-6
SUM_RTOL = 1e-6  # a float32 sum of ~120 terms in XLA's order against a float64 sum rounded once
SUM_ATOL = 1e-6
EXACT_STATES = {"total", "n_total", "num_obs", "num_observations", "hits", "misses", "false_alarms", "min_val",
                "max_val"}
NB, N = 3, 40  # batches, rows per batch: one shape per kind, so JAX compiles each metric once

_rng = np.random.default_rng(7)
DATA = {
    "normal": (_rng.normal(size=(NB, N)), _rng.normal(size=(NB, N))),
    "2d": (_rng.normal(size=(NB, N, 3)), _rng.normal(size=(NB, N, 3)) + 0.5),
    "crps": (_rng.normal(size=(NB, N, 8)), _rng.normal(size=(NB, N))),
    "seq": (_rng.uniform(size=(NB, 4, 6, 5)), _rng.uniform(size=(NB, 4, 6, 5))),
}
DATA["pos"] = tuple(np.abs(a) + 0.1 for a in DATA["normal"])
DATA = {k: tuple(a.astype(np.float32) for a in v) for k, v in DATA.items()}

# (id, class, class kwargs, functional, functional kwargs, data)
CASES = [
    ("mse", "MeanSquaredError", {}, "mean_squared_error", {}, "normal"),
    ("rmse", "MeanSquaredError", {"squared": False}, "mean_squared_error", {"squared": False}, "normal"),
    ("mse_3out", "MeanSquaredError", {"num_outputs": 3}, "mean_squared_error", {"num_outputs": 3}, "2d"),
    ("mae", "MeanAbsoluteError", {}, "mean_absolute_error", {}, "normal"),
    ("mae_3out", "MeanAbsoluteError", {"num_outputs": 3}, "mean_absolute_error", {"num_outputs": 3}, "2d"),
    ("msle", "MeanSquaredLogError", {}, "mean_squared_log_error", {}, "pos"),
    ("mape", "MeanAbsolutePercentageError", {}, "mean_absolute_percentage_error", {}, "pos"),
    ("smape", "SymmetricMeanAbsolutePercentageError", {}, "symmetric_mean_absolute_percentage_error", {}, "normal"),
    ("wmape", "WeightedMeanAbsolutePercentageError", {}, "weighted_mean_absolute_percentage_error", {}, "normal"),
    ("log_cosh", "LogCoshError", {}, "log_cosh_error", {}, "normal"),
    ("log_cosh_3out", "LogCoshError", {"num_outputs": 3}, "log_cosh_error", {}, "2d"),
    ("minkowski", "MinkowskiDistance", {"p": 3}, "minkowski_distance", {"p": 3}, "normal"),
    *[(f"tweedie_{p}", "TweedieDevianceScore", {"power": p}, "tweedie_deviance_score", {"power": p}, "pos")
      for p in (0.0, 1.0, 1.5, 2.0, 3.0)],
    ("r2", "R2Score", {}, "r2_score", {}, "normal"),
    ("r2_adjusted", "R2Score", {"adjusted": 2}, "r2_score", {"adjusted": 2}, "normal"),
    *[(f"r2_{mode}", "R2Score", {"num_outputs": 3, "multioutput": mode}, "r2_score", {"multioutput": mode}, "2d")
      for mode in ("raw_values", "uniform_average", "variance_weighted")],
    ("rse", "RelativeSquaredError", {}, "relative_squared_error", {}, "normal"),
    ("rse_root", "RelativeSquaredError", {"squared": False}, "relative_squared_error", {"squared": False}, "normal"),
    ("explained_variance", "ExplainedVariance", {}, "explained_variance", {}, "normal"),
    *[(f"explained_variance_{mode}", "ExplainedVariance", {"multioutput": mode}, "explained_variance",
       {"multioutput": mode}, "2d") for mode in ("raw_values", "uniform_average", "variance_weighted")],
    ("pearson", "PearsonCorrCoef", {}, "pearson_corrcoef", {}, "normal"),
    ("pearson_3out", "PearsonCorrCoef", {"num_outputs": 3}, "pearson_corrcoef", {}, "2d"),
    ("concordance", "ConcordanceCorrCoef", {}, "concordance_corrcoef", {}, "normal"),
    ("concordance_3out", "ConcordanceCorrCoef", {"num_outputs": 3}, "concordance_corrcoef", {}, "2d"),
    *[(f"nrmse_{norm}", "NormalizedRootMeanSquaredError", {"normalization": norm},
       "normalized_root_mean_squared_error", {"normalization": norm}, "pos") for norm in ("mean", "range", "std", "l2")],
    ("nrmse_std_3out", "NormalizedRootMeanSquaredError", {"normalization": "std", "num_outputs": 3},
     "normalized_root_mean_squared_error", {"normalization": "std", "num_outputs": 3}, "2d"),
    ("crps", "ContinuousRankedProbabilityScore", {}, "continuous_ranked_probability_score", {}, "crps"),
    ("csi", "CriticalSuccessIndex", {"threshold": 0.5}, "critical_success_index", {"threshold": 0.5}, "normal"),
    ("csi_sequence", "CriticalSuccessIndex", {"threshold": 0.5, "keep_sequence_dim": 1}, "critical_success_index",
     {"threshold": 0.5, "keep_sequence_dim": 1}, "seq"),
]

# ``torchmetrics_tpu_torch.regression`` with ``device="cpu"`` bound
CPU_REGRESSION = types.SimpleNamespace(**{name: functools.partial(getattr(port_reg, name), device="cpu")
                                          for name in port_reg.__all__})

# the JAX package's R2Score(adjusted > 0).forward reads the count with int() inside its
# jitted forward and raises ConcretizationTypeError; its update and compute work
JAX_FORWARD_RAISES = {"r2_adjusted"}


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _assert_close(got, want, rtol=VALUE_RTOL, atol=VALUE_ATOL, bitwise=False, ctx=""):
    """Same structure, shape and dtype; bit for bit, or within the tolerance with NaN in
    the same places."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), ctx
        for g, w in zip(got, want):
            _assert_close(g, w, rtol, atol, bitwise, ctx)
        return
    assert isinstance(got, torch.Tensor), ctx
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (ctx, got.shape, got.dtype, want.shape, want.dtype)
    if bitwise:
        np.testing.assert_array_equal(got, want, err_msg=ctx)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=ctx)


def _assert_states(port_metric, jax_metric, ctx=""):
    assert list(port_metric._state) == list(jax_metric._state), ctx
    for name, want in jax_metric._state.items():
        got = port_metric._state[name]
        if isinstance(want, list):
            got, want = torch.cat([torch.atleast_1d(g) for g in got]), np.concatenate([np.atleast_1d(w) for w in want])
        _assert_close(got, want, SUM_RTOL, SUM_ATOL, bitwise=name in EXACT_STATES, ctx=f"{ctx} {name}")


def _state_dtypes(metric):
    return {k: [t.dtype for t in v] if isinstance(v, list) else v.dtype for k, v in metric._state.items()}


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_matches_the_jax_package(case):
    """Functional on the whole data, class by ``forward`` per batch (batch values, then
    states and value), and the port's ``update`` path equal to its ``forward`` path."""
    _, cls, cls_kwargs, fn, fn_kwargs, kind = case
    preds, target = DATA[kind]
    whole = [a.reshape(-1, *a.shape[2:]) for a in (preds, target)]
    want = _quiet(getattr(jax_fn, fn), *(jnp.asarray(a) for a in whole), **fn_kwargs)
    got = _quiet(getattr(port_fn, fn), *(torch.from_numpy(a) for a in whole), **fn_kwargs)
    _assert_close(got, want, ctx="functional")

    jax_metric = getattr(jax_reg, cls)(**cls_kwargs)
    port_metric = getattr(port_reg, cls)(**cls_kwargs, device="cpu")
    port_updated = getattr(port_reg, cls)(**cls_kwargs, device="cpu")
    assert all(d == torch.float32 for d in _state_dtypes(port_metric).values() if not isinstance(d, list))
    for i in range(NB):
        if case[0] in JAX_FORWARD_RAISES:  # the batch's value from the JAX functional instead
            _quiet(jax_metric.update, jnp.asarray(preds[i]), jnp.asarray(target[i]))
            want = _quiet(getattr(jax_fn, fn), jnp.asarray(preds[i]), jnp.asarray(target[i]), **fn_kwargs)
        else:
            want = _quiet(jax_metric, jnp.asarray(preds[i]), jnp.asarray(target[i]))
        got = _quiet(port_metric, torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
        _assert_close(got, want, ctx=f"forward {i}")
        port_updated.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    _assert_states(port_metric, jax_metric, ctx="states")
    _assert_close(_quiet(port_metric.compute), _quiet(jax_metric.compute), ctx="compute")
    for name, value in port_metric._state.items():
        _assert_close(port_updated._state[name] if not isinstance(value, list) else torch.cat(port_updated._state[name]),
                      _np(value if not isinstance(value, list) else torch.cat(value)), bitwise=True, ctx=name)


@pytest.mark.parametrize("name", sorted(port_reg.__all__))
def test_every_state_is_float32_as_in_the_jax_package(name):
    """After construction and after one update, each state's dtype (each element's, for
    a concat state) is the JAX package's: float32."""
    kwargs = {"MinkowskiDistance": {"p": 2}, "CriticalSuccessIndex": {"threshold": 0.5}}.get(name, {})
    inputs = {"ContinuousRankedProbabilityScore": "crps", "CosineSimilarity": "2d", "KLDivergence": "pos2d",
              "JensenShannonDivergence": "pos2d"}.get(name, "pos")
    preds, target = (np.abs(DATA["2d"][0][0]) + 0.1, np.abs(DATA["2d"][1][0]) + 0.1) if inputs == "pos2d" else \
        (DATA[inputs][0][0], DATA[inputs][1][0])
    jax_metric, port_metric = getattr(jax_reg, name)(**kwargs), getattr(port_reg, name)(**kwargs, device="cpu")
    for stage in ("construction", "update"):
        want = {k: [np.asarray(t).dtype for t in v] if isinstance(v, list) else np.asarray(v).dtype
                for k, v in jax_metric._state.items()}
        got = {k: [torch.empty(0, dtype=t).numpy().dtype for t in v] if isinstance(v, list)
               else torch.empty(0, dtype=v).numpy().dtype for k, v in _state_dtypes(port_metric).items()}
        assert got == want, (stage, got, want)
        assert all(d == np.float32 for v in got.values() for d in (v if isinstance(v, list) else [v])), stage
        _quiet(jax_metric.update, jnp.asarray(preds), jnp.asarray(target))
        _quiet(port_metric.update, torch.from_numpy(preds), torch.from_numpy(target))


def _moments_metric(lib, name, kwargs, batch):
    metric = getattr(lib, name)(**kwargs, **({"device": "cpu"} if lib is port_reg else {}))
    as_array = torch.from_numpy if lib is port_reg else jnp.asarray
    metric.update(as_array(DATA["2d"][0][batch]), as_array(DATA["2d"][1][batch]))
    return metric


@pytest.mark.parametrize("name, kwargs", [("PearsonCorrCoef", {"num_outputs": 3}),
                                          ("ConcordanceCorrCoef", {"num_outputs": 3}),
                                          ("NormalizedRootMeanSquaredError", {"num_outputs": 3, "normalization": "std"})])
def test_merge_state_is_the_jax_merge(name, kwargs):
    """``merge_state`` of two metrics, each over its own batch, against the JAX
    package's ``_merge`` of the same two states; then the value."""
    jax_a, jax_b = (_moments_metric(jax_reg, name, kwargs, i) for i in (0, 1))
    port_a, port_b = (_moments_metric(port_reg, name, kwargs, i) for i in (0, 1))
    want = jax_a._merge(dict(jax_a._state), dict(jax_b._state))
    port_a.merge_state(port_b)
    for key, value in want.items():
        _assert_close(port_a._state[key], value, SUM_RTOL, SUM_ATOL, bitwise=key in EXACT_STATES, ctx=key)
    jax_a.merge_state(jax_b)
    _assert_close(_quiet(port_a.compute), _quiet(jax_a.compute), ctx="merged value")


def test_nrmse_std_is_the_population_std_of_jnp():
    """``normalization="std"`` divides by ``n``, as ``jnp.std`` does: torch.std's default
    (``n - 1``) would differ at the fourth digit on 1,000 samples."""
    rng = np.random.default_rng(3)
    target = (3 * rng.normal(size=1000) + 1).astype(np.float32)
    preds = (target + rng.normal(size=1000)).astype(np.float32)
    nrmse_mod = importlib.import_module("torchmetrics_tpu_torch.functional.regression.nrmse")
    _, _, denom = nrmse_mod._normalized_root_mean_squared_error_update(torch.from_numpy(preds),
                                                                       torch.from_numpy(target), 1, "std")
    np.testing.assert_allclose(float(denom), float(jnp.std(jnp.asarray(target))), rtol=1e-6)
    assert abs(float(denom) - float(torch.from_numpy(target).std())) > 1e-4
    want = jax_fn.normalized_root_mean_squared_error(jnp.asarray(preds), jnp.asarray(target), normalization="std")
    got = port_fn.normalized_root_mean_squared_error(torch.from_numpy(preds), torch.from_numpy(target),
                                                     normalization="std")
    _assert_close(got, want, rtol=1e-6)


def test_adjusted_r2_falls_back_with_the_warning():
    """More regressors than samples allow: both warn and return the plain R2."""
    preds, target = DATA["normal"][0][0, :5], DATA["normal"][1][0, :5]
    with pytest.warns(UserWarning, match="More independent regressions than data points"):
        want = jax_fn.r2_score(jnp.asarray(preds), jnp.asarray(target), adjusted=10)
    with pytest.warns(UserWarning, match="More independent regressions than data points"):
        got = port_fn.r2_score(torch.from_numpy(preds), torch.from_numpy(target), adjusted=10)
    _assert_close(got, want)
    _assert_close(got, port_fn.r2_score(torch.from_numpy(preds), torch.from_numpy(target)), bitwise=True)


def test_mape_on_zero_targets_hits_the_clip():
    """A zero target is clipped to 1.17e-6: the error is |pred| / 1.17e-6, as in the JAX
    package (intermittent demand: most targets are zero)."""
    rng = np.random.default_rng(4)
    target = np.where(rng.uniform(size=64) < 0.7, 0.0, rng.gamma(2.0, 2.0, 64)).astype(np.float32)
    preds = rng.uniform(0.1, 3.0, 64).astype(np.float32)
    want = jax_fn.mean_absolute_percentage_error(jnp.asarray(preds), jnp.asarray(target))
    got = port_fn.mean_absolute_percentage_error(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_close(got, want)
    assert float(got) > 1e5
    jax_metric, port_metric = jax_reg.MeanAbsolutePercentageError(), port_reg.MeanAbsolutePercentageError(device="cpu")
    for half in (slice(0, 32), slice(32, 64)):
        jax_metric.update(jnp.asarray(preds[half]), jnp.asarray(target[half]))
        port_metric.update(torch.from_numpy(preds[half]), torch.from_numpy(target[half]))
    _assert_states(port_metric, jax_metric)
    _assert_close(port_metric.compute(), jax_metric.compute())


@pytest.mark.parametrize("chunk_rows", [1, 7, 40])
def test_crps_chunks_equal_the_whole_batch(chunk_rows):
    """Chunk boundaries inside the batch change nothing: the per-row sums equal the
    unchunked ones bit for bit and the JAX package's within the tolerance."""
    preds, target = (torch.from_numpy(a[0]) for a in DATA["crps"])
    n, diff, spread = port_crps._crps_update(preds, target, chunk_rows=chunk_rows)
    _, diff_whole, spread_whole = port_crps._crps_update(preds, target)
    _assert_close(diff, _np(diff_whole), bitwise=True)
    _assert_close(spread, _np(spread_whole), bitwise=True)
    _, jax_diff, jax_spread = jax_crps._crps_update(jnp.asarray(DATA["crps"][0][0]), jnp.asarray(DATA["crps"][1][0]))
    _assert_close(diff, jax_diff)
    _assert_close(spread, jax_spread)
    assert n == N


def test_crps_metric_with_chunks_inside_each_update(monkeypatch):
    """The class's update with a chunk of 3 rows (a 1,536-byte budget at 8 members): the
    same states as the JAX package's."""
    monkeypatch.setattr(port_crps, "_CHUNK_BYTES", 3 * 8 * 8 * 8)
    assert port_crps._crps_rows(8) == 3
    jax_metric, port_metric = jax_reg.ContinuousRankedProbabilityScore(), \
        port_reg.ContinuousRankedProbabilityScore(device="cpu")
    for i in range(NB):
        jax_metric.update(jnp.asarray(DATA["crps"][0][i]), jnp.asarray(DATA["crps"][1][i]))
        port_metric.update(torch.from_numpy(DATA["crps"][0][i]), torch.from_numpy(DATA["crps"][1][i]))
    _assert_states(port_metric, jax_metric)
    _assert_close(port_metric.compute(), jax_metric.compute())


@pytest.mark.parametrize("keep_sequence_dim", [None, 0, 1, 2])
def test_csi_counts_with_and_without_the_sequence_dim(keep_sequence_dim):
    """Hits, misses and false alarms equal the JAX package's bit for bit, summed or per
    position of the kept axis (concat states across updates)."""
    preds, target = DATA["seq"]
    kwargs = {"threshold": 0.5, "keep_sequence_dim": keep_sequence_dim}
    port_mod = importlib.import_module("torchmetrics_tpu_torch.functional.regression.csi")
    jax_mod = importlib.import_module("torchmetrics_tpu.functional.regression.csi")
    got = port_mod._critical_success_index_update(torch.from_numpy(preds[0]), torch.from_numpy(target[0]), **kwargs)
    want = jax_mod._critical_success_index_update(jnp.asarray(preds[0]), jnp.asarray(target[0]), **kwargs)
    _assert_close(got, want, bitwise=True)
    jax_metric, port_metric = jax_reg.CriticalSuccessIndex(**kwargs), port_reg.CriticalSuccessIndex(**kwargs,
                                                                                                    device="cpu")
    for i in range(NB):
        jax_metric.update(jnp.asarray(preds[i]), jnp.asarray(target[i]))
        port_metric.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    _assert_states(port_metric, jax_metric)
    _assert_close(port_metric.compute(), jax_metric.compute())


def test_csi_sequence_dim_out_of_range_raises():
    with pytest.raises(ValueError, match="keep_sequence_dim"):
        port_fn.critical_success_index(torch.zeros(4, 3), torch.zeros(4, 3), 0.5, keep_sequence_dim=2)
    with pytest.raises(ValueError, match="keep_sequence_dim"):
        port_reg.CriticalSuccessIndex(0.5, keep_sequence_dim=-1, device="cpu")


def test_log_cosh_has_no_softplus_threshold():
    """At |x| > 10, ``F.softplus``'s threshold of 20 would turn log(cosh(x)) into
    ``x - log 2`` in a way that differs from ``jax.nn.softplus``; the port follows JAX."""
    preds = np.array([30.0, -25.0, 11.0, -0.5], np.float32)
    target = np.zeros(4, np.float32)
    _assert_close(port_fn.log_cosh_error(torch.from_numpy(preds), torch.from_numpy(target)),
                  jax_fn.log_cosh_error(jnp.asarray(preds), jnp.asarray(target)), rtol=1e-6)


@pytest.mark.parametrize("power, preds, target", [(1.0, [0.0, 1.0], [1.0, 1.0]), (1.0, [1.0, 1.0], [-1.0, 1.0]),
                                                  (2.0, [1.0, 1.0], [0.0, 1.0]), (0.5, [1.0, 1.0], [1.0, 1.0])])
def test_tweedie_domain_checks_raise_as_in_the_jax_package(power, preds, target):
    args_jax = (jnp.asarray(preds, jnp.float32), jnp.asarray(target, jnp.float32))
    args_port = (torch.tensor(preds), torch.tensor(target))
    with pytest.raises(ValueError) as want:
        jax_fn.tweedie_deviance_score(*args_jax, power=power)
    with pytest.raises(ValueError) as got:
        port_fn.tweedie_deviance_score(*args_port, power=power)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("build", [
    lambda lib: lib.MeanSquaredError(squared="yes"),
    lambda lib: lib.MinkowskiDistance(p=0.5),
    lambda lib: lib.KLDivergence(reduction="bad"),
    lambda lib: lib.NormalizedRootMeanSquaredError(normalization="bad"),
    lambda lib: lib.R2Score(multioutput="bad"),
    lambda lib: lib.R2Score(adjusted=-1),
    lambda lib: lib.KendallRankCorrCoef(variant="z"),
    lambda lib: lib.KendallRankCorrCoef(t_test=True, alternative="sideways"),
    lambda lib: lib.ExplainedVariance(multioutput="bad"),
    lambda lib: lib.TweedieDevianceScore(power=0.5),
    lambda lib: lib.PearsonCorrCoef(num_outputs=0),
    lambda lib: lib.CosineSimilarity(reduction="bad"),
    lambda lib: lib.JensenShannonDivergence(log_prob="yes"),
], ids=["mse_squared", "minkowski_p", "kl_reduction", "nrmse_normalization", "r2_multioutput", "r2_adjusted",
        "kendall_variant", "kendall_alternative", "ev_multioutput", "tweedie_power", "pearson_outputs",
        "cosine_reduction", "js_log_prob"])
def test_invalid_arguments_raise_the_jax_packages_error(build):
    with pytest.raises(Exception) as want:
        build(jax_reg)
    with pytest.raises(Exception) as got:
        build(CPU_REGRESSION)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_explained_variance_checkpoint_keeps_the_jax_packages_shape_guard():
    """ExplainedVariance registers scalar defaults and folds per-output vectors, so after a
    multi-output update its checkpoint fails the structural guard in both packages alike
    (a quirk kept, not a divergence); the moment metrics' checkpoints round-trip."""
    preds, target = DATA["2d"][0][0], DATA["2d"][1][0]
    errors = []
    for lib, as_array, kw in ((jax_reg, jnp.asarray, {}), (port_reg, torch.from_numpy, {"device": "cpu"})):
        metric = lib.ExplainedVariance(multioutput="raw_values", **kw)
        metric.persistent(True)
        metric.update(as_array(preds), as_array(target))
        with pytest.raises(Exception) as err:
            lib.ExplainedVariance(multioutput="raw_values", **kw).load_state_dict(metric.state_dict())
        errors.append((type(err.value).__name__, str(err.value)))
        pearson = lib.PearsonCorrCoef(num_outputs=3, **kw)
        pearson.persistent(True)
        pearson.update(as_array(preds), as_array(target))
        restored = lib.PearsonCorrCoef(num_outputs=3, **kw)
        restored.load_state_dict(pearson.state_dict())
        np.testing.assert_array_equal(_np(restored.compute()), _np(pearson.compute()))
    assert errors[0] == errors[1] and errors[0][0] == "StateCorruptionError"


@pytest.mark.parametrize("power", [1.5, 3.0])
@pytest.mark.parametrize("zero", [-0.0, 0.0])
def test_tweedie_on_a_signed_zero_prediction_is_the_jax_value(power, zero):
    """torch takes pow(x, -0.5) and pow(x, 0.5) as rsqrt and sqrt, which keep the sign of
    a zero (rsqrt(-0.0) is -inf); the port gives IEEE pow's value there, as jnp.power
    does: at power 1.5 and preds -0.0 both give +inf, and at power 3 (reciprocal and
    square, where torch is IEEE) the sign still decides between inf and NaN."""
    preds, target = np.array([zero, 1.0], np.float32), np.array([1.0, 1.0], np.float32)
    want = jax_fn.tweedie_deviance_score(jnp.asarray(preds), jnp.asarray(target), power=power)
    got = port_fn.tweedie_deviance_score(torch.from_numpy(preds), torch.from_numpy(target), power=power)
    _assert_close(got, want, bitwise=True, ctx="functional")
    jax_metric, port_metric = jax_reg.TweedieDevianceScore(power=power), CPU_REGRESSION.TweedieDevianceScore(power=power)
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    port_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_close(port_metric.compute(), jax_metric.compute(), bitwise=True, ctx="class")
    if power == 1.5 and zero == -0.0:
        assert float(got) == float("inf")


@pytest.mark.parametrize("target", [[-0.0], [-0.0, -0.0], [0.0, -0.0], "floats"],
                         ids=["one_negative_zero", "two_negative_zeros", "mixed_zeros", "floats"])
def test_nrmse_mean_keeps_the_jax_sign_of_zero(target):
    """``jnp.mean`` over one value is that value, so NRMSE over a single target of -0.0
    is -inf in JAX; over two or more values its sum starts from +0.0 (all -0.0 give
    +inf). The port's mean does the same; the class, whose mean folds by Chan's merge,
    agrees with JAX as it did."""
    target = _rng_floats() if target == "floats" else np.array(target, np.float32)
    preds = np.full(target.shape, 0.5, np.float32)
    want = jax_fn.normalized_root_mean_squared_error(jnp.asarray(preds), jnp.asarray(target), normalization="mean")
    got = port_fn.normalized_root_mean_squared_error(torch.from_numpy(preds), torch.from_numpy(target),
                                                     normalization="mean")
    if target.size > 2:
        _assert_close(got, want, ctx="functional")
    else:
        _assert_close(got, want, bitwise=True, ctx="functional")
        jax_metric = jax_reg.NormalizedRootMeanSquaredError(normalization="mean")
        port_metric = CPU_REGRESSION.NormalizedRootMeanSquaredError(normalization="mean")
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        port_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        _assert_close(port_metric.compute(), jax_metric.compute(), bitwise=True, ctx="class")
    if target.tolist() == [-0.0]:
        assert float(got) == -float("inf")


def _rng_floats(n: int = 1000) -> np.ndarray:
    return np.random.default_rng(11).normal(1.0, 2.0, size=n).astype(np.float32)
