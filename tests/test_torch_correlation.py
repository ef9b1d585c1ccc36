"""The port's rank correlations (Spearman, Kendall), cosine similarity and the KL and
Jensen-Shannon divergences against the JAX package, on the CPU.

The same numpy batches, made from a seed, go through the JAX functional and class and
the port's. Tolerances:

- concat states (the samples themselves), Kendall's concordant and discordant pair
  counts, and Spearman's ranks where every tie run's position sum is below 2**24 equal
  the JAX package's bit for bit;
- float sum states (the divergences' measures) within ``SUM_RTOL`` relative;
- values (tau, p-values, Spearman's rho, similarities, divergences) within
  ``VALUE_RTOL`` relative or ``VALUE_ATOL`` absolute;
- on a long run of ties Spearman's ranks equal ``scipy.stats.rankdata`` exactly, where
  the JAX package's float32 run sums are off.
"""

from __future__ import annotations

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu import regression as jax_reg
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch import regression as port_reg

jax_kendall = importlib.import_module("torchmetrics_tpu.functional.regression.kendall")
port_kendall = importlib.import_module("torchmetrics_tpu_torch.functional.regression.kendall")
jax_utils = importlib.import_module("torchmetrics_tpu.functional.regression.utils")
port_utils = importlib.import_module("torchmetrics_tpu_torch.functional.regression.utils")

VALUE_RTOL = 1e-6
VALUE_ATOL = 1e-6
SUM_RTOL = 1e-6  # the divergences' float32 row sums in XLA's order against float64 sums rounded once
NB, N = 3, 40

_rng = np.random.default_rng(11)
_probs = _rng.uniform(0.05, 1.0, size=(2, NB, N, 5))
_probs /= _probs.sum(-1, keepdims=True)
DATA = {
    "normal": (_rng.normal(size=(NB, N)), _rng.normal(size=(NB, N))),
    "ties": (_rng.integers(0, 6, (NB, N)), _rng.integers(0, 4, (NB, N))),
    "2d": (_rng.normal(size=(NB, N, 3)), _rng.normal(size=(NB, N, 3))),
    "embed": (_rng.normal(size=(NB, N, 16)), _rng.normal(size=(NB, N, 16))),
    "probs": (_probs[0], _probs[1]),
    "log_probs": (np.log(_probs[0]), np.log(_probs[1])),
}
DATA["normal"][1][:] += DATA["normal"][0]  # correlated, so tau and rho are far from 0
DATA = {k: tuple(a.astype(np.float32) for a in v) for k, v in DATA.items()}

# (id, class, class kwargs, functional, functional kwargs, data)
CASES = [
    ("spearman", "SpearmanCorrCoef", {}, "spearman_corrcoef", {}, "normal"),
    ("spearman_ties", "SpearmanCorrCoef", {}, "spearman_corrcoef", {}, "ties"),
    ("spearman_3out", "SpearmanCorrCoef", {"num_outputs": 3}, "spearman_corrcoef", {}, "2d"),
    *[(f"kendall_{v}", "KendallRankCorrCoef", {"variant": v}, "kendall_rank_corrcoef", {"variant": v}, "ties")
      for v in ("a", "b", "c")],
    *[(f"kendall_{v}_t_test_{alt}", "KendallRankCorrCoef", {"variant": v, "t_test": True, "alternative": alt},
       "kendall_rank_corrcoef", {"variant": v, "t_test": True, "alternative": alt}, "normal")
      for v, alt in (("a", "two-sided"), ("b", "two-sided"), ("b", "less"), ("c", "greater"))],
    ("kendall_b_3out", "KendallRankCorrCoef", {"t_test": True}, "kendall_rank_corrcoef", {"t_test": True}, "2d"),
    *[(f"cosine_{r}", "CosineSimilarity", {"reduction": r}, "cosine_similarity", {"reduction": r}, "embed")
      for r in ("sum", "mean", "none")],
    *[(f"{name}_{red}_{kind}", cls, {"reduction": red, "log_prob": kind == "log_probs"}, fn,
       {"reduction": red, "log_prob": kind == "log_probs"}, kind)
      for name, cls, fn in (("kl", "KLDivergence", "kl_divergence"),
                            ("js", "JensenShannonDivergence", "jensen_shannon_divergence"))
      for red in ("mean", "sum", None) for kind in ("probs", "log_probs")],
]


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _assert_close(got, want, rtol=VALUE_RTOL, atol=VALUE_ATOL, bitwise=False, ctx=""):
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


def _cat(values):
    return np.concatenate([np.atleast_1d(_np(v)) for v in values])


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_matches_the_jax_package(case):
    """Functional on the whole data; class by ``forward`` per batch (batch values), then
    states (concat states bit for bit, sums within ``SUM_RTOL``) and value."""
    _, cls, cls_kwargs, fn, fn_kwargs, kind = case
    preds, target = DATA[kind]
    whole = [a.reshape(-1, *a.shape[2:]) for a in (preds, target)]
    want = _quiet(getattr(jax_fn, fn), *(jnp.asarray(a) for a in whole), **fn_kwargs)
    got = _quiet(getattr(port_fn, fn), *(torch.from_numpy(a) for a in whole), **fn_kwargs)
    _assert_close(got, want, ctx="functional")

    jax_metric = getattr(jax_reg, cls)(**cls_kwargs)
    port_metric = getattr(port_reg, cls)(**cls_kwargs, device="cpu")
    for i in range(NB):
        want = _quiet(jax_metric, jnp.asarray(preds[i]), jnp.asarray(target[i]))
        got = _quiet(port_metric, torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
        _assert_close(got, want, ctx=f"forward {i}")
    for name, value in jax_metric._state.items():
        mine = port_metric._state[name]
        if isinstance(value, list):
            assert all(t.dtype == torch.float32 for t in mine)
            _assert_close(torch.from_numpy(_cat(mine)), _cat(value), bitwise=name != "measures", ctx=name)
        else:
            _assert_close(mine, value, SUM_RTOL, bitwise=name == "total", ctx=name)
    _assert_close(_quiet(port_metric.compute), _quiet(jax_metric.compute), ctx="compute")


def _kendall_data(n: int, seed: int = 5):
    """Metric scores and human scores in whole points (many ties), correlated, with a few
    NaN in each."""
    rng = np.random.default_rng(seed)
    human = rng.integers(0, 101, n).astype(np.float32)
    metric = (human + rng.normal(0, 25, n)).astype(np.float32)
    metric[rng.integers(0, n, 5)] = np.nan
    human[rng.integers(0, n, 5)] = np.nan
    return metric, human


@pytest.mark.parametrize("group_elems", [1 << 22, 1 << 24])
def test_kendall_pair_counts_equal_the_jax_package_bit_for_bit(monkeypatch, group_elems):
    """At n = 8,000 the JAX package cuts 16 blocks of 524 rows and its float32 total of
    the concordant pairs passes 2**24, so it rounds: the port's block counts folded in
    the same order give the same bits, with one block or four per launch."""
    monkeypatch.setattr(port_kendall, "_GROUP_ELEMS", group_elems)
    x, y = _kendall_data(8000)
    assert port_kendall._block_rows(8000) == 524
    con, dis = port_kendall._pair_counts(torch.from_numpy(x), torch.from_numpy(y))
    want_con, want_dis = jax_kendall._pair_counts(jnp.asarray(x), jnp.asarray(y))
    _assert_close(con, want_con, bitwise=True, ctx="concordant")
    _assert_close(dis, want_dis, bitwise=True, ctx="discordant")
    assert float(con) > 2**24
    blocks_con, blocks_dis = port_kendall._block_pair_counts(torch.from_numpy(x), torch.from_numpy(y))
    assert len(blocks_con) == 16 and blocks_con.dtype == torch.int64
    assert float(con) != float(blocks_con.sum())  # the float32 fold rounded: the exact total differs


def test_kendall_block_counts_are_the_exact_pair_counts():
    """Against a brute-force count over every pair i < j, with ties and NaN."""
    x, y = _kendall_data(300, seed=8)
    x[:40] = np.round(x[:40] / 10) * 10
    sx = np.sign(x[:, None] - x[None, :])
    sy = np.sign(y[:, None] - y[None, :])
    upper = np.triu(np.ones((300, 300), bool), 1)
    prod = np.where(upper, np.nan_to_num(sx * sy), 0)
    con, dis = port_kendall._block_pair_counts(torch.from_numpy(x), torch.from_numpy(y))
    assert (int(con.sum()), int(dis.sum())) == (int((prod > 0).sum()), int((prod < 0).sum()))


def test_kendall_tie_statistics_match_the_jax_package():
    x, _ = _kendall_data(2000)
    got = port_kendall._tie_stats(torch.from_numpy(x))
    want = jax_kendall._tie_stats(jnp.asarray(x))
    _assert_close(list(got[:3]), list(want[:3]), rtol=1e-6)
    assert float(got[3]) == float(want[3])


@pytest.mark.parametrize("variant, alternative", [("b", "two-sided"), ("c", "greater"), ("a", "less")])
def test_kendall_at_scale_with_ties_and_nan(variant, alternative):
    """tau and the p-value on the 8,000 pairs of the bit-for-bit test."""
    x, y = _kendall_data(8000)
    want = jax_fn.kendall_rank_corrcoef(jnp.asarray(x), jnp.asarray(y), variant=variant, t_test=True,
                                        alternative=alternative)
    got = port_fn.kendall_rank_corrcoef(torch.from_numpy(x), torch.from_numpy(y), variant=variant, t_test=True,
                                        alternative=alternative)
    _assert_close(got, want)


def test_rank_data_equals_the_jax_package_where_its_run_sums_are_exact():
    """Small tie runs, NaN, signed zeros, a 2-D batch of rows: the same float32 ranks."""
    rng = np.random.default_rng(2)
    x = rng.integers(-5, 6, (4, 500)).astype(np.float32)
    x[0, :3] = np.nan
    x[1, 10:20] = -0.0
    got = port_utils._rank_data(torch.from_numpy(x))
    for row in range(4):
        _assert_close(got[row], jax_utils._rank_data(jnp.asarray(x[row])), bitwise=True, ctx=f"row {row}")


def test_rank_data_of_a_long_zero_run_is_scipys():
    """M5-shaped demand, 68% zeros: the zero run's mean rank is exact here and off in the
    JAX package, whose float32 segment sum of 68,000 positions rounds; Spearman still
    agrees within 1e-6."""
    rng = np.random.default_rng(6)
    n = 100_000
    target = np.where(rng.uniform(size=n) < 0.68, 0.0, rng.gamma(1.5, 3.0, n)).astype(np.float32)
    preds = (target + rng.uniform(0.0, 2.0, n)).astype(np.float32)
    got = port_utils._rank_data(torch.from_numpy(target)).numpy()
    np.testing.assert_array_equal(got, scipy.stats.rankdata(target).astype(np.float32))
    jax_ranks = np.asarray(jax_utils._rank_data(jnp.asarray(target)))
    assert np.abs(jax_ranks - got).max() > 0.25  # the JAX package's float32 run sum rounded
    want = jax_fn.spearman_corrcoef(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(port_fn.spearman_corrcoef(torch.from_numpy(preds), torch.from_numpy(target)), want)
    np.testing.assert_allclose(float(port_fn.spearman_corrcoef(torch.from_numpy(preds), torch.from_numpy(target))),
                               scipy.stats.spearmanr(preds, target)[0], rtol=1e-6)


def test_spearman_rejects_integer_inputs():
    with pytest.raises(TypeError):
        port_fn.spearman_corrcoef(torch.arange(4), torch.arange(4))
