"""The port's pairwise distances and Procrustes disparity against the JAX package, on
the CPU.

The same numpy inputs, made from a seed, go through the JAX package and the port.
Tolerances, each from the float32 error of the JAX package's own arithmetic (the port
computes in float64 and rounds once, so its own error is one rounding):

- products (linear, cosine): JAX's float32 dot product of D terms errs by at most
  ``D * u * sum|x_k y_k|`` (u = 2**-24); the port by ``u`` of the value. They agree
  within ``(D + 4) * u * (|x| @ |y|.T)``, the 4 covering cosine's row norms;
- euclidean: the squares' norms and product each err by ``D * u`` of their size and the
  sum by two roundings, so the squares agree within
  ``e = (D + 4) * u * (|x|^2 + |y|^2 + 2 |x| @ |y|.T)`` (the identity's cancellation
  error is in both results), and the roots within ``sqrt(e)`` and the root's rounding;
- manhattan and minkowski: sums of positive terms, so relative ``(D + 6) * u``;
- integers: linear and manhattan exact (int32), euclidean bit for bit;
- reductions: the reduced bound plus ``(M + 1) * u`` of the reduced magnitudes;
- Procrustes (the port's Jacobi SVD at D <= 3, ``torch.linalg.svd`` at D = 4, 16 and
  64): disparity and scale within 1e-5 relative and 1e-6 absolute. The clouds are
  centred and of unit norm, so the JAX package's float32 steps leave noise near 1e-7:
  a disparity it gives as 7.1e-15 is that noise, held absolutely. The rotation is held
  where the singular values are at least 1e-3 apart (and from zero) within
  ``1e-6 / gap``: a rotation's error is the inputs' float32 noise over the gap. Where
  they coincide it is not unique, and the port's rotation must give JAX's disparity.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError, TorchMetricsUserError

port_helpers = importlib.import_module("torchmetrics_tpu_torch.functional.pairwise.helpers")
port_procrustes = importlib.import_module("torchmetrics_tpu_torch.functional.shape.procrustes")

CPU = {"device": "cpu"}
U = 2.0**-24
_RNG = np.random.default_rng(7)
X = _RNG.normal(size=(12, 6)).astype(np.float32)
Y = _RNG.normal(size=(9, 6)).astype(np.float32)
X_ZERO_ROW = X.copy()
X_ZERO_ROW[3] = 0.0
XI = _RNG.integers(-9, 10, size=(12, 6))
YI = _RNG.integers(-9, 10, size=(9, 6))
NAMES = ("cosine", "euclidean", "linear", "manhattan", "minkowski")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(name: str, x, y=None, **kw):
    """(JAX result, port result) of ``pairwise_<name>`` on the same numpy inputs."""
    fn = {"cosine": "pairwise_cosine_similarity", "euclidean": "pairwise_euclidean_distance",
          "linear": "pairwise_linear_similarity", "manhattan": "pairwise_manhattan_distance",
          "minkowski": "pairwise_minkowski_distance"}[name]
    jax_args = [jnp.asarray(x)] + ([] if y is None else [jnp.asarray(y)])
    port_args = [torch.from_numpy(x)] + ([] if y is None else [torch.from_numpy(y)])
    return _np(getattr(jax_fn, fn)(*jax_args, **kw)), _np(getattr(port_fn, fn)(*port_args, **kw))


def _bound(name: str, x, y, exponent=2) -> np.ndarray:
    """The elementwise bound (module docstring) before any reduction, in float64."""
    x64, y64 = np.asarray(x, np.float64), np.asarray(y if y is not None else x, np.float64)
    d = x64.shape[1]
    if name == "cosine":
        x64 = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
        y64 = y64 / np.linalg.norm(y64, axis=1, keepdims=True)
    dots = np.abs(x64) @ np.abs(y64).T
    if name in ("cosine", "linear"):
        return (d + 4) * U * dots
    if name == "euclidean":
        squares = (x64**2).sum(1)[:, None] + (y64**2).sum(1)[None]
        distance = np.sqrt(np.clip(squares - 2 * x64 @ y64.T, 0, None))
        return np.sqrt((d + 4) * U * (squares + 2 * dots)) + 2 * U * distance
    p = 1 if name == "manhattan" else exponent
    value = (np.abs(x64[:, None] - y64[None]) ** p).sum(-1) ** (1 / p)
    return (d + 6) * U * value


def _hold(name: str, jax_out, port_out, bound, reduction=None) -> None:
    assert port_out.dtype == jax_out.dtype and port_out.shape == jax_out.shape, (port_out.dtype, jax_out.dtype)
    got, want = port_out.astype(np.float64), jax_out.astype(np.float64)
    if reduction is not None:
        m = bound.shape[-1]
        bound = bound.sum(-1) + (m + 1) * U * np.abs(want) * (m if reduction == "mean" else 1)
        if reduction == "mean":
            bound = bound / m
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    assert np.all(np.abs(got - want)[keep] <= np.broadcast_to(bound, want.shape)[keep] + 1e-30), \
        f"{name}: {np.abs(got - want).max()} beyond {bound.max()}"


@pytest.mark.parametrize("reduction", [None, "mean", "sum"])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("with_y", [True, False])
def test_float_distances_within_the_jax_packages_float32_error(name, with_y, reduction):
    y = Y if with_y else None
    kw = {"exponent": 3} if name == "minkowski" else {}
    jax_out, port_out = _pair(name, X, y, reduction=reduction, **kw)
    bound = _bound(name, X, y, **kw)
    if not with_y:
        np.fill_diagonal(bound, 0.0)
    _hold(name, jax_out, port_out, bound, reduction)


@pytest.mark.parametrize("exponent", [1, 2, 3, 4.5])
def test_minkowski_exponents(exponent):
    jax_out, port_out = _pair("minkowski", X, Y, exponent=exponent)
    _hold("minkowski", jax_out, port_out, _bound("minkowski", X, Y, exponent))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("zero_diagonal", [True, False])
@pytest.mark.parametrize("with_y", [True, False])
def test_zero_diagonal_both_ways(name, zero_diagonal, with_y):
    """``zero_diagonal`` given explicitly: on a square self-comparison and on a 12 x 9
    pair, where the first ``min(N, M)`` diagonal entries are zeroed."""
    y = Y if with_y else None
    jax_out, port_out = _pair(name, X, y, zero_diagonal=zero_diagonal)
    bound = _bound(name, X, y)
    if zero_diagonal:
        np.fill_diagonal(bound, 0.0)
        assert np.all(np.diagonal(port_out) == 0)
    _hold(name, jax_out, port_out, bound)


@pytest.mark.parametrize("reduction", [None, "sum", "mean"])
@pytest.mark.parametrize("name", NAMES)
def test_integer_inputs_take_the_jax_packages_dtypes(name, reduction):
    """int64 inputs: linear and manhattan are int32 and exact (their sums too; their
    means float32), the euclidean root of the exact int32 square bit for bit, cosine and
    minkowski float32."""
    jax_out, port_out = _pair(name, XI, YI, reduction=reduction)
    assert port_out.dtype == jax_out.dtype
    if (name in ("linear", "manhattan") and reduction != "mean") or (name == "euclidean" and reduction is None):
        np.testing.assert_array_equal(port_out, jax_out)
    else:
        bound = _bound(name, XI.astype(np.float32), YI.astype(np.float32))
        _hold(name, jax_out, port_out, bound, reduction)


def test_euclidean_clips_the_identitys_cancellation_at_zero():
    """Far from the origin, a row against a copy moved by 1e-3 cancels to a negative
    square in float32 (three of the sixteen here); the clip makes it 0, never NaN."""
    rng = np.random.default_rng(13)
    far = (1000.0 + rng.normal(size=(16, 6))).astype(np.float32)
    near = (far + 1e-3 * rng.normal(size=far.shape)).astype(np.float32)
    jax_out, port_out = _pair("euclidean", far, near)
    assert not np.isnan(port_out).any() and np.all(port_out >= 0)
    assert np.sum(np.diagonal(port_out) == 0) >= 3
    _hold("euclidean", jax_out, port_out, _bound("euclidean", far, near))


def test_cosine_of_a_zero_row_is_nan_as_in_the_jax_package():
    jax_out, port_out = _pair("cosine", X_ZERO_ROW, Y)
    assert np.isnan(port_out[3]).all() and np.isnan(jax_out[3]).all()
    _hold("cosine", jax_out, port_out, _bound("cosine", X, Y))
    jax_self, port_self = _pair("cosine", X_ZERO_ROW)  # the zeroed diagonal overwrites the row's own NaN
    assert port_self[3, 3] == 0 and np.isnan(port_self[3, :3]).all()
    np.testing.assert_array_equal(np.isnan(port_self), np.isnan(jax_self))


@pytest.mark.parametrize("name", NAMES)
def test_row_blocks_give_the_same_bits(monkeypatch, name):
    """Blocks of one or two rows (a tiny chunk budget) give the one-block result."""
    whole = getattr(port_fn, f"pairwise_{'cosine_similarity' if name == 'cosine' else 'linear_similarity' if name == 'linear' else name + '_distance'}")
    args = (torch.from_numpy(X), torch.from_numpy(Y))
    expected = [whole(*args), whole(*args, reduction="sum")]
    monkeypatch.setattr(port_helpers, "_CHUNK_BYTES", 200)
    assert len(port_helpers._row_blocks(12, 100)) == 6
    got = [whole(*args), whole(*args, reduction="sum")]
    for g, e in zip(got, expected):
        assert torch.equal(g, e)


def test_row_blocks_cover_the_rows_once():
    blocks = port_helpers._row_blocks(10, port_helpers._CHUNK_BYTES // 3)
    assert [(b.start, b.stop) for b in blocks] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert port_helpers._row_blocks(0, 8) == [slice(0, 0)]


@pytest.mark.parametrize(
    "call",
    [
        lambda f, a: f.pairwise_cosine_similarity(a(np.zeros(3, np.float32))),
        lambda f, a: f.pairwise_euclidean_distance(a(np.zeros((3, 2), np.float32)), a(np.zeros((3, 4), np.float32))),
        lambda f, a: f.pairwise_linear_similarity(a(np.zeros((3, 2), np.float32)), reduction="bad"),
        lambda f, a: f.pairwise_manhattan_distance(a(np.zeros((3, 2), np.float32)), a(np.zeros(2, np.float32))),
    ],
    ids=["x_1d", "y_width", "reduction", "y_1d"],
)
def test_validation_errors_like_the_jax_package(call):
    with pytest.raises(ValueError) as jax_err:
        call(jax_fn, jnp.asarray)
    with pytest.raises(ValueError) as port_err:
        call(port_fn, torch.from_numpy)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("exponent", [0.5, "3", 0])
def test_minkowski_exponent_below_one_or_not_a_number_raises(exponent):
    from torchmetrics_tpu.utilities.exceptions import TorchMetricsUserError as JaxUserError

    with pytest.raises(JaxUserError) as jax_err:
        jax_fn.pairwise_minkowski_distance(jnp.asarray(X), exponent=exponent)
    with pytest.raises(TorchMetricsUserError) as port_err:
        port_fn.pairwise_minkowski_distance(torch.from_numpy(X), exponent=exponent)
    assert str(port_err.value) == str(jax_err.value)


def test_products_do_not_change_with_tf32():
    """The products are float64: the TF32 switch (a no-op on the CPU, held on the card by
    chip_smoke.py) cannot reach them."""
    args = (torch.from_numpy(X), torch.from_numpy(Y))
    before = [port_fn.pairwise_linear_similarity(*args), port_fn.pairwise_euclidean_distance(*args)]
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        after = [port_fn.pairwise_linear_similarity(*args), port_fn.pairwise_euclidean_distance(*args)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert all(torch.equal(a, b) for a, b in zip(before, after))


# ------------------------------------------------------------------ Procrustes


def _poses(rng, batch: int = 48, joints: int = 17, dim: int = 3, planar: int = 4):
    """Pose pairs: the second a rotated, scaled, noisy copy; the first ``planar`` pairs
    lie in a plane (a zero singular value)."""
    p1 = rng.normal(size=(batch, joints, dim)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(dim, dim)))[0]
    p2 = (1.7 * p1 @ rot.T + 0.05 * rng.normal(size=p1.shape)).astype(np.float32)
    p1[:planar, :, -1] = 0.0
    p2[:planar, :, -1] = 0.0
    return p1, p2


POSES = _poses(np.random.default_rng(11))
# wider clouds, whose SVD is torch.linalg.svd's: 6 clouds of 80 points at D = 4, 16 and 64
WIDE = {dim: _poses(np.random.default_rng(13 + dim), batch=6, joints=80, dim=dim, planar=1) for dim in (4, 16, 64)}
SQUARES = (np.asarray([[[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]] * 2, np.float32),
           np.asarray([[[0.0, 0.0], [2.0, 0.0], [2.0, 2.0], [0.0, 2.0]],
                       [[0.0, 0.0], [0.0, 3.0], [-3.0, 3.0], [-3.0, 0.0]]], np.float32))
DISPARITY_RTOL, DISPARITY_ATOL = 1e-5, 1e-6


def _normalised(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.float64) - p.astype(np.float64).mean(1, keepdims=True)
    return p / np.linalg.norm(p, axis=(1, 2), keepdims=True)


def _singular_gaps(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Per sample: the least gap between sorted singular values, zero included."""
    a = np.swapaxes(np.swapaxes(_normalised(p2), 1, 2) @ _normalised(p1), 1, 2)
    w = np.linalg.svd(a, compute_uv=False)
    return np.min(-np.diff(np.concatenate([w, np.zeros((w.shape[0], 1))], 1), axis=1), axis=1)


@pytest.mark.parametrize("clouds", [POSES, SQUARES, *WIDE.values()], ids=["poses", "squares", "d4", "d16", "d64"])
def test_procrustes_matches_the_jax_package(clouds):
    p1, p2 = clouds
    jax_out = [np.asarray(v) for v in jax_fn.procrustes_disparity(jnp.asarray(p1), jnp.asarray(p2), return_all=True)]
    port_out = [_np(v) for v in port_fn.procrustes_disparity(torch.from_numpy(p1), torch.from_numpy(p2),
                                                               return_all=True)]
    for got, want in zip(port_out, jax_out):
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    for got, want in zip(port_out[:2], jax_out[:2]):
        np.testing.assert_allclose(got, want, rtol=DISPARITY_RTOL, atol=DISPARITY_ATOL)
    gaps = _singular_gaps(p1, p2)
    distinct = gaps > 1e-3
    rotation_diff = np.abs(port_out[2] - jax_out[2]).max((1, 2))
    assert np.all(rotation_diff[distinct] <= 1e-6 / gaps[distinct])
    # where the rotation is not unique, the port's rotation gives the JAX package's disparity
    rot, scale = port_out[2].astype(np.float64), port_out[1].astype(np.float64)
    n1, n2 = _normalised(p1), _normalised(p2)
    disparity = ((n1 - scale[:, None] * (n2 @ np.swapaxes(rot, 1, 2))) ** 2).sum((1, 2))
    np.testing.assert_allclose(disparity, jax_out[0], rtol=DISPARITY_RTOL, atol=DISPARITY_ATOL)
    assert np.all(np.abs(np.swapaxes(rot, 1, 2) @ rot - np.eye(rot.shape[-1])) < 1e-6)  # orthogonal everywhere
    if clouds is SQUARES:
        assert not distinct.any() and jax_out[0].max() < 1e-12  # the doctest's 7.1e-15 is float32 noise


def test_procrustes_planar_poses_have_a_zero_singular_value():
    gaps = _singular_gaps(*POSES)
    assert np.all(gaps[:4] < 1e-6) and np.all(gaps[4:] > 1e-3)


@pytest.mark.parametrize("dim", [2, 3])
def test_jacobi_svd_of_degenerate_matrices(dim):
    """Random matrices and rank-deficient, scaled-identity, zero, clustered and
    dominated ones: ``u`` and ``vt`` orthogonal, ``u diag(w) vt`` the matrix, ``w``
    LAPACK's singular values, all to float64 precision after the fixed sweeps."""
    rng = np.random.default_rng(3 + dim)
    a = rng.normal(size=(4000, dim, dim))
    a[0, -1] = 0.0
    a[1] = 2 * np.eye(dim)
    a[2] = 0.0
    a[3, :, 0] = a[3, :, 1]
    q1, q2 = (np.linalg.qr(rng.normal(size=(1000, dim, dim)))[0] for _ in range(2))
    clustered = 1 + 1e-6 * rng.normal(size=(1000, dim))
    dominated = np.concatenate([np.full((1000, 1), 1e3), np.ones((1000, dim - 1))], 1)
    a[1000:2000] = q1 @ (clustered[:, :, None] * q2)
    a[2000:3000] = q1 @ (dominated[:, :, None] * q2)
    u, w, vt = port_procrustes._jacobi_svd(torch.from_numpy(a))
    u, w, vt = _np(u), _np(w), _np(vt)
    np.testing.assert_allclose(u @ (w[:, :, None] * vt), a, atol=1e-12)
    for m in (u, vt):
        np.testing.assert_allclose(np.swapaxes(m, 1, 2) @ m, np.broadcast_to(np.eye(dim), m.shape), atol=1e-12)
    np.testing.assert_allclose(np.sort(w, 1)[:, ::-1], np.linalg.svd(a, compute_uv=False), rtol=1e-12,
                               atol=1e-12)


def test_jacobi_svd_refuses_what_its_sweeps_were_not_measured_on():
    with pytest.raises(ValueError, match="up to 3x3"):
        port_procrustes._jacobi_svd(torch.zeros(1, 4, 4, dtype=torch.float64))


def test_procrustes_validation_like_the_jax_package():
    for p1, p2, kind in ((np.zeros((2, 3, 2)), np.zeros((2, 3, 3)), RuntimeError),
                         (np.zeros((3, 2)), np.zeros((3, 2)), ValueError)):
        with pytest.raises(kind) as jax_err:
            jax_fn.procrustes_disparity(jnp.asarray(p1), jnp.asarray(p2))
        with pytest.raises(kind) as port_err:
            port_fn.procrustes_disparity(torch.from_numpy(p1), torch.from_numpy(p2))
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_procrustes_class_matches_the_jax_package(reduction):
    p1, p2 = POSES
    jax_metric = jtm.ProcrustesDisparity(reduction=reduction)
    port_metric = ttm.ProcrustesDisparity(reduction=reduction, **CPU)
    assert {k: v.dtype for k, v in port_metric._state.items()} == {"disparity": torch.float32, "total": torch.int32}
    halves = np.split(np.arange(p1.shape[0]), 2)
    for part in halves:
        jax_metric.update(jnp.asarray(p1[part]), jnp.asarray(p2[part]))
        batch_value = port_metric(torch.from_numpy(p1[part]), torch.from_numpy(p2[part]))
        alone = ttm.ProcrustesDisparity(reduction=reduction, **CPU)
        alone.update(torch.from_numpy(p1[part]), torch.from_numpy(p2[part]))
        assert torch.equal(batch_value, alone.compute())
    assert int(port_metric.total) == int(jax_metric._state["total"]) == p1.shape[0]
    np.testing.assert_allclose(_np(port_metric.disparity), np.asarray(jax_metric._state["disparity"]),
                               rtol=DISPARITY_RTOL, atol=DISPARITY_ATOL)
    np.testing.assert_allclose(_np(port_metric.compute()), np.asarray(jax_metric.compute()),
                               rtol=DISPARITY_RTOL, atol=DISPARITY_ATOL)
    # merge of two halves, and the JAX package's checkpoint loaded into the port
    a, b = (ttm.ProcrustesDisparity(reduction=reduction, **CPU) for _ in range(2))
    for metric, part in zip((a, b), halves):
        metric.update(torch.from_numpy(p1[part]), torch.from_numpy(p2[part]))
    a.merge_state(b)
    assert torch.equal(a.compute(), port_metric.compute())
    jax_metric.persistent(True)
    restored = ttm.ProcrustesDisparity(reduction=reduction, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    assert np.asarray(jax_metric._state["disparity"]) == _np(restored.disparity)
    assert restored.total.dtype == torch.int32
    with pytest.raises(StateCorruptionError):
        ttm.ProcrustesDisparity(**CPU).load_state_dict({k: v for k, v in jax_metric.state_dict().items()
                                                        if k != "total"})


def test_procrustes_class_reduction_error_like_the_jax_package():
    with pytest.raises(ValueError) as jax_err:
        jtm.ProcrustesDisparity(reduction="max")
    with pytest.raises(ValueError) as port_err:
        ttm.ProcrustesDisparity(reduction="max", **CPU)
    assert str(port_err.value) == str(jax_err.value)
