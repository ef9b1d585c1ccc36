"""The port's tensor-math audio metrics against the JAX package, on the CPU: SNR, SI-SNR,
C-SI-SNR, SI-SDR, SA-SDR, SDR and PIT as functions and classes, the PESQ and STOI gates,
and the exports of ``audio`` and ``functional.audio``.

The same numpy inputs, made from a seed, go through the JAX package and the port
(``device="cpu"``): 3 samples of 2 speakers of 256 samples (two batches), PIT also at
3, 4 and 5 speakers of 128 samples, C-SI-SNR on ``(3, 9, 12, 2)`` spectra.

Tolerances, with ``u = 2**-24``:

- dB values of the SNR family, SA-SDR and PIT within ``32 u`` of their magnitude (at
  least 1): JAX adds the 256 squares in float32 (a few ``u`` relative a sum, pairwise),
  the port in float64 rounded once, and ``10 log10`` turns a relative error ``r`` of a
  ratio into ``4.34 r`` dB; PIT's ``"min"`` picks pairs that barely correlate, whose
  projection's dot product cancels, so there a value ``v`` below 0 dB also gets
  ``8.68 u sqrt(T) 10 ** (-v / 20)`` (the worst seen: 4.4e-4 dB at -45.2 dB, T = 128);
- SDR within 1 unit: both solve in float64 (scipy's Levinson recursion there, an LU
  here), about 1e-11 dB apart, which rounds to the same float32 but at a rounding
  boundary; the port's float64 value within 1e-6 dB of scipy's ``solve_toeplitz``;
- permutations, counts and integer states bit for bit; ``score_sum`` within
  ``32 u`` a summed value.
"""

from __future__ import annotations

import functools
import inspect
import math
import sys
import types

import jax
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch.functional.audio import sdr as port_sdr

CPU = {"device": "cpu"}
U = 2.0**-24
_RNG = np.random.default_rng(1515)
TARGET = _RNG.standard_normal((2, 3, 2, 256)).astype(np.float32)  # two batches
PREDS = (TARGET + 0.3 * _RNG.standard_normal(TARGET.shape)).astype(np.float32)
SPEC = _RNG.standard_normal((2, 3, 9, 12, 2)).astype(np.float32)
SPEC_PREDS = (SPEC + 0.5 * _RNG.standard_normal(SPEC.shape)).astype(np.float32)
# speakers of 128 samples whose predictions come in reversed order, with noise
SPEAKERS = {spk: _RNG.standard_normal((4, spk, 128)).astype(np.float32) for spk in (2, 3, 4, 5)}
SPEAKER_PREDS = {spk: np.ascontiguousarray(t[:, ::-1] + 0.5 * _RNG.standard_normal(t.shape)).astype(np.float32)
                 for spk, t in SPEAKERS.items()}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _bitwise(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    np.testing.assert_array_equal(p, r, err_msg=context)


def _close(port, ref, units: float = 32, context: str = "", samples: int = 0) -> None:
    """Within ``units`` rounding units of the magnitude (at least 1); NaN by place. With
    ``samples``, a dB value ``v`` also gets ``8.68 u sqrt(samples) 10 ** (-v / 20)``: the
    float32 dot product of a projection over that many samples, relative to its value,
    which shrinks as ``10 ** (v / 20)`` (the worst permutation of PIT's ``"min"``)."""
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    p64, r64 = p.astype(np.float64), r.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(p64), np.isnan(r64), err_msg=context)
    keep = ~np.isnan(r64) & (p64 != r64)
    tol = units * U * np.maximum(np.abs(r64), 1.0)
    if samples:
        tol = tol + 8.68 * U * math.sqrt(samples) * 10 ** (-np.minimum(r64, 0) / 20)
    assert np.all(np.abs(p64[keep] - r64[keep]) <= tol[keep]), f"{context}: {p} against {r}"


@functools.lru_cache(maxsize=None)
def _jitted(fn_name: str, kw_items: tuple):
    return jax.jit(functools.partial(getattr(jax_fn, fn_name), **dict(kw_items)))


def _both(fn_name: str, *arrays, **kw):
    """(JAX's value under ``jax.jit``, the port's value) of ``functional.<fn_name>``."""
    return _jitted(fn_name, tuple(sorted(kw.items())))(*arrays), getattr(port_fn, fn_name)(*_t(*arrays), **kw)


# ----------------------------------------------------------------------- SNR family

SNR_CASES = {
    "snr": ("signal_noise_ratio", {}),
    "snr_zero_mean": ("signal_noise_ratio", {"zero_mean": True}),
    "si_snr": ("scale_invariant_signal_noise_ratio", {}),
    "si_sdr": ("scale_invariant_signal_distortion_ratio", {}),
    "si_sdr_zero_mean": ("scale_invariant_signal_distortion_ratio", {"zero_mean": True}),
    "sa_sdr": ("source_aggregated_signal_distortion_ratio", {}),
    "sa_sdr_zero_mean": ("source_aggregated_signal_distortion_ratio", {"zero_mean": True}),
    "sa_sdr_plain": ("source_aggregated_signal_distortion_ratio", {"scale_invariant": False}),
    "sa_sdr_plain_zero_mean": ("source_aggregated_signal_distortion_ratio", {"scale_invariant": False,
                                                                             "zero_mean": True}),
}


@pytest.mark.parametrize("case", sorted(SNR_CASES))
def test_snr_family_matches_the_jax_package(case):
    name, kw = SNR_CASES[case]
    _close(*reversed(_both(name, PREDS[0], TARGET[0], **kw)), context=case)


@pytest.mark.parametrize("zero_mean", [False, True])
def test_complex_si_snr_on_real_pairs_and_complex_dtype(zero_mean):
    want, got = _both("complex_scale_invariant_signal_noise_ratio", SPEC_PREDS[0], SPEC[0], zero_mean=zero_mean)
    _close(got, want, context="real pairs")
    complex_preds = SPEC_PREDS[0, ..., 0] + 1j * SPEC_PREDS[0, ..., 1]  # complex128: complex64 in both packages
    complex_target = SPEC[0, ..., 0] + 1j * SPEC[0, ..., 1]
    jax_complex = jax_fn.complex_scale_invariant_signal_noise_ratio(complex_preds, complex_target, zero_mean=zero_mean)
    port_complex = port_fn.complex_scale_invariant_signal_noise_ratio(*_t(complex_preds, complex_target),
                                                                      zero_mean=zero_mean)
    _close(port_complex, jax_complex, context="complex")
    _close(port_complex, got, units=1, context="complex against pairs")


@pytest.mark.parametrize("shape", [(3, 12, 3), (3, 9, 12, 1), (12, 2)])
def test_complex_si_snr_shape_error_is_the_jax_packages(shape):
    x = np.zeros(shape, np.float32)
    with pytest.raises(RuntimeError) as jax_err:
        jax_fn.complex_scale_invariant_signal_noise_ratio(x, x)
    with pytest.raises(RuntimeError) as port_err:
        port_fn.complex_scale_invariant_signal_noise_ratio(*_t(x, x))
    if len(shape) >= 3:
        assert str(port_err.value) == str(jax_err.value)
    assert "(..., frequency, time, 2)" in str(port_err.value)


def test_float64_input_rounds_to_float32_as_in_the_jax_package():
    preds, target = PREDS[0].astype(np.float64) * 1.1, TARGET[0].astype(np.float64)
    for name in ("signal_noise_ratio", "scale_invariant_signal_distortion_ratio",
                 "source_aggregated_signal_distortion_ratio"):
        want = getattr(jax_fn, name)(preds, target)
        got = getattr(port_fn, name)(*_t(preds, target))
        assert got.dtype == torch.float32
        _close(got, want, context=name)


@pytest.mark.parametrize("name", ["signal_noise_ratio", "scale_invariant_signal_distortion_ratio",
                                  "scale_invariant_signal_noise_ratio", "source_aggregated_signal_distortion_ratio"])
def test_integer_input_raises_as_jnp_finfo_does(name):
    x = np.arange(8, dtype=np.int32).reshape(2, 4)
    with pytest.raises(ValueError, match="not inexact"):
        getattr(jax_fn, name)(x, x)
    with pytest.raises(ValueError, match="not inexact"):
        getattr(port_fn, name)(*_t(x, x))


def test_shape_errors_are_the_jax_packages():
    a, b = np.zeros((2, 8), np.float32), np.zeros((2, 9), np.float32)
    for name in ("signal_noise_ratio", "scale_invariant_signal_distortion_ratio", "signal_distortion_ratio"):
        with pytest.raises(RuntimeError, match="same shape"):
            getattr(jax_fn, name)(a, b)
        with pytest.raises(RuntimeError, match="same shape"):
            getattr(port_fn, name)(*_t(a, b))
    one = np.zeros(8, np.float32)
    with pytest.raises(RuntimeError) as jax_err:
        jax_fn.source_aggregated_signal_distortion_ratio(one, one)
    with pytest.raises(RuntimeError) as port_err:
        port_fn.source_aggregated_signal_distortion_ratio(*_t(one, one))
    assert str(port_err.value) == str(jax_err.value).replace("(8,)", "torch.Size([8])")


# ------------------------------------------------------------------------------ SDR

def _levinson_sdr(preds, target, filter_length: int, zero_mean: bool = False, load_diag=None) -> np.ndarray:
    """The JAX package's float64 SDR (scipy's Levinson solve) before its float32 rounding."""
    from scipy.linalg import solve_toeplitz

    preds, target = np.asarray(preds, np.float64), np.asarray(target, np.float64)
    if zero_mean:
        preds = preds - preds.mean(-1, keepdims=True)
        target = target - target.mean(-1, keepdims=True)
    target = target / np.clip(np.linalg.norm(target, axis=-1, keepdims=True), 1e-6, None)
    preds = preds / np.clip(np.linalg.norm(preds, axis=-1, keepdims=True), 1e-6, None)
    n_fft = 2 ** math.ceil(math.log2(2 * preds.shape[-1] - 1))
    t_fft = np.fft.rfft(target, n=n_fft)
    r_0 = np.fft.irfft(np.abs(t_fft) ** 2, n=n_fft)[..., :filter_length]
    b = np.fft.irfft(np.conj(t_fft) * np.fft.rfft(preds, n=n_fft), n=n_fft)[..., :filter_length]
    if load_diag is not None:
        r_0[..., 0] += load_diag
    flat_r, flat_b = r_0.reshape(-1, filter_length), b.reshape(-1, filter_length)
    coh = np.array([fb @ solve_toeplitz(fr, fb) for fr, fb in zip(flat_r, flat_b)]).reshape(r_0.shape[:-1])
    return 10 * np.log10(coh / (1 - coh))


@pytest.mark.parametrize("filter_length", [16, 64])
@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("load_diag", [None, 0.1])
def test_sdr_matches_the_jax_package_and_scipys_levinson_solve(filter_length, zero_mean, load_diag):
    kw = {"filter_length": filter_length, "zero_mean": zero_mean, "load_diag": load_diag}
    want = jax_fn.signal_distortion_ratio(PREDS[0], TARGET[0], **kw)
    got = port_fn.signal_distortion_ratio(*_t(PREDS[0], TARGET[0]), use_cg_iter=10, **kw)  # accepted, ignored
    _close(got, want, units=1, context="float32")
    db, info = port_sdr._sdr_solve(*_t(PREDS[0], TARGET[0]), **kw)
    assert db.dtype == torch.float64 and not info.any()
    np.testing.assert_allclose(db.numpy(), _levinson_sdr(PREDS[0], TARGET[0], **kw), rtol=0, atol=1e-6)


def test_sdr_of_the_sinusoid_and_float64_input():
    t = np.arange(800, dtype=np.float32)
    preds, target = np.sin(t / 20), np.sin(t / 20 + 0.1)
    for filter_length, value in ((16, 31.780607), (512, 32.214718)):
        got = port_fn.signal_distortion_ratio(*_t(preds, target), filter_length=filter_length)
        assert abs(float(got) - value) < 1e-4
        _close(got, jax_fn.signal_distortion_ratio(preds, target, filter_length=filter_length), units=1)
    # float64 input keeps its precision in both packages (numpy there, float64 here)
    wide = PREDS[0].astype(np.float64) + 1e-9
    _close(port_fn.signal_distortion_ratio(*_t(wide, TARGET[0]), filter_length=32),
           jax_fn.signal_distortion_ratio(wide, TARGET[0], filter_length=32), units=1)


def _silent_or_nan(case: str):
    preds, target = PREDS[0][:, 0, :100].copy(), TARGET[0][:, 0, :100].copy()
    if case == "silent_target":
        target[1] = 0.0
    elif case == "nan_preds":
        preds[2, 7] = np.nan
    elif case == "inf_target":
        target[0, 3] = np.inf
    else:  # a silent row after a NaN row: the first failed system in row order decides
        preds[0, 1] = np.nan
        target[2] = 0.0
    return preds, target


@pytest.mark.parametrize("case", ["silent_target", "nan_preds", "inf_target", "nan_then_silent"])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_sdr_raises_where_the_jax_packages_scipy_solve_raises(case, zero_mean):
    """scipy's ``solve_toeplitz`` raises ``LinAlgError`` on a singular system (a silent
    target) and ``ValueError`` on NaN or infinite input; the port reads its solver's
    flags once a call and raises the same, for the function and the class."""
    preds, target = _silent_or_nan(case)
    with pytest.raises((ValueError, np.linalg.LinAlgError)) as jax_err:
        jax_fn.signal_distortion_ratio(preds, target, filter_length=16, zero_mean=zero_mean)
    with pytest.raises(type(jax_err.value)) as port_err:
        port_fn.signal_distortion_ratio(*_t(preds, target), filter_length=16, zero_mean=zero_mean)
    assert str(port_err.value) == str(jax_err.value)
    metric = ttm.audio.SignalDistortionRatio(filter_length=16, zero_mean=zero_mean, **CPU)
    with pytest.raises(type(jax_err.value), match=str(jax_err.value)):
        metric.update(*_t(preds, target))
    _, flags = port_sdr._sdr_solve(*_t(preds, target), filter_length=16, zero_mean=zero_mean)
    assert flags.dtype == torch.int32 and bool((flags != 0).any())


def test_sdr_with_diagonal_loading_solves_a_silent_target_as_scipy_does():
    preds, target = _silent_or_nan("silent_target")
    want = jax_fn.signal_distortion_ratio(preds, target, filter_length=16, load_diag=0.1)
    _close(port_fn.signal_distortion_ratio(*_t(preds, target), filter_length=16, load_diag=0.1), want, units=1)


def test_sdr_chunks_its_systems(monkeypatch):
    """Chunks of one system give the same values as one batch of all of them."""
    whole = port_fn.signal_distortion_ratio(*_t(PREDS[0], TARGET[0]), filter_length=64)
    monkeypatch.setattr(port_sdr, "_SOLVE_BYTES", 64 * 64 * 8)
    _bitwise(port_fn.signal_distortion_ratio(*_t(PREDS[0], TARGET[0]), filter_length=64), whole)


# ------------------------------------------------------------------------------ PIT

@functools.lru_cache(maxsize=None)
def _jax_pit(spk: int, mode: str, eval_func: str):
    """JAX's PIT over SI-SNR, the metric under ``jax.jit`` (PIT itself caches its
    permutations as arrays, which a trace would leak)."""
    metric = jax.jit(jax_fn.scale_invariant_signal_noise_ratio)
    return functools.partial(jax_fn.permutation_invariant_training, metric_func=metric, mode=mode,
                             eval_func=eval_func)


PIT_CASES = [(spk, mode, ev) for spk in (2, 3, 4, 5) for mode in ("speaker-wise", "permutation-wise")
             for ev in ("max", "min") if spk <= 3 or mode == "speaker-wise"]


@pytest.mark.parametrize("spk, mode, eval_func", PIT_CASES)
def test_pit_matches_the_jax_package(spk, mode, eval_func):
    preds, target = SPEAKER_PREDS[spk], SPEAKERS[spk]
    want_metric, want_perm = _jax_pit(spk, mode, eval_func)(preds, target)
    got_metric, got_perm = port_fn.permutation_invariant_training(
        *_t(preds, target), port_fn.scale_invariant_signal_noise_ratio, mode, eval_func)
    _bitwise(got_perm, want_perm, "permutation")
    _close(got_metric, want_metric, context=f"{spk} {mode} {eval_func}", samples=preds.shape[-1])
    _close(port_fn.pit_permutate(torch.from_numpy(preds), got_perm), jax_fn.pit_permutate(preds, want_perm), units=0)
    if eval_func == "max":  # the reversed order wins
        assert (got_perm.numpy() == np.arange(spk)[::-1]).all()


def _dot(preds, target):
    """A per-sample metric of both packages' arrays: the dot product over time."""
    return (preds * target).sum(-1)


@pytest.mark.parametrize("eval_func", ["max", "min"])
@pytest.mark.parametrize("mode", ["speaker-wise", "permutation-wise"])
def test_pit_nan_and_tie_rows_pick_as_jnp_does(eval_func, mode):
    """Row 0: two speakers the same, so every permutation ties (the first wins); row 1: a
    NaN in one prediction (a NaN permutation wins, as ``jnp.argmax`` picks it); row 2:
    NaN everywhere."""
    target = np.tile(np.eye(3, 4, dtype=np.float32), (3, 1, 1))
    preds = target.copy()
    preds[0, 1] = preds[0, 0]
    target[0, 1] = target[0, 0]
    preds[1, 2, 1] = np.nan
    preds[2] = np.nan
    want = jax_fn.permutation_invariant_training(preds, target, _dot, mode, eval_func)
    got = port_fn.permutation_invariant_training(*_t(preds, target), _dot, mode, eval_func)
    _bitwise(got[1], want[1], "permutation")
    _close(got[0], want[0], units=0)


def test_pit_errors_are_the_jax_packages():
    a = np.zeros((2, 2, 8), np.float32)
    cases = [((a, np.zeros((2, 3, 8), np.float32)), {}), ((a, a), {"eval_func": "mean"}),
             ((a, a), {"mode": "all"}), ((np.zeros(2, np.float32), np.zeros(2, np.float32)), {})]
    for arrays, kw in cases:
        with pytest.raises((RuntimeError, ValueError)) as jax_err:
            jax_fn.permutation_invariant_training(*arrays, _dot, **kw)
        with pytest.raises(jax_err.type) as port_err:
            port_fn.permutation_invariant_training(*_t(*arrays), _dot, **kw)
        assert str(port_err.value) == str(jax_err.value)


# -------------------------------------------------------------------------- classes

def _si_sdr_zero_mean(lib):
    return lambda p, t, zero_mean: getattr(lib, "scale_invariant_signal_distortion_ratio")(p, t, zero_mean=zero_mean)


CLASS_CASES = {
    "snr": ("SignalNoiseRatio", {}, "audio"),
    "snr_zero_mean": ("SignalNoiseRatio", {"zero_mean": True}, "audio"),
    "si_snr": ("ScaleInvariantSignalNoiseRatio", {}, "audio"),
    "c_si_snr": ("ComplexScaleInvariantSignalNoiseRatio", {}, "spec"),
    "si_sdr": ("ScaleInvariantSignalDistortionRatio", {"zero_mean": True}, "audio"),
    "sa_sdr": ("SourceAggregatedSignalDistortionRatio", {}, "audio"),
    "sdr": ("SignalDistortionRatio", {"filter_length": 32}, "audio"),
    "pit": ("PermutationInvariantTraining", {"eval_func": "max"}, "audio"),
    "pit_permutation_wise": ("PermutationInvariantTraining", {"mode": "permutation-wise", "eval_func": "min"},
                             "audio"),
}


def _class_kw(name: str, kw: dict, lib) -> dict:
    if name == "PermutationInvariantTraining":
        return {"metric_func": (jax_fn if lib is jtm else port_fn).scale_invariant_signal_noise_ratio, **kw}
    return kw


def _batches(kind: str) -> list:
    preds, target = (PREDS, TARGET) if kind == "audio" else (SPEC_PREDS, SPEC)
    return [(preds[i], target[i]) for i in range(2)]


def _hold_states(port_metric, jax_metric, case: str) -> None:
    assert set(port_metric._state) == set(jax_metric._state) == {"score_sum", "total"}
    _bitwise(port_metric._state["total"], jax_metric._state["total"], f"{case} total")
    _close(port_metric._state["score_sum"], jax_metric._state["score_sum"], units=64, context=f"{case} score_sum")


@pytest.mark.parametrize("case", sorted(CLASS_CASES))
def test_classes_match_the_jax_package(case):
    """forward on the first batch (its own value), update on the second (states and
    compute over both), merge_state, and a checkpoint from the JAX package loaded into
    the port."""
    name, kw, kind = CLASS_CASES[case]
    batches = _batches(kind)
    jax_metric = getattr(jtm.audio, name)(**_class_kw(name, kw, jtm))
    port_metric = getattr(ttm.audio, name)(**_class_kw(name, kw, ttm), **CPU)
    _close(port_metric(*_t(*batches[0])), jax_metric(*batches[0]), context=f"{case} forward")
    jax_metric.update(*batches[1])
    port_metric.update(*_t(*batches[1]))
    _hold_states(port_metric, jax_metric, case)
    want = jax_metric.compute()
    _close(port_metric.compute(), want, context=case)
    a, b = (getattr(ttm.audio, name)(**_class_kw(name, kw, ttm), **CPU) for _ in range(2))
    a.update(*_t(*batches[0]))
    b.update(*_t(*batches[1]))
    a.merge_state(b)
    _close(a.compute(), want, context=f"{case} merged")
    jax_metric.persistent(True)
    restored = getattr(ttm.audio, name)(**_class_kw(name, kw, ttm), **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _hold_states(restored, jax_metric, f"{case} restored")
    _close(restored.compute(), want, context=f"{case} restored")


def test_state_dtypes_and_jittable_compute_are_the_jax_packages():
    for case, (name, kw, _) in CLASS_CASES.items():
        jax_metric = getattr(jtm.audio, name)(**_class_kw(name, kw, jtm))
        port_metric = getattr(ttm.audio, name)(**_class_kw(name, kw, ttm), **CPU)
        assert port_metric._jittable_compute is jax_metric._jittable_compute, case
        for key, default in port_metric._defaults.items():
            assert _np(default).dtype == np.asarray(jax_metric._state[key]).dtype, (case, key)
            assert tuple(default.shape) == np.asarray(jax_metric._state[key]).shape, (case, key)


def test_pit_class_splits_its_keywords_and_hashes_by_identity():
    """The port's ``Metric`` keywords go to the metric, the rest to ``metric_func``."""
    jax_metric = jtm.audio.PermutationInvariantTraining(_si_sdr_zero_mean(jax_fn), zero_mean=True)
    port_metric = ttm.audio.PermutationInvariantTraining(_si_sdr_zero_mean(port_fn), zero_mean=True,
                                                         sync_on_compute=False, **CPU)
    assert port_metric.kwargs == jax_metric.kwargs == {"zero_mean": True}
    assert port_metric.sync_on_compute is False and port_metric.device == torch.device("cpu")
    _close(port_metric(*_t(PREDS[0], TARGET[0])), jax_metric(PREDS[0], TARGET[0]))
    other = ttm.audio.PermutationInvariantTraining(_si_sdr_zero_mean(port_fn), **CPU)
    assert hash(port_metric) != hash(other) and hash(port_metric) == hash(port_metric)
    with pytest.raises(ValueError, match="eval_func"):
        ttm.audio.PermutationInvariantTraining(_dot, eval_func="mean", **CPU)
    with pytest.raises(ValueError, match="mode"):
        ttm.audio.PermutationInvariantTraining(_dot, mode="all", **CPU)


@pytest.mark.parametrize("name, kw", [("ComplexScaleInvariantSignalNoiseRatio", {"zero_mean": 1}),
                                      ("SourceAggregatedSignalDistortionRatio", {"scale_invariant": 1}),
                                      ("SourceAggregatedSignalDistortionRatio", {"zero_mean": "no"})])
def test_class_argument_errors_are_the_jax_packages(name, kw):
    with pytest.raises(ValueError) as jax_err:
        getattr(jtm.audio, name)(**kw)
    with pytest.raises(ValueError) as port_err:
        getattr(ttm.audio, name)(**kw, **CPU)
    assert str(port_err.value) == str(jax_err.value)


# --------------------------------------------------------------------- PESQ and STOI

def _external(lib):
    import importlib

    root = "torchmetrics_tpu" if lib is jtm else "torchmetrics_tpu_torch"
    return importlib.import_module(f"{root}.functional.audio.external")


@pytest.mark.parametrize("which", ["pesq", "stoi"])
def test_pesq_and_stoi_gates_are_the_jax_packages(which, monkeypatch):
    """Neither wheel is installed: the functions and classes raise the JAX package's
    ``ModuleNotFoundError`` text."""
    flag = "_PESQ_AVAILABLE" if which == "pesq" else "_PYSTOI_AVAILABLE"
    x = np.zeros((2, 1600), np.float32)
    errors = {}
    for lib in (jtm, ttm):
        monkeypatch.setattr(_external(lib), flag, False)
        monkeypatch.setattr(sys.modules[f"{lib.__name__}.audio.metrics"], flag, False, raising=False)
        fn = _external(lib).perceptual_evaluation_speech_quality if which == "pesq" else \
            _external(lib).short_time_objective_intelligibility
        args = (16000, "wb") if which == "pesq" else (16000,)
        with pytest.raises(ModuleNotFoundError) as fn_err:
            fn(*((x, x) if lib is jtm else _t(x, x)), *args)
        cls = lib.audio.PerceptualEvaluationSpeechQuality if which == "pesq" else \
            lib.audio.ShortTimeObjectiveIntelligibility
        with pytest.raises(ModuleNotFoundError) as cls_err:
            cls(*args, **({} if lib is jtm else CPU))
        errors[lib.__name__] = (str(fn_err.value), str(cls_err.value))
    assert errors["torchmetrics_tpu"] == errors["torchmetrics_tpu_torch"]


def test_present_wheels_are_called_on_host_numpy(monkeypatch):
    """With stand-ins for the wheels, both packages call them on the same float32 host
    arrays, sample by sample, and give the same scores."""
    calls = []
    fake_pesq = types.ModuleType("pesq")
    fake_pesq.pesq = lambda fs, ref, deg, mode: calls.append((ref.dtype, ref.shape)) or float(np.mean(ref * deg) + fs)
    fake_pystoi = types.ModuleType("pystoi")
    fake_pystoi.stoi = lambda ref, deg, fs, extended: float(np.mean(np.abs(ref - deg)) + extended)
    monkeypatch.setitem(sys.modules, "pesq", fake_pesq)
    monkeypatch.setitem(sys.modules, "pystoi", fake_pystoi)
    for lib in (jtm, ttm):
        monkeypatch.setattr(_external(lib), "_PESQ_AVAILABLE", True)
        monkeypatch.setattr(_external(lib), "_PYSTOI_AVAILABLE", True)
    preds, target = PREDS[0], TARGET[0]
    for fn, args in (("perceptual_evaluation_speech_quality", (8000, "nb")),
                     ("short_time_objective_intelligibility", (16000, True))):
        want = getattr(_external(jtm), fn)(preds, target, *args)
        got = getattr(_external(ttm), fn)(*_t(preds, target), *args)
        _bitwise(got, want, fn)
        _bitwise(getattr(_external(ttm), fn)(*_t(preds[0, 0], target[0, 0]), *args),
                 getattr(_external(jtm), fn)(preds[0, 0], target[0, 0], *args), f"{fn} one")
    assert all(dtype == np.float32 and shape == (256,) for dtype, shape in calls)
    with pytest.raises(ValueError) as jax_err:
        _external(jtm).perceptual_evaluation_speech_quality(preds, target, 22050, "wb")
    with pytest.raises(ValueError) as port_err:
        _external(ttm).perceptual_evaluation_speech_quality(*_t(preds, target), 22050, "wb")
    assert str(port_err.value) == str(jax_err.value)


# -------------------------------------------------------------------------- exports

def test_exports_and_signatures_are_the_jax_packages():
    assert ttm.audio.__all__ == jtm.audio.__all__
    assert port_fn.audio.__all__ == jax_fn.audio.__all__
    for name in jtm.audio.__all__:
        assert getattr(ttm, name) is getattr(ttm.audio, name)
        assert list(inspect.signature(getattr(ttm.audio, name)).parameters) == \
            list(inspect.signature(getattr(jtm.audio, name)).parameters), name
    for name in jax_fn.audio.__all__:
        assert getattr(port_fn, name) is getattr(port_fn.audio, name)
        jax_params = inspect.signature(getattr(jax_fn.audio, name)).parameters
        port_params = inspect.signature(getattr(port_fn.audio, name)).parameters
        assert [(p.name, p.default) for p in port_params.values()] == \
            [(p.name, p.default) for p in jax_params.values()], name
