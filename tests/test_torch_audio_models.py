"""The port's model-backed and filterbank audio metrics against the JAX package, on the
CPU: SRMR, DNSMOS (through seeded ``infer_fns``) and NISQA (through a seeded checkpoint
in the published ``nisqa.tar`` layout, which both packages load), as functions and as
classes, their feature pipelines, their gates and the NISQA weight carrier.

The same numpy inputs, made from a seed, go through the JAX package and the port
(``device="cpu"``): SRMR on 1 s at 8 kHz, DNSMOS on 3 s (repeated to 9.01 s), 11 s (two
hops) and 2 s at 48 kHz (resampled), NISQA on 1 s at 16 kHz through a miniature but
complete NISQA (``TOY_ARGS``, the JAX package's own test configuration).

Tolerances:

- SRMR and DNSMOS equal bit for bit: both packages run the same scipy filters and
  resampler on the host and the rest in float64 (FFTs, frame energies, mel products),
  which agree far below float32's rounding of the result; the DNSMOS features equal too;
- NISQA within ``32 u`` (``u = 2**-24``) of its magnitude, at least 1: the model runs
  in float32, its convolutions and products summed in another order than XLA's (the
  worst seen: 4 u); the features and segments bit for bit.
"""

from __future__ import annotations

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu_torch import functional as port_fn

jax_dnsmos = importlib.import_module("torchmetrics_tpu.functional.audio.dnsmos")
port_dnsmos = importlib.import_module("torchmetrics_tpu_torch.functional.audio.dnsmos")
jax_nisqa = importlib.import_module("torchmetrics_tpu.functional.audio.nisqa")
port_nisqa = importlib.import_module("torchmetrics_tpu_torch.functional.audio.nisqa")

CPU = {"device": "cpu"}
U = 2.0**-24
_RNG = np.random.default_rng(1516)
_ENVELOPE = np.sin(np.arange(8000) / 300.0)
SPEECH = (_RNG.standard_normal((2, 2, 8000)) * _ENVELOPE).astype(np.float32)  # two batches at 8 kHz
CLIPS = (0.1 * _RNG.standard_normal((2, 2, 16000 * 3))).astype(np.float32)  # two batches of 3 s
LONG_CLIP = (0.1 * _RNG.standard_normal((1, 16000 * 11))).astype(np.float32)
CLIP_48K = (0.1 * _RNG.standard_normal((2, 48000 * 2))).astype(np.float32)
WAVES = _RNG.standard_normal((2, 2, 16000)).astype(np.float32)  # NISQA: two batches of 1 s
P808_WEIGHTS = _RNG.standard_normal((120, 1))
SBO_WEIGHTS = _RNG.standard_normal(3)

TOY_ARGS = {
    "ms_n_fft": 256, "ms_hop_length": 0.005, "ms_win_length": 0.01, "ms_n_mels": 24, "ms_fmax": 8000,
    "ms_seg_length": 9, "ms_seg_hop_length": 2, "ms_max_segments": 128, "cnn_c_out_1": 8, "cnn_c_out_2": 16,
    "cnn_c_out_3": 24, "cnn_kernel_size": (3, 3), "cnn_dropout": 0.0, "cnn_pool_1": [12, 5], "cnn_pool_2": [6, 3],
    "cnn_pool_3": [3, 2], "td_sa_d_model": 32, "td_sa_nhead": 2, "td_sa_num_layers": 2, "td_sa_h": 48,
    "td_sa_dropout": 0.0, "pool_att_h": 24, "pool_att_dropout": 0.0,
}
# NISQA's published configuration (config/nisqa.yaml of the NISQA repository)
PUBLISHED_ARGS = {
    "ms_n_fft": 4096, "ms_hop_length": 0.01, "ms_win_length": 0.02, "ms_n_mels": 48, "ms_fmax": 20000,
    "ms_seg_length": 15, "ms_seg_hop_length": 4, "ms_max_segments": 1300, "cnn_c_out_1": 16, "cnn_c_out_2": 32,
    "cnn_c_out_3": 64, "cnn_kernel_size": (3, 3), "cnn_dropout": 0.2, "cnn_pool_1": [24, 7], "cnn_pool_2": [12, 5],
    "cnn_pool_3": [6, 3], "td_sa_d_model": 64, "td_sa_nhead": 1, "td_sa_num_layers": 2, "td_sa_h": 64,
    "td_sa_dropout": 0.1, "pool_att_h": 128, "pool_att_dropout": 0.1,
}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _bitwise(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    np.testing.assert_array_equal(p, r, err_msg=context)


def _close(port, ref, units: float = 32, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    p64, r64 = p.astype(np.float64), r.astype(np.float64)
    assert np.all(np.abs(p64 - r64) <= units * U * np.maximum(np.abs(r64), 1.0)), f"{context}: {p} against {r}"


def _same_error(jax_call, port_call, kind=Exception) -> str:
    with pytest.raises(kind) as jax_err:
        jax_call()
    with pytest.raises(jax_err.type) as port_err:
        port_call()
    assert str(port_err.value) == str(jax_err.value)
    return str(port_err.value)


# ----------------------------------------------------------------------------- SRMR

@pytest.mark.parametrize("kw", [{}, {"norm": True}, {"max_cf": 64, "n_cochlear_filters": 16}],
                         ids=["plain", "norm", "narrow"])
def test_srmr_matches_the_jax_package(kw):
    want = jax_fn.speech_reverberation_modulation_energy_ratio(SPEECH[0], 8000, **kw)
    got = port_fn.speech_reverberation_modulation_energy_ratio(*_t(SPEECH[0]), 8000, **kw)
    _bitwise(got, want)


def test_srmr_on_integer_and_one_dimensional_input():
    pcm = (SPEECH[0] * 8000).astype(np.int16)  # scaled by iinfo(int16).max in both packages
    _bitwise(port_fn.speech_reverberation_modulation_energy_ratio(*_t(pcm), 8000),
             jax_fn.speech_reverberation_modulation_energy_ratio(pcm, 8000), "int16")
    _bitwise(port_fn.speech_reverberation_modulation_energy_ratio(*_t(SPEECH[0, 0] * 3), 8000),
             jax_fn.speech_reverberation_modulation_energy_ratio(SPEECH[0, 0] * 3, 8000), "1-D beyond [-1, 1]")


@pytest.mark.parametrize("kw", [{"fast": True}, {"fs": 8000.0}, {"n_cochlear_filters": 0}, {"low_freq": -1},
                                {"min_cf": 0}, {"max_cf": -2}, {"norm": 1}, {"fast": "no"}])
def test_srmr_argument_errors_are_the_jax_packages(kw):
    args = {"fs": 8000, **kw}
    _same_error(lambda: jax_fn.speech_reverberation_modulation_energy_ratio(SPEECH[0], **args),
                lambda: port_fn.speech_reverberation_modulation_energy_ratio(*_t(SPEECH[0]), **args))
    if "fast" not in kw or kw["fast"] is not True:
        _same_error(lambda: jtm.audio.SpeechReverberationModulationEnergyRatio(**args),
                    lambda: ttm.audio.SpeechReverberationModulationEnergyRatio(**args, **CPU))


# --------------------------------------------------------------------------- DNSMOS

def _infer_fns(lib):
    """Seeded linear maps of the model inputs (p808 of the mel features' mean over
    frames, sig/bak/ovr of the mean absolute sample), in float64."""
    if lib is jtm:
        return (lambda mel: np.asarray(mel, np.float64).mean(1) @ P808_WEIGHTS,
                lambda audio: np.abs(np.asarray(audio, np.float64)).mean(1, keepdims=True) * SBO_WEIGHTS + 3)
    return (lambda mel: mel.to(torch.float64).mean(1) @ torch.from_numpy(P808_WEIGHTS),
            lambda audio: audio.to(torch.float64).abs().mean(1, keepdim=True) * torch.from_numpy(SBO_WEIGHTS) + 3)


DNSMOS_CASES = {
    "short_repeated": (CLIPS[0], 16000, False),
    "personalized": (CLIPS[0], 16000, True),
    "two_hops": (LONG_CLIP, 16000, False),
    "resampled_48k": (CLIP_48K, 48000, False),
    "one_dimensional": (CLIPS[0, 0], 16000, True),
}


@pytest.mark.parametrize("case", sorted(DNSMOS_CASES))
def test_dnsmos_matches_the_jax_package(case):
    audio, fs, personalized = DNSMOS_CASES[case]
    want = jax_fn.deep_noise_suppression_mean_opinion_score(audio, fs, personalized, infer_fns=_infer_fns(jtm))
    got = port_fn.deep_noise_suppression_mean_opinion_score(*_t(audio), fs, personalized, infer_fns=_infer_fns(ttm))
    _bitwise(got, want)


def test_dnsmos_features_and_filterbank_are_the_jax_packages():
    np.testing.assert_array_equal(port_dnsmos.mel_filterbank(16000, 321, 120),
                                  jax_dnsmos.mel_filterbank(16000, 321, 120))
    seg = CLIPS[0][..., : 16000 * 2]
    _bitwise(port_dnsmos._audio_melspec(*_t(seg)), jax_dnsmos._audio_melspec(seg))
    _bitwise(port_dnsmos._audio_melspec(*_t(seg), to_db=False), jax_dnsmos._audio_melspec(seg, to_db=False))


def test_dnsmos_device_argument_places_host_input():
    got = port_fn.deep_noise_suppression_mean_opinion_score(CLIPS[0].tolist(), 16000, False, device="cpu",
                                                            infer_fns=_infer_fns(ttm))
    _bitwise(got, port_fn.deep_noise_suppression_mean_opinion_score(*_t(CLIPS[0]), 16000, False,
                                                                    infer_fns=_infer_fns(ttm)))


def test_dnsmos_gates_are_the_jax_packages(monkeypatch, tmp_path):
    for module in (jax_dnsmos, port_dnsmos):
        monkeypatch.setattr(module, "_ONNXRUNTIME_AVAILABLE", False)
    port_classes = importlib.import_module("torchmetrics_tpu_torch.audio.metrics")
    monkeypatch.setattr(port_classes, "_ONNXRUNTIME_AVAILABLE", False)
    _same_error(lambda: jax_fn.deep_noise_suppression_mean_opinion_score(CLIPS[0], 16000, False),
                lambda: port_fn.deep_noise_suppression_mean_opinion_score(*_t(CLIPS[0]), 16000, False),
                ModuleNotFoundError)
    _same_error(lambda: jtm.audio.DeepNoiseSuppressionMeanOpinionScore(16000, False),
                lambda: ttm.audio.DeepNoiseSuppressionMeanOpinionScore(16000, False, **CPU), ModuleNotFoundError)
    missing = str(tmp_path / "model_v8.onnx")
    text = _same_error(lambda: jax_dnsmos._load_session(missing), lambda: port_dnsmos._load_session(missing),
                       ModuleNotFoundError)
    assert "infer_fns" in text


# ---------------------------------------------------------------------------- NISQA

@pytest.fixture(scope="module")
def toy_checkpoint(tmp_path_factory):
    """The port's model at ``TOY_ARGS`` from seed 0, with batch-norm statistics and
    affines drawn so the folding is exercised, saved in the published layout."""
    torch.manual_seed(0)
    model = port_nisqa.NISQAModel(TOY_ARGS)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                module.running_mean.normal_(0, 0.5)
                module.running_var.uniform_(0.5, 2.0)
                module.weight.uniform_(0.5, 1.5)
                module.bias.normal_(0, 0.1)
    path = tmp_path_factory.mktemp("nisqa") / "nisqa.tar"
    torch.save({"args": TOY_ARGS, "model_state_dict": model.state_dict()}, path)
    return model.state_dict(), str(path)


@functools.lru_cache(maxsize=None)
def _jax_forward():
    return jax.jit(functools.partial(jax_nisqa.nisqa_forward, args=TOY_ARGS))


def test_nisqa_model_matches_the_jax_package_on_padded_segments(toy_checkpoint):
    state, _ = toy_checkpoint
    segments = np.zeros((3, 20, TOY_ARGS["ms_n_mels"], TOY_ARGS["ms_seg_length"]), np.float32)
    segments[:, :14] = _RNG.standard_normal((3, 14, *segments.shape[2:]))
    want = _jax_forward()(jax_nisqa.convert_nisqa_state_dict(state, TOY_ARGS), segments, 14)
    model = port_nisqa.NISQAModel(TOY_ARGS)
    model.load_state_dict(state)
    _close(model.eval()(*_t(segments), 14), want)


def test_nisqa_function_matches_the_jax_package(toy_checkpoint):
    _, path = toy_checkpoint
    want = jax_fn.non_intrusive_speech_quality_assessment(WAVES[0], 16000, checkpoint_path=path)
    got = port_fn.non_intrusive_speech_quality_assessment(*_t(WAVES[0]), 16000, checkpoint_path=path)
    assert got.shape == (2, 5)
    _close(got, want)
    spec = jax_nisqa._melspec_amplitude(WAVES[0], 16000, TOY_ARGS)
    port_spec = port_nisqa._melspec_amplitude(*_t(WAVES[0]), 16000, TOY_ARGS)
    _bitwise(port_spec, spec, "melspec")
    segments, n_wins = jax_nisqa._segment_specs(spec, TOY_ARGS)
    port_segments, port_wins = port_nisqa._segment_specs(port_spec, TOY_ARGS)
    assert port_wins == n_wins
    _bitwise(port_segments, segments, "segments")


def test_nisqa_weight_carrier_maps_the_jax_tree_one_to_one(toy_checkpoint):
    state, _ = toy_checkpoint
    params = jax.tree_util.tree_map(np.asarray, jax_nisqa.convert_nisqa_state_dict(state, TOY_ARGS))
    carried = port_nisqa.nisqa_state_dict_from_params(params)
    assert set(carried) == set(state)
    for key, value in state.items():
        if not key.endswith("num_batches_tracked"):
            _bitwise(carried[key], value, key)
    model = port_nisqa.NISQAModel(TOY_ARGS)
    model.load_state_dict(carried)


def test_nisqa_model_at_the_published_widths_holds_the_published_keys():
    """The published configuration builds, its state dict is what the JAX package's
    converter reads, and the CNN collapses a segment to ``64 * 6`` features."""
    model = port_nisqa.NISQAModel(PUBLISHED_ARGS)
    state = model.state_dict()
    params = jax_nisqa.convert_nisqa_state_dict(state, PUBLISHED_ARGS)
    assert len(jax.tree_util.tree_leaves(params)) == len([k for k in state if not k.endswith("num_batches_tracked")])
    features = model.cnn.model(torch.zeros(2, 1, 48, 15))
    assert features.shape == (2, 64 * 6)


def test_nisqa_short_long_and_gates_are_the_jax_packages(toy_checkpoint, tmp_path):
    _, path = toy_checkpoint
    short = np.zeros(64, np.float32)
    _same_error(lambda: jax_fn.non_intrusive_speech_quality_assessment(short, 16000, checkpoint_path=path),
                lambda: port_fn.non_intrusive_speech_quality_assessment(*_t(short), 16000, checkpoint_path=path),
                RuntimeError)
    long_args = dict(TOY_ARGS, ms_max_segments=4)
    spec = jax_nisqa._melspec_amplitude(WAVES[0, :1], 16000, TOY_ARGS)
    _same_error(lambda: jax_nisqa._segment_specs(spec, long_args),
                lambda: port_nisqa._segment_specs(torch.from_numpy(np.asarray(spec)), long_args), RuntimeError)
    missing = str(tmp_path / "missing.tar")
    _same_error(lambda: jax_fn.non_intrusive_speech_quality_assessment(WAVES[0], 16000, checkpoint_path=missing),
                lambda: port_fn.non_intrusive_speech_quality_assessment(*_t(WAVES[0]), 16000, checkpoint_path=missing),
                ModuleNotFoundError)
    _same_error(lambda: jtm.audio.NonIntrusiveSpeechQualityAssessment(16000, checkpoint_path=missing),
                lambda: ttm.audio.NonIntrusiveSpeechQualityAssessment(16000, checkpoint_path=missing, **CPU),
                ModuleNotFoundError)
    _same_error(lambda: jax_fn.non_intrusive_speech_quality_assessment(WAVES[0], 16000.0, checkpoint_path=path),
                lambda: port_fn.non_intrusive_speech_quality_assessment(*_t(WAVES[0]), 16000.0, checkpoint_path=path),
                ValueError)


# -------------------------------------------------------------------------- classes

def _class_cases(path: str) -> dict:
    return {
        "srmr": ("SpeechReverberationModulationEnergyRatio", {"fs": 8000}, SPEECH, _bitwise),
        "srmr_norm": ("SpeechReverberationModulationEnergyRatio", {"fs": 8000, "norm": True}, SPEECH, _bitwise),
        "dnsmos": ("DeepNoiseSuppressionMeanOpinionScore", {"fs": 16000, "personalized": False}, CLIPS, _bitwise),
        "nisqa": ("NonIntrusiveSpeechQualityAssessment", {"fs": 16000, "checkpoint_path": path}, WAVES, _close),
    }


@pytest.mark.parametrize("case", ["srmr", "srmr_norm", "dnsmos", "nisqa"])
def test_classes_match_the_jax_package(case, toy_checkpoint):
    """forward on the first batch, update on the second (states and compute over both),
    merge_state and a checkpoint from the JAX package loaded into the port. The score
    sums keep DNSMOS's 4 and NISQA's 5 dimensions."""
    name, kw, batches, hold = _class_cases(toy_checkpoint[1])[case]

    def build(lib):
        extra = {"infer_fns": _infer_fns(lib)} if case == "dnsmos" else {}
        return getattr(lib.audio, name)(**kw, **extra, **({} if lib is jtm else CPU))

    jax_metric, port_metric = build(jtm), build(ttm)
    hold(port_metric(*_t(batches[0])), jax_metric(batches[0]), context="forward")
    jax_metric.update(batches[1])
    port_metric.update(*_t(batches[1]))
    dims = {"dnsmos": (4,), "nisqa": (5,)}.get(case, ())
    assert tuple(port_metric.score_sum.shape) == np.asarray(jax_metric._state["score_sum"]).shape == dims
    _bitwise(port_metric.total, jax_metric._state["total"], "total")
    want = jax_metric.compute()
    hold(port_metric.compute(), want, context="compute")
    a, b = build(ttm), build(ttm)
    a.update(*_t(batches[0]))
    b.update(*_t(batches[1]))
    a.merge_state(b)
    hold(a.compute(), want, context="merged")
    jax_metric.persistent(True)
    restored = build(ttm)
    restored.load_state_dict(jax_metric.state_dict())
    hold(restored.compute(), want, context="restored")
    # the port's own checkpoint restores too (the JAX package's scalar default refuses
    # its own (4,) and (5,) sums)
    port_metric.persistent(True)
    again = build(ttm)
    again.load_state_dict(port_metric.state_dict())
    hold(again.compute(), want, context="port checkpoint")
    assert port_metric._jittable_compute is jax_metric._jittable_compute is False
