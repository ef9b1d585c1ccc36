"""The port's text metrics without a model, and LVE, against the JAX package, on the CPU:
BLEU, SacreBLEU (each tokenizer), CER, WER, MER, WIL, WIP, EditDistance, chrF/chrF++,
TER, EED, SQuAD, ROUGE (``rougeLsum`` too), Perplexity and LipVertexError, as functions
and as classes, and the exports of ``text``, ``multimodal``, their ``functional``
modules and ``utilities``.

The corpora are those of ``tests/test_text.py`` (the fixed mini-corpus, with several
references), seeded fuzz corpora built as ``tests/test_text_fuzz.py`` builds them
(ASCII, CJK runs, accented words, digits, punctuation), and edge rows: empty
predictions and references, a prediction without a reference word in common. The same
strings go through the JAX package and the port (``device="cpu"``).

Tolerances, with ``u = 2**-24`` of a value's magnitude (at least 1):

- states bit for bit: both packages count on the host and round the same float64
  numbers to float32 (or int32) once;
- the rates, chrF, TER and SQuAD bit for bit: the same float32 quotients, or the same
  float64 numpy rounded once;
- BLEU within 4 u: ``log`` and ``exp`` in float32 differ by a unit between XLA and
  torch;
- the means over cat rows (ROUGE, EED) and LVE within 16 u: the JAX package adds in
  float32 in XLA's lane order and multiplies by ``1/n``, the port adds in float64 and
  rounds once (so the card and the CPU give the same bits);
- Perplexity within 64 u: ``log_softmax`` rounds differently; bfloat16 logits within
  two bfloat16 spacings (``2**-7`` relative) of the JAX package's bfloat16 sum: both
  round each log-probability to bfloat16, from float32 values that differ.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu.functional.text import rouge as jax_rouge
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch.functional.text import rouge as port_rouge

CPU = {"device": "cpu"}
U = 2.0**-24

PREDS_A = ["this is the prediction", "there is an other sample"]
TARGET_A = ["this is the reference", "there is another one"]
CORPUS_PREDS = [
    "the cat is on the mat",
    "a quick brown fox jumps over the lazy dog",
    "It is a guide to action which ensures that the military always obeys the commands of the party",
]
CORPUS_TARGET = [
    ["there is a cat on the mat", "a cat is on the mat"],
    ["the quick brown fox jumps over a lazy dog"],
    [
        "It is a guide to action that ensures that the military will forever heed Party commands",
        "It is the guiding principle which guarantees the military forces always being under the command of the Party",
    ],
]
_ASCII = ["cat", "on", "the", "mat", "hello", "world", "quick", "brown", "fox", "jumps"]
_CJK = "猫在垫子上你好世界快狐狸跳懒狗日本語のテスト한국어시험"
_ACCENT = ["wörld", "naïve", "café", "señor", "Zürich", "résumé"]
_PUNCT = [",", ".", "!", "?", ";", ":", "—", "(", ")", '"', "'s", "-", "..."]
_DIGIT = ["123", "3.14", "2-3", "1,000", "42"]


def _rand_sentence(rng: np.random.Generator) -> str:
    parts = []
    for _ in range(int(rng.integers(1, 14))):
        kind = rng.random()
        if kind < 0.45:
            parts.append(str(rng.choice(_ASCII)))
        elif kind < 0.6:
            k = int(rng.integers(1, 5))
            start = int(rng.integers(0, len(_CJK) - k))
            parts.append(_CJK[start : start + k])
        elif kind < 0.72:
            parts.append(str(rng.choice(_ACCENT)))
        elif kind < 0.85:
            parts.append(str(rng.choice(_DIGIT)))
        else:
            parts.append(str(rng.choice(_ASCII)) + str(rng.choice(_PUNCT)))
    # two sentences in some rows, so rougeLsum's splitter has work
    return " ".join(parts) + (". " + str(rng.choice(_ASCII)).capitalize() + " ran!" if rng.random() < 0.3 else "")


_RNG = np.random.default_rng(1616)
_FUZZ = [(_rand_sentence(_RNG), [_rand_sentence(_RNG) for _ in range(int(_RNG.integers(1, 4)))]) for _ in range(12)]
# machine-translation batches: predictions and lists of references
MT_BATCHES = [
    (CORPUS_PREDS, CORPUS_TARGET),
    ([p for p, _ in _FUZZ[:6]] + ["", "no word in common"], [t for _, t in _FUZZ[:6]] + [["a reference"], ["xyz"]]),
    ([p for p, _ in _FUZZ[6:]], [t for _, t in _FUZZ[6:]]),
]
# speech-recognition batches: one reference string each
ASR_BATCHES = [
    (PREDS_A, TARGET_A),
    ([p for p, _ in _FUZZ[:6]] + ["", "extra words here"], [t[0] for _, t in _FUZZ[:6]] + ["not empty", ""]),
    (["hello there general kenobi", "foo bar foobar"], ["hello there!", "foo bar foobar"]),
]
SQUAD_BATCHES = [
    ([{"prediction_text": "1976", "id": "id1"}, {"prediction_text": "the big apple", "id": "id2"}],
     [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "id1"},
      {"answers": {"answer_start": [1], "text": ["New York City", "the big apple!"]}, "id": "id2"}]),
    ([{"prediction_text": "An Apple, a pear.", "id": "id3"}],
     [{"answers": {"answer_start": [0, 1, 2], "text": ["apple pear", "a pear", ""]}, "id": "id3"}]),
    ([{"prediction_text": "", "id": "id4"}, {"prediction_text": "Paris", "id": "id5"}],
     [{"answers": {"answer_start": [3], "text": ["London"]}, "id": "id4"},
      {"answers": {"answer_start": [3], "text": ["paris"]}, "id": "id5"}]),
]


@pytest.fixture(autouse=True)
def offline_sentence_splitter(monkeypatch):
    """Both packages split ``rougeLsum`` sentences with the offline splitter: the JAX
    package would try to download nltk's punkt model otherwise."""
    monkeypatch.setattr(jax_rouge, "_PUNKT_STATE", {"checked": True, "available": False})
    monkeypatch.setattr(port_rouge, "_punkt_available", lambda: False)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hold(port, ref, units: float = 0, context: str = "") -> None:
    """Equal dtype and shape, NaN by place, and within ``units`` u of the magnitude (bit
    for bit at 0). Dicts and tuples are held key by key."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), context
        for key in ref:
            _hold(port[key], ref[key], units, f"{context} {key}")
        return
    if isinstance(ref, (tuple, list)) and not isinstance(port, torch.Tensor):
        assert len(port) == len(ref), context
        for i, (p, r) in enumerate(zip(port, ref)):
            _hold(p, r, units, f"{context}[{i}]")
        return
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    if units == 0:
        np.testing.assert_array_equal(p, r, err_msg=context)
        return
    p64, r64 = p.astype(np.float64), r.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(p64), np.isnan(r64), err_msg=context)
    keep = ~np.isnan(r64)
    tol = units * U * np.maximum(np.abs(r64[keep]), 1.0)
    assert np.all(np.abs(p64[keep] - r64[keep]) <= tol), f"{context}: {p64} vs {r64}"


def _states(metric, jax: bool) -> dict:
    """Each state; a list state as the concatenation of its rows."""
    out = {}
    for key, value in metric._state.items():
        if isinstance(value, list):
            rows = [np.atleast_1d(_np(v)) for v in value]
            value = np.concatenate(rows) if rows else np.zeros((0,), np.float32)
        out[key] = _np(value)
    return out


def _numpy_checkpoint(state_dict: dict) -> dict:
    return {k: [_np(t) for t in v] if isinstance(v, list) else (_np(v) if isinstance(v, torch.Tensor) else v)
            for k, v in state_dict.items()}


# (class, its keywords, function, its keywords, batches, value tolerance in u)
CASES = {
    "bleu": ("BLEUScore", {}, "bleu_score", {}, MT_BATCHES, 4),
    "bleu_2_smooth": ("BLEUScore", {"n_gram": 2, "smooth": True}, "bleu_score", {"n_gram": 2, "smooth": True},
                      MT_BATCHES, 4),
    "bleu_weights": ("BLEUScore", {"n_gram": 3, "weights": [0.5, 0.3, 0.2]}, "bleu_score",
                     {"n_gram": 3, "weights": [0.5, 0.3, 0.2]}, MT_BATCHES, 4),
    **{f"sacre_bleu_{tok}": ("SacreBLEUScore", {"tokenize": tok, "lowercase": tok == "intl"}, "sacre_bleu_score",
                             {"tokenize": tok, "lowercase": tok == "intl"}, MT_BATCHES, 4)
       for tok in ("none", "13a", "zh", "intl", "char")},
    "cer": ("CharErrorRate", {}, "char_error_rate", {}, ASR_BATCHES, 0),
    "wer": ("WordErrorRate", {}, "word_error_rate", {}, ASR_BATCHES, 0),
    "mer": ("MatchErrorRate", {}, "match_error_rate", {}, ASR_BATCHES, 0),
    "wil": ("WordInfoLost", {}, "word_information_lost", {}, ASR_BATCHES, 0),
    "wip": ("WordInfoPreserved", {}, "word_information_preserved", {}, ASR_BATCHES, 0),
    **{f"edit_{reduction}_{cost}": ("EditDistance", {"reduction": reduction, "substitution_cost": cost},
                                    "edit_distance", {"reduction": reduction, "substitution_cost": cost},
                                    ASR_BATCHES, 0)
       for reduction in ("mean", "sum", "none") for cost in (1, 2)},
    "chrf++": ("CHRFScore", {}, "chrf_score", {}, MT_BATCHES, 0),
    "chrf_whitespace_sentences": ("CHRFScore", {"n_word_order": 0, "whitespace": True, "lowercase": True,
                                                "return_sentence_level_score": True}, "chrf_score",
                                  {"n_word_order": 0, "whitespace": True, "lowercase": True,
                                   "return_sentence_level_score": True}, MT_BATCHES, 0),
    "ter": ("TranslationEditRate", {}, "translation_edit_rate", {}, MT_BATCHES, 0),
    "ter_normalized_sentences": ("TranslationEditRate", {"normalize": True, "no_punctuation": True,
                                                         "asian_support": True, "return_sentence_level_score": True},
                                 "translation_edit_rate", {"normalize": True, "no_punctuation": True,
                                                           "asian_support": True,
                                                           "return_sentence_level_score": True}, MT_BATCHES, 0),
    "eed": ("ExtendedEditDistance", {}, "extended_edit_distance", {}, MT_BATCHES, 16),
    "eed_ja_sentences": ("ExtendedEditDistance", {"language": "ja", "return_sentence_level_score": True},
                         "extended_edit_distance", {"language": "ja", "return_sentence_level_score": True},
                         MT_BATCHES, 16),
    "squad": ("SQuAD", {}, "squad", {}, SQUAD_BATCHES, 0),
    "rouge": ("ROUGEScore", {}, "rouge_score", {}, MT_BATCHES, 16),
    "rouge_avg_stemmer": ("ROUGEScore", {"accumulate": "avg", "use_stemmer": True,
                                         "rouge_keys": ("rouge1", "rouge3", "rougeL", "rougeLsum")}, "rouge_score",
                          {"accumulate": "avg", "use_stemmer": True,
                           "rouge_keys": ("rouge1", "rouge3", "rougeL", "rougeLsum")}, MT_BATCHES, 16),
}


def _corpus(batches):
    if isinstance(batches[0][1][0], dict):  # SQuAD: lists of dicts
        return [r for b in batches for r in b[0]], [r for b in batches for r in b[1]]
    return [p for b in batches for p in b[0]], [t for b in batches for t in b[1]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_the_jax_package(case):
    _, _, fn, kw, batches, units = CASES[case]
    preds, target = _corpus(batches)
    # a function's functional value is computed from host numbers in both packages
    want = getattr(jax_fn, fn)(preds, target, **kw)
    got = getattr(port_fn, fn)(preds, target, **kw, **CPU)
    _hold(got, want, units if fn in ("bleu_score", "sacre_bleu_score") else 0, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_class_matches_the_jax_package(case):
    """forward on the first batch (its own value), update on the others (states and
    compute over all), ``merge_state`` of three shards, and checkpoints crossing over
    in both directions."""
    name, kw, _, _, batches, units = CASES[case]
    jax_metric = getattr(jtm.text, name)(**kw)
    port_metric = getattr(ttm.text, name)(**kw, **CPU)
    _hold(port_metric(*batches[0]), jax_metric(*batches[0]), units, f"{case} forward")
    for batch in batches[1:]:
        jax_metric.update(*batch)
        port_metric.update(*batch)
    want_states = _states(jax_metric, jax=True)
    got_states = _states(port_metric, jax=False)
    _hold(got_states, want_states, 0, f"{case} states")
    assert all(isinstance(v, list) or v.device == torch.device("cpu") for v in port_metric._state.values())
    want = jax_metric.compute()
    _hold(port_metric.compute(), want, units, f"{case} compute")
    shards = [getattr(ttm.text, name)(**kw, **CPU) for _ in batches]
    for shard, batch in zip(shards, batches):
        shard.update(*batch)
    shards[0].merge_state(shards[1])
    shards[0].merge_state(shards[2])
    _hold(_states(shards[0], jax=False), want_states, 0, f"{case} merged states")
    _hold(shards[0].compute(), want, units, f"{case} merged")
    jax_metric.persistent(True)
    restored = getattr(ttm.text, name)(**kw, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _hold(restored.compute(), want, units, f"{case} from the JAX checkpoint")
    port_metric.persistent(True)
    crossed = getattr(jtm.text, name)(**kw)
    crossed.load_state_dict(_numpy_checkpoint(port_metric.state_dict()))
    _hold(_states(crossed, jax=True), want_states, 0, f"{case} port checkpoint in the JAX package")
    _hold(port_metric.compute(), crossed.compute(), units, f"{case} port checkpoint")


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_defaults_are_the_jax_packages(case):
    name, kw, *_ = CASES[case]
    jax_metric = getattr(jtm.text, name)(**kw)
    port_metric = getattr(ttm.text, name)(**kw, **CPU)
    assert list(port_metric._defaults) == list(jax_metric._defaults), case
    assert port_metric._reductions == jax_metric._reductions
    for key, default in port_metric._defaults.items():
        ref = jax_metric._defaults[key]
        if isinstance(ref, list):
            assert default == []
        else:
            assert _np(default).dtype == np.asarray(ref).dtype and tuple(default.shape) == np.asarray(ref).shape
    assert port_metric.higher_is_better == jax_metric.higher_is_better
    assert port_metric._jittable_compute is jax_metric._jittable_compute
    assert port_metric.full_state_update == jax_metric.full_state_update


def test_rouge_flat_references_and_string_inputs():
    """A flat list of strings is several references of one prediction given as a string,
    else one reference each; a string target is one reference."""
    for preds, target in (("the cat sat. the dog ran", ["a cat sat", "the dog ran fast. ok"]),
                          (["the cat sat", "a dog"], ["a cat sat", "the dog ran"]), ("My name is John", "Is your name John")):
        want = jax_fn.rouge_score(preds, target)
        _hold(port_fn.rouge_score(preds, target, **CPU), want, 0, str(preds))
        jax_metric, port_metric = jtm.text.ROUGEScore(), ttm.text.ROUGEScore(**CPU)
        jax_metric.update(preds, target)
        port_metric.update(preds, target)
        _hold(port_metric.compute(), jax_metric.compute(), 16, str(preds))


def test_sentence_splitter_looks_for_punkt_without_downloading(monkeypatch):
    import nltk

    def refuse(*args, **kwargs):
        raise AssertionError("the port asked nltk for a download")

    monkeypatch.undo()  # the real lookup, not the fixture's stand-in
    monkeypatch.setattr(nltk, "download", refuse)
    assert port_rouge._punkt_available() in (True, False)
    assert port_rouge._split_sentence("One. Two!  Three?<n>") in (["One.", "Two!", "Three?"],)


@pytest.mark.parametrize("call, match", [
    (lambda fn: fn.bleu_score(["a", "b"], [["a"]], **{}), "Corpus has different size"),
    (lambda fn: fn.bleu_score(["a"], [["a"]], n_gram=2, weights=[1.0]), "different weights"),
    (lambda fn: fn.sacre_bleu_score(["a"], [["a"]], tokenize="bogus"), "`tokenize`"),
    (lambda fn: fn.edit_distance(["a"], ["a", "b"]), "same length"),
    (lambda fn: fn.edit_distance([1], ["a"]), "string type"),
    (lambda fn: fn.chrf_score(["a"], [["a"]], n_char_order=0), "n_char_order"),
    (lambda fn: fn.chrf_score(["a"], [["a"]], beta=-1.0), "beta"),
    (lambda fn: fn.translation_edit_rate(["a"], [["a"]], normalize="yes"), "boolean"),
    (lambda fn: fn.translation_edit_rate(["a", "b"], [["a"]]), "different size"),
    (lambda fn: fn.extended_edit_distance(["a"], [["a"]], alpha=2), "non-negative float"),
    (lambda fn: fn.extended_edit_distance(["a"], [["a"]], language="de"), "`en` or `ja`"),
    (lambda fn: fn.rouge_score("a", "a", rouge_keys=("rougeX",)), "unknown rouge key"),
    (lambda fn: fn.rouge_score("a", "a", accumulate="max"), "unknown accumulate"),
])
def test_argument_errors_are_the_jax_packages(call, match):
    with pytest.raises((ValueError, KeyError)) as jax_err:
        call(jax_fn)
    with pytest.raises(type(jax_err.value)) as port_err:
        call(_CpuFunctions())
    assert str(port_err.value) == str(jax_err.value)
    assert match in str(port_err.value)


class _CpuFunctions:
    """``port_fn``'s text functions with ``device="cpu"``."""

    def __getattr__(self, name):
        return lambda *args, **kw: getattr(port_fn, name)(*args, **kw, **CPU)


def test_squad_errors_and_unanswered_questions_are_the_jax_packages():
    with pytest.raises(KeyError) as jax_err:
        jax_fn.squad({"wrong": "x"}, {"answers": {"text": ["y"]}, "id": "1"})
    with pytest.raises(KeyError) as port_err:
        port_fn.squad({"wrong": "x"}, {"answers": {"text": ["y"]}, "id": "1"}, **CPU)
    assert str(port_err.value) == str(jax_err.value)
    preds = {"prediction_text": "x", "id": "1"}
    target = [{"answers": {"text": ["x"]}, "id": "1"}, {"answers": {"text": ["y"]}, "id": "2"}]
    with pytest.warns(UserWarning, match="Unanswered question 2"):
        got = port_fn.squad(preds, target, **CPU)
    _hold(got, jax_fn.squad(preds, target))


# ------------------------------------------------------------------------ Perplexity

_PPL_RNG = np.random.default_rng(516)
LOGITS = (3 * _PPL_RNG.standard_normal((3, 2, 8, 37))).astype(np.float32)
TOKENS = _PPL_RNG.integers(0, 37, (3, 2, 8))


@pytest.mark.parametrize("ignore_index", [None, 5, -100])
def test_perplexity_matches_the_jax_package(ignore_index):
    tokens = np.where(_PPL_RNG.random(TOKENS.shape) < 0.2, ignore_index, TOKENS) if ignore_index == -100 else TOKENS
    want = jax_fn.perplexity(LOGITS[0], tokens[0], ignore_index=ignore_index)
    _hold(port_fn.perplexity(torch.from_numpy(LOGITS[0]), torch.from_numpy(tokens[0]), ignore_index), want, 64)
    jax_metric = jtm.text.Perplexity(ignore_index=ignore_index)
    port_metric = ttm.text.Perplexity(ignore_index=ignore_index, **CPU)
    _hold(port_metric(torch.from_numpy(LOGITS[0]), torch.from_numpy(tokens[0])), jax_metric(LOGITS[0], tokens[0]),
          64, "forward")
    for i in (1, 2):
        jax_metric.update(LOGITS[i], tokens[i])
        port_metric.update(torch.from_numpy(LOGITS[i]), torch.from_numpy(tokens[i]))
    _hold(port_metric.count, jax_metric._state["count"], 0, "count")
    _hold(port_metric.total_log_probs, jax_metric._state["total_log_probs"], 64, "total_log_probs")
    want = jax_metric.compute()
    _hold(port_metric.compute(), want, 64, "compute")
    shards = [ttm.text.Perplexity(ignore_index=ignore_index, **CPU) for _ in range(3)]
    for shard, i in zip(shards, range(3)):
        shard.update(torch.from_numpy(LOGITS[i]), torch.from_numpy(tokens[i]))
    shards[0].merge_state(shards[1])
    shards[0].merge_state(shards[2])
    _hold(shards[0].compute(), want, 64, "merged")
    jax_metric.persistent(True)
    restored = ttm.text.Perplexity(ignore_index=ignore_index, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _hold(restored.compute(), want, 0, "from the JAX checkpoint")
    port_metric.persistent(True)
    crossed = jtm.text.Perplexity(ignore_index=ignore_index)
    crossed.load_state_dict(_numpy_checkpoint(port_metric.state_dict()))
    _hold(crossed.compute(), port_metric.compute(), 0, "port checkpoint")


def test_perplexity_of_bfloat16_logits_is_the_jax_packages_bfloat16_sum():
    import jax.numpy as jnp
    from torchmetrics_tpu.functional.text.perplexity import _perplexity_update as jax_update

    from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_update as port_update

    total, count = port_update(torch.from_numpy(LOGITS[0]).to(torch.bfloat16), torch.from_numpy(TOKENS[0]))
    want_total, want_count = jax_update(jnp.asarray(LOGITS[0], jnp.bfloat16), TOKENS[0])
    assert total.dtype == torch.bfloat16 and str(want_total.dtype) == "bfloat16"
    assert abs(float(total) - float(want_total)) <= 2.0**-7 * abs(float(want_total))
    _hold(count, want_count)


@pytest.mark.parametrize("preds, target, error", [
    (np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int32), "3 dimensions"),
    (np.zeros((2, 3, 4), np.float32), np.zeros((2,), np.int32), "2 dimensions"),
    (np.zeros((2, 3, 4), np.float32), np.zeros((2, 4), np.int32), "equaling first two"),
    (np.zeros((2, 3, 4), np.int32), np.zeros((2, 3), np.int32), "floating point"),
    (np.zeros((2, 3, 4), np.float32), np.zeros((2, 3), np.float32), "integer type"),
])
def test_perplexity_input_errors_are_the_jax_packages(preds, target, error):
    with pytest.raises((ValueError, TypeError)) as jax_err:
        jax_fn.perplexity(preds, target)
    with pytest.raises(type(jax_err.value), match=error):
        port_fn.perplexity(torch.from_numpy(preds), torch.from_numpy(target))


# --------------------------------------------------------------------------- LVE

_LVE_RNG = np.random.default_rng(1600)
LVE_PRED = _LVE_RNG.normal(size=(3, 10, 100, 3)).astype(np.float32)
LVE_GT = _LVE_RNG.normal(size=(3, 12, 100, 3)).astype(np.float32)
MOUTH = [0, 1, 2, 3, 4, 50, 51]


def test_lip_vertex_error_matches_the_jax_package():
    """The corpus of ``test_multimodal_modelbacked.py::test_lve_parity`` (fewer predicted
    frames than ground-truth frames), three batches."""
    for i in range(3):
        _hold(port_fn.lip_vertex_error(torch.from_numpy(LVE_PRED[i]), torch.from_numpy(LVE_GT[i]), MOUTH),
              jax_fn.lip_vertex_error(LVE_PRED[i], LVE_GT[i], MOUTH), 16, f"batch {i}")
    jax_metric = jtm.multimodal.LipVertexError(mouth_map=MOUTH)
    port_metric = ttm.multimodal.LipVertexError(mouth_map=MOUTH, **CPU)
    batch = lambda i: (torch.from_numpy(LVE_PRED[i]), torch.from_numpy(LVE_GT[i]))
    _hold(port_metric(*batch(0)), jax_metric(LVE_PRED[0], LVE_GT[0]), 16, "forward")
    for i in (1, 2):
        jax_metric.update(LVE_PRED[i], LVE_GT[i])
        port_metric.update(*batch(i))
    _hold(port_metric.total, jax_metric._state["total"], 0, "total")
    _hold(port_metric.sum_lve, jax_metric._state["sum_lve"], 48, "sum_lve")
    want = jax_metric.compute()
    _hold(port_metric.compute(), want, 48, "compute")
    shards = [ttm.multimodal.LipVertexError(mouth_map=MOUTH, **CPU) for _ in range(3)]
    for i, shard in enumerate(shards):
        shard.update(*batch(i))
    shards[0].merge_state(shards[1])
    shards[0].merge_state(shards[2])
    _hold(shards[0].compute(), port_metric.compute(), 0, "merged")
    jax_metric.persistent(True)
    restored = ttm.multimodal.LipVertexError(mouth_map=MOUTH, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _hold(restored.compute(), want, 0, "from the JAX checkpoint")
    port_metric.persistent(True)
    crossed = jtm.multimodal.LipVertexError(mouth_map=MOUTH)
    crossed.load_state_dict(_numpy_checkpoint(port_metric.state_dict()))
    _hold(crossed.compute(), port_metric.compute(), 0, "port checkpoint")


@pytest.mark.parametrize("pred, gt, mouth", [
    (np.zeros((2, 5)), np.zeros((2, 5, 3)), [0]),
    (np.zeros((2, 5, 3)), np.zeros((2, 4, 3)), [0]),
    (np.zeros((2, 5, 3)), np.zeros((2, 5, 3)), []),
    (np.zeros((2, 5, 3)), np.zeros((2, 5, 3)), [5]),
])
def test_lip_vertex_error_input_errors_are_the_jax_packages(pred, gt, mouth):
    with pytest.raises(ValueError) as jax_err:
        jax_fn.lip_vertex_error(pred, gt, mouth)
    with pytest.raises(ValueError) as port_err:
        port_fn.lip_vertex_error(torch.from_numpy(pred), torch.from_numpy(gt), mouth)
    assert str(port_err.value).split(" but got")[0] == str(jax_err.value).split(" but got")[0]
    with pytest.raises(ValueError, match="non-empty list"):
        ttm.multimodal.LipVertexError(mouth_map=(), **CPU)


# ------------------------------------------------------------------------ exports

def _public(module) -> set:
    return {n for n in dir(module) if not n.startswith("_")}


@pytest.mark.parametrize("jax_module, port_module", [
    (jtm.text, ttm.text), (jax_fn.text, port_fn.text), (jtm.utilities, ttm.utilities),
])
def test_text_and_utilities_exports_are_the_jax_packages(jax_module, port_module):
    assert sorted(port_module.__all__) == sorted(jax_module.__all__)


_MISSING_NAMES = """
import json
import torchmetrics_tpu as jtm, torchmetrics_tpu_torch as ttm
from torchmetrics_tpu import functional as jf
from torchmetrics_tpu_torch import functional as pf
public = lambda m: {n for n in dir(m) if not n.startswith("_")}
print(json.dumps(sorted((public(jtm) - public(ttm)) | (public(jf) - public(pf)))))
"""


def test_only_the_planes_are_still_missing():
    """``dir()`` of both packages as a user's fresh import gives it: in a new interpreter,
    since other tests import submodules (``chaos``, ``fleet``) that then show in
    ``dir()``."""
    import json
    import os
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", _MISSING_NAMES], capture_output=True, text=True, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    missing = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert missing == set()
    from torchmetrics_tpu import aot as jax_aot
    from torchmetrics_tpu import observability as jax_obs
    from torchmetrics_tpu import streaming as jax_streaming

    from torchmetrics_tpu_torch import aot as port_aot
    from torchmetrics_tpu_torch import observability as port_obs
    from torchmetrics_tpu_torch import parallel as port_parallel
    from torchmetrics_tpu_torch import streaming as port_streaming

    assert port_obs.__all__ == jax_obs.__all__
    assert port_aot.__all__ == jax_aot.__all__
    assert port_streaming.__all__ == jax_streaming.__all__
    from torchmetrics_tpu import parallel as jax_parallel
    from torchmetrics_tpu import serving as jax_serving
    from torchmetrics_tpu_torch import serving as port_serving

    assert port_serving.__all__ == jax_serving.__all__
    kept = {"shard_map", "make_data_mesh", "make_2d_mesh", "batch_sharding", "replicated", "reduce_over_axis",
            "DEFAULT_AXIS"}
    assert set(port_parallel.__all__) == (set(jax_parallel.__all__) - kept) | {"gather_metadata_vector"}
    assert {"SyncConfig", "quantized_payload_model"} <= set(port_parallel.__all__)
    assert ttm.multimodal.__all__ == jtm.multimodal.__all__
    assert port_fn.multimodal.__all__ == jax_fn.multimodal.__all__
    assert {"text", "multimodal", "utilities"} <= _public(ttm)


def test_utilities_match_the_jax_packages():
    """Means within 2 u: ``jnp.mean`` multiplies the sum by ``1/n`` in float32."""
    from torchmetrics_tpu import utilities as ju

    from torchmetrics_tpu_torch import utilities as pu

    x = np.asarray([[1.0, 4.0], [3.0, 2.0], [5.0, 0.0]], np.float32)
    for name in ("dim_zero_sum", "dim_zero_mean", "dim_zero_max", "dim_zero_min"):
        _hold(getattr(pu, name)(torch.from_numpy(x)), getattr(ju, name)(x), 0, name)
    _hold(pu.dim_zero_cat([torch.ones(2), torch.zeros(1)]), ju.dim_zero_cat([np.ones(2, np.float32),
                                                                             np.zeros(1, np.float32)]))
    num, denom, weights = (np.asarray(v, np.float32) for v in ([1, 0, 3], [2, 0, 4], [2, 0, 4]))
    for reduction in ("micro", "macro", "weighted", "none"):
        _hold(pu.class_reduce(*map(torch.from_numpy, (num, denom, weights)), reduction),
              ju.class_reduce(num, denom, weights, reduction), 2, reduction)
    for reduction in ("elementwise_mean", "sum", "none"):
        _hold(pu.reduce(torch.from_numpy(x), reduction), ju.reduce(x, reduction), 2, reduction)
    for fn in (pu.reduce, ju.reduce):
        with pytest.raises(ValueError, match="Reduction parameter unknown"):
            fn(x, "max")
    assert issubclass(pu.TorchMetricsUserWarning, UserWarning)
    with pytest.warns(pu.TorchMetricsUserWarning, match="careful"):
        pu.rank_zero_warn("careful", pu.TorchMetricsUserWarning)
    pu.rank_zero_debug("quiet")
    pu.rank_zero_info("quiet")


def test_check_forward_full_state_property_prints_the_jax_packages_verdict(capsys):
    from torchmetrics_tpu import utilities as ju

    from torchmetrics_tpu_torch import utilities as pu

    inputs = {"preds": ["this is the prediction"], "target": ["this is the reference"]}
    ju.check_forward_full_state_property(jtm.text.WordErrorRate, input_args=inputs, num_update_to_compare=(2,),
                                         reps=1)
    want = capsys.readouterr().out.splitlines()
    pu.check_forward_full_state_property(ttm.text.WordErrorRate, init_args=CPU, input_args=inputs,
                                         num_update_to_compare=(2,), reps=1)
    got = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in got] == [line.split(":")[0] for line in want]
    assert got[-1] == "Recommended setting `full_state_update=False`"
