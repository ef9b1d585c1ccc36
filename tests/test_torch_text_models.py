"""The port's BERTScore and InfoLM against the JAX package, on the CPU, through the same
tiny random HF models written to disk once for the module (a ``BertModel`` and a
``BertForMaskedLM`` over a WordPiece vocabulary of the corpus's words, seeded), which
both packages load by path with ``local_files_only=True``, as
``tests/test_bertscore_hf.py`` and ``tests/test_infolm.py`` do for the JAX package.

Both packages run the same HF model in torch on the CPU; what differs is the JAX
package's numpy and XLA steps after it. Tolerances:

- token-id and mask states bit for bit (the same tokenizer, int32 in both);
- BERTScore's precision, recall and F1 within 1e-5 absolute: the port cuts each
  embedder batch to its longest sentence (the JAX package runs the padded width), which
  moves the model's float32 sums by a few units, and normalises and matches in torch
  (cosines of 32-wide unit vectors, each within about 1e-7);
- InfoLM within 1e-5 relative (1e-6 absolute below 0.1): the port forwards each masked
  copy in batches of copies, not one position for the whole batch, which moves the
  logits by a few float32 units, and the temperature of 0.25 multiplies them by 4
  before the softmax; the divergences then sum 30-odd terms. The Fisher-Rao distance
  ``2 arccos(s)`` is held through ``s = cos(d / 2)``, within 4 float32 units: near
  ``s = 1`` one unit of ``s`` moves the distance by ``sqrt(8 * 2**-24)``, 7e-4.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu.functional.text import bert_score as jax_bert_score
from torchmetrics_tpu.functional.text import infolm as jax_infolm
from torchmetrics_tpu_torch.functional.text import bert_score as port_bert_score
from torchmetrics_tpu_torch.functional.text import infolm as port_infolm

transformers = pytest.importorskip("transformers")

CPU = {"device": "cpu"}
PREDS = [
    "the cat sat on the mat",
    "a quick brown fox jumps over a lazy dog",
    "deep nets learn representations",
    "he read the book because he was interested in world history",
    "the dog",
]
TARGETS = [
    "the cat lay on the rug",
    "the quick brown fox jumped over the lazy dog",
    "neural networks learn features",
    "he was interested in world history because he read the book",
    "a lazy dog sat on the book",
]
VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] the a cat sat lay on mat rug quick brown fox jumps "
    "jumped over lazy dog deep neural nets networks learn representations features he "
    "read book because was interested in world history".split()
)


def _write_model(directory, masked_lm: bool) -> str:
    from transformers import BertConfig, BertForMaskedLM, BertModel, BertTokenizer

    vocab_file = os.path.join(directory, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(VOCAB))
    torch.manual_seed(16)
    config = BertConfig(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                        intermediate_size=64, max_position_embeddings=64, max_length=20)
    (BertForMaskedLM if masked_lm else BertModel)(config).save_pretrained(directory)
    BertTokenizer(vocab_file).save_pretrained(directory)
    return str(directory)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one thread: the suite runs several test processes at once,
    and torch's default of a thread a core in each of them makes these forwards wait on
    one another many times over. The caller's setting comes back after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    return _write_model(tmp_path_factory.mktemp("tiny_bert"), masked_lm=False)


@pytest.fixture(scope="module")
def mlm_dir(tmp_path_factory):
    return _write_model(tmp_path_factory.mktemp("tiny_mlm"), masked_lm=True)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _near(port, ref, atol: float = 0.0, rtol: float = 0.0, context: str = "") -> None:
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), context
        for key in ref:
            _near(port[key], ref[key], atol, rtol, f"{context} {key}")
        return
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    np.testing.assert_allclose(p, r, rtol=rtol, atol=atol, err_msg=context)


def _token_states(metric) -> dict:
    return {k: np.concatenate([_np(v) for v in rows]) for k, rows in metric._state.items()}


# ------------------------------------------------------------------------ BERTScore

@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("num_layers", [None, 2])
@pytest.mark.parametrize("batch_size", [2, 64])
def test_bert_score_matches_the_jax_package(bert_dir, idf, num_layers, batch_size):
    kw = {"model_name_or_path": bert_dir, "idf": idf, "num_layers": num_layers, "batch_size": batch_size}
    want = jax_bert_score(PREDS, TARGETS, **kw)
    got = port_bert_score(PREDS, TARGETS, **kw, **CPU)
    _near(got, want, atol=1e-5)


def test_bert_score_multiple_references_pick_the_best_f1(bert_dir):
    target = [[t, p] for p, t in zip(PREDS, TARGETS)]
    target[2] = [TARGETS[2]]
    want = jax_bert_score(PREDS, target, model_name_or_path=bert_dir)
    got = port_bert_score(PREDS, target, model_name_or_path=bert_dir, **CPU)
    _near(got, want, atol=1e-5)
    assert float(got["f1"][0]) == pytest.approx(1.0, abs=1e-6)  # the prediction itself is a reference


def test_bert_score_class_matches_the_jax_package(bert_dir):
    """Updates in three batches: the token states, compute, ``merge_state`` of three
    shards and a checkpoint from the JAX package."""
    kw = {"model_name_or_path": bert_dir, "idf": True, "max_length": 24, "batch_size": 3}
    jax_metric = jtm.text.BERTScore(**kw)
    port_metric = ttm.text.BERTScore(**kw, **CPU)
    parts = [slice(0, 2), slice(2, 4), slice(4, 5)]
    for part in parts:
        jax_metric.update(PREDS[part], TARGETS[part])
        port_metric.update(PREDS[part], TARGETS[part])
    want_states = _token_states(jax_metric)
    _near(_token_states(port_metric), want_states, context="states")
    want = jax_metric.compute()
    _near(port_metric.compute(), want, atol=1e-5)
    shards = [ttm.text.BERTScore(**kw, **CPU) for _ in parts]
    for shard, part in zip(shards, parts):
        shard.update(PREDS[part], TARGETS[part])
    shards[0].merge_state(shards[1])
    shards[0].merge_state(shards[2])
    _near(_token_states(shards[0]), want_states, context="merged states")
    _near(shards[0].compute(), want, atol=1e-5)
    jax_metric.persistent(True)
    restored = ttm.text.BERTScore(**kw, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _near(restored.compute(), want, atol=1e-5)


def test_bert_score_user_model_and_forward_fn_run_on_the_metrics_device():
    """A user ``nn.Module`` moves to the metric's device; ``user_forward_fn`` gets the
    model and the int64 token tensors there."""
    table = torch.nn.Embedding(16, 8)
    seen = []

    def forward_fn(model, batch):
        seen.append((batch["input_ids"].dtype, batch["input_ids"].device, next(model.parameters()).device))
        return model(batch["input_ids"])

    ids = {"input_ids": np.asarray([[1, 5, 6, 2, 0], [1, 7, 2, 0, 0]]),
           "attention_mask": np.asarray([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]])}
    other = {"input_ids": np.asarray([[1, 6, 5, 2, 0], [1, 7, 8, 9, 2]]),
             "attention_mask": np.asarray([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]])}
    got = port_bert_score(ids, other, model=table, user_forward_fn=forward_fn, **CPU)
    want = jax_bert_score(ids, other, model=table, user_forward_fn=lambda m, b: m(torch.as_tensor(b["input_ids"]))
                          .detach().numpy())
    _near(got, want, atol=1e-6)
    assert seen and all(s == (torch.int64, torch.device("cpu"), torch.device("cpu")) for s in seen)
    with pytest.raises(ValueError, match="user_tokenizer"):
        ttm.text.BERTScore(model=table, **CPU)


def test_bert_score_argument_errors_are_the_jax_packages(bert_dir, monkeypatch):
    for kw in ({"all_layers": True}, {"rescale_with_baseline": True}):
        with pytest.raises((ValueError, ModuleNotFoundError)) as jax_err:
            jax_bert_score(PREDS, TARGETS, model_name_or_path=bert_dir, **kw)
        with pytest.raises(type(jax_err.value)) as port_err:
            port_bert_score(PREDS, TARGETS, model_name_or_path=bert_dir, **kw, **CPU)
        assert str(port_err.value) == str(jax_err.value)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(ModuleNotFoundError, match="local HF cache"):
        port_bert_score(PREDS, TARGETS, model_name_or_path="no-such-local-model", **CPU)


# --------------------------------------------------------------------------- InfoLM

MEASURES = [
    ("kl_divergence", None, None),
    ("alpha_divergence", 0.5, None),
    ("beta_divergence", None, 0.7),
    ("ab_divergence", 0.25, 0.7),
    ("renyi_divergence", 0.3, None),
    ("l1_distance", None, None),
    ("l2_distance", None, None),
    ("l_infinity_distance", None, None),
    ("fisher_rao_distance", None, None),
]


def _near_infolm(port, ref, context: str = "", measure: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, context
    if measure == "fisher_rao_distance":
        # 2 arccos(s) turns a unit of s near 1 into sqrt(8 u): hold s = cos(d / 2) instead
        p, r = np.cos(p.astype(np.float64) / 2), np.cos(r.astype(np.float64) / 2)
        np.testing.assert_allclose(p, r, rtol=0, atol=4 * 2.0**-24, err_msg=context)
        return
    np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6, err_msg=context)


@pytest.mark.parametrize("measure, alpha, beta", MEASURES, ids=[m[0] for m in MEASURES])
@pytest.mark.parametrize("idf", [False, True])
def test_infolm_matches_the_jax_package(mlm_dir, measure, alpha, beta, idf):
    kw = {"model_name_or_path": mlm_dir, "information_measure": measure, "alpha": alpha, "beta": beta, "idf": idf,
          "batch_size": 3, "return_sentence_level_score": True}
    want_mean, want = jax_infolm(PREDS, TARGETS, **kw)
    got_mean, got = port_infolm(PREDS, TARGETS, **kw, **CPU)
    _near_infolm(got, want, "sentences", measure)
    if measure != "fisher_rao_distance":  # a mean of distances, each held through its cosine
        _near_infolm(got_mean, want_mean, "mean")


def test_infolm_class_matches_the_jax_package(mlm_dir):
    kw = {"model_name_or_path": mlm_dir, "temperature": 0.5, "batch_size": 4, "return_sentence_level_score": True}
    jax_metric = jtm.text.InfoLM(**kw)
    port_metric = ttm.text.InfoLM(**kw, **CPU)
    assert port_metric.max_length == jax_metric.max_length == 20  # the config's, as the JAX package takes it
    parts = [slice(0, 2), slice(2, 3), slice(3, 5)]
    for part in parts:
        jax_metric.update(PREDS[part], TARGETS[part])
        port_metric.update(PREDS[part], TARGETS[part])
    want_states = _token_states(jax_metric)
    _near(_token_states(port_metric), want_states, context="states")
    want_mean, want = jax_metric.compute()
    got_mean, got = port_metric.compute()
    _near_infolm(got, want)
    _near_infolm(got_mean, want_mean)
    shards = [ttm.text.InfoLM(**kw, **CPU) for _ in parts]
    for shard, part in zip(shards, parts):
        shard.update(PREDS[part], TARGETS[part])
    shards[0].merge_state(shards[1])
    shards[0].merge_state(shards[2])
    _near(_token_states(shards[0]), want_states, context="merged states")
    jax_metric.persistent(True)
    restored = ttm.text.InfoLM(**kw, **CPU)
    restored.load_state_dict(jax_metric.state_dict())
    _near_infolm(restored.compute()[1], want)


def test_infolm_batched_copies_give_the_position_loop_distributions(mlm_dir):
    """The port's batches of masked copies against the JAX package's loop over
    positions, compared as distributions: sizes of 1, 3 and 64 copies a forward."""
    import importlib

    jax_module = importlib.import_module("torchmetrics_tpu.functional.text.infolm")
    port_module = importlib.import_module("torchmetrics_tpu_torch.functional.text.infolm")
    tokenizer, forward, max_len, special = jax_module._infolm_prepare(mlm_dir, None, None, None)
    tok = jax_module._infolm_tokenize(tokenizer, PREDS, max_len)
    want = jax_module._sentence_distributions(forward, tok["input_ids"], tok["attention_mask"], 0.25, True, special, 2)
    _, port_forward, _, port_special = port_module._infolm_prepare(mlm_dir, None, None, None, torch.device("cpu"))
    for batch_size in (1, 3, 64):
        got = port_module._sentence_distributions(port_forward, tok["input_ids"], tok["attention_mask"], 0.25, True,
                                                  port_special, batch_size, torch.device("cpu"))
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-8, err_msg=str(batch_size))
        np.testing.assert_allclose(_np(got).sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("measure, alpha, beta", [
    ("bogus", None, None), ("alpha_divergence", None, None), ("alpha_divergence", 1.0, None),
    ("beta_divergence", None, -1.0), ("ab_divergence", 0.5, -0.5), ("renyi_divergence", 1.0, None),
])
def test_infolm_measure_errors_are_the_jax_packages(measure, alpha, beta):
    from torchmetrics_tpu.functional.text.infolm import _InformationMeasure as JaxMeasure

    from torchmetrics_tpu_torch.functional.text.infolm import _InformationMeasure as PortMeasure

    with pytest.raises(ValueError) as jax_err:
        JaxMeasure(measure, alpha, beta)
    with pytest.raises(ValueError) as port_err:
        PortMeasure(measure, alpha, beta)
    assert str(port_err.value) == str(jax_err.value)
