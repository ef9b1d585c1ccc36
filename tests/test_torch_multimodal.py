"""The port's CLIPScore and CLIP-IQA against the JAX package, on the CPU, through one tiny
random HF CLIP (a character BPE vocabulary, a 32x32 vision tower) written to disk once
for the module, as ``tests/test_clip_hf.py`` writes it, and loaded by path by both
packages with ``local_files_only=True``; and through a user embedder object.

Both packages run the same HF model in torch on the CPU, on the same processor output
(the port builds its processor from the saved files with the image processor that
needs no torchvision, which under transformers 4 is the one the JAX package's
``CLIPProcessor`` loads). Tolerances:

- pixel values, token ids and the embedder's features bit for bit;
- scores within 4 float32 units of 100 (1e-4 is the JAX package's own against the
  reference): the unit normalisation and the 16-wide dot products are XLA's in the JAX
  package and torch's in the port; the class's ``n_samples`` bit for bit;
- CLIP-IQA's probabilities within 1e-5 absolute: a sigmoid of 100 times the difference
  of two cosines, each within a float32 unit or two.
"""

from __future__ import annotations

import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm

transformers = pytest.importorskip("transformers")

# the packages' ``functional.multimodal`` export a function of the module's name
jax_clip_score_fn = importlib.import_module("torchmetrics_tpu.functional.multimodal.clip_score")
port_clip_score_fn = importlib.import_module("torchmetrics_tpu_torch.functional.multimodal.clip_score")

CPU = {"device": "cpu"}
CAPTIONS = ["a cat on a mat", "a dog in fog", "blue car near a bar", "sun over a hill"]
SCORE_ATOL = 4 * 100 * 2.0**-24
PROB_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model runs on one thread: the suite runs several test processes at once.
    The caller's setting comes back after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    from transformers import CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPProcessor, CLIPTokenizer

    d = tmp_path_factory.mktemp("tiny-clip")
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for c in "abcdefghijklmnopqrstuvwxyz.":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tokenizer = CLIPTokenizer(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"))
    image_processor = CLIPImageProcessor(size={"shortest_edge": 32}, crop_size={"height": 32, "width": 32})
    CLIPProcessor(image_processor=image_processor, tokenizer=tokenizer).save_pretrained(d)
    torch.manual_seed(17)
    config = CLIPConfig(
        text_config={"vocab_size": len(vocab), "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                     "intermediate_size": 64, "max_position_embeddings": 77},
        vision_config={"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                       "intermediate_size": 64, "image_size": 32, "patch_size": 8},
        projection_dim=16,
    )
    CLIPModel(config).save_pretrained(d)
    return str(d)


def _images(n: int = 4, seed: int = 0, size: int = 32) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (3, size, size), dtype=np.uint8) for _ in range(n)]


def _port(data):
    """The port's inputs: CPU tensors for images, strings as they are."""
    return [torch.from_numpy(x) for x in data] if not isinstance(data[0], str) else data


PAIRS = {
    "image-text": (lambda: _images(), lambda: CAPTIONS),
    "text-image": (lambda: CAPTIONS, lambda: _images(seed=1)),
    "text-text": (lambda: CAPTIONS[:2], lambda: CAPTIONS[2:]),
    "image-image": (lambda: _images(2, seed=2), lambda: _images(2, seed=3)),
}


def test_processor_output_and_features_are_the_jax_packages(clip_dir):
    jax_model = jax_clip_score_fn._resolve_clip(clip_dir)
    port_model = port_clip_score_fn._resolve_clip(clip_dir, torch.device("cpu"))
    images = _images()
    want = jax_model.processor(images=images, return_tensors="pt", padding=True)["pixel_values"]
    assert torch.equal(port_model.pixel_values(_port(images)), want)
    ids, mask = port_model.tokens(CAPTIONS)
    processed = jax_model.processor(text=CAPTIONS, return_tensors="pt", padding=True)
    assert torch.equal(ids, processed["input_ids"]) and torch.equal(mask, processed["attention_mask"])
    unk = port_model.processor.tokenizer.unk_token_id  # CLIP's is <|endoftext|>, which also ends a row
    assert all((row[m.bool()][1:-1] != unk).all() for row, m in zip(ids, mask))
    np.testing.assert_array_equal(port_model.get_image_features(_port(images)).numpy(),
                                  np.asarray(jax_model.get_image_features(images)))
    np.testing.assert_array_equal(port_model.get_text_features(CAPTIONS).numpy(),
                                  np.asarray(jax_model.get_text_features(CAPTIONS)))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_clip_score_function_matches_jax(clip_dir, pair):
    source, target = (make() for make in PAIRS[pair])
    want = jtm.functional.clip_score(source, target, model_name_or_path=clip_dir)
    got = ttm.functional.clip_score(_port(source), _port(target), model_name_or_path=clip_dir, **CPU)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_clip_score_class_states_match_jax(clip_dir, pair):
    source, target = (make() for make in PAIRS[pair])
    jax_metric = jtm.multimodal.CLIPScore(model_name_or_path=clip_dir)
    port_metric = ttm.multimodal.CLIPScore(model_name_or_path=clip_dir, **CPU)
    half = len(source) // 2 or 1
    for sl in (slice(0, half), slice(half, None)):
        jax_metric.update(source[sl], target[sl])
        port_metric.update(_port(source[sl]), _port(target[sl]))
    jax_state, port_state = jax_metric.metric_state, port_metric.metric_state
    assert port_state["score"].dtype == torch.float32 and np.asarray(jax_state["score"]).dtype == np.float32
    assert port_state["n_samples"].dtype == torch.int32 and np.asarray(jax_state["n_samples"]).dtype == np.int32
    assert int(port_state["n_samples"]) == int(np.asarray(jax_state["n_samples"])) == len(source)
    np.testing.assert_allclose(float(port_state["score"]), float(np.asarray(jax_state["score"])), rtol=0,
                               atol=len(source) * SCORE_ATOL)
    np.testing.assert_allclose(float(port_metric.compute()), float(jax_metric.compute()), rtol=0, atol=SCORE_ATOL)
    assert port_metric.feature_network == "model"


def test_clip_score_rejects_what_jax_rejects(clip_dir):
    with pytest.raises(ValueError, match="number of source and target"):
        ttm.functional.clip_score(_port(_images(3)), CAPTIONS, model_name_or_path=clip_dir, **CPU)
    with pytest.raises(ValueError, match="3d"):
        ttm.functional.clip_score([torch.zeros(1, 3, 8, 8)], ["a"], model_name_or_path=clip_dir, **CPU)
    with pytest.raises(ModuleNotFoundError, match="local HF cache"):
        ttm.multimodal.CLIPScore(model_name_or_path="openai/not-in-the-cache", **CPU)
    with pytest.raises(ValueError, match="get_image_features"):
        ttm.multimodal.CLIPScore(model_name_or_path=3, **CPU)


# --------------------------------------------------------------------- CLIP-IQA

PROMPTS = ("quality", ("Sharp cat.", "Blurry dog."), "brightness", ("Clean photo.", "Noisy photo."))


def _unit_images(n: int = 3, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (n, 3, 32, 32)).astype(np.float32)


def test_clip_iqa_class_prompts_match_jax(clip_dir):
    imgs = _unit_images()
    jax_metric = jtm.multimodal.CLIPImageQualityAssessment(clip_dir, prompts=PROMPTS)
    port_metric = ttm.multimodal.CLIPImageQualityAssessment(clip_dir, prompts=PROMPTS, **CPU)
    assert port_metric.prompt_names == jax_metric.prompt_names == [
        "quality", "user_defined_0", "brightness", "user_defined_1"]
    for batch in (imgs[:2], imgs[2:]):
        jax_metric.update(batch)
        port_metric.update(torch.from_numpy(batch))
    want, got = jax_metric.compute(), port_metric.compute()
    assert list(got) == list(want)
    for name in want:
        assert got[name].shape == (3,) and got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=PROB_ATOL, err_msg=name)
    np.testing.assert_allclose(port_metric._prompt_anchors().numpy(), np.asarray(jax_metric._prompt_anchors()),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("data_range", [1.0, 255.0])
def test_clip_iqa_single_prompt_squeezes_as_in_jax(clip_dir, data_range):
    imgs = _unit_images(2) * data_range
    for n in (2, 1):
        want = jtm.functional.clip_image_quality_assessment(imgs[:n], clip_dir, data_range)
        got = ttm.functional.clip_image_quality_assessment(torch.from_numpy(imgs[:n]), clip_dir, data_range, **CPU)
        assert got.shape == np.shape(want) == ((n,) if n > 1 else ())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PROB_ATOL)
    metric = ttm.multimodal.CLIPImageQualityAssessment(clip_dir, data_range, **CPU)
    metric.update(torch.from_numpy(imgs[:1]))
    assert metric.compute().shape == ()


def test_clip_iqa_functional_dict_and_gate_match_jax(clip_dir):
    imgs = _unit_images(2, seed=6)
    prompts = ("noisiness", ("Good cat.", "Bad cat."))
    want = jtm.functional.clip_image_quality_assessment(imgs, clip_dir, prompts=prompts)
    got = ttm.functional.clip_image_quality_assessment(list(torch.from_numpy(imgs)), clip_dir, prompts=prompts, **CPU)
    assert list(got) == list(want) == ["noisiness", "user_defined_0"]
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=PROB_ATOL)
    for build in (lambda: jtm.multimodal.CLIPImageQualityAssessment(),
                  lambda: ttm.multimodal.CLIPImageQualityAssessment(**CPU)):
        with pytest.raises(ModuleNotFoundError, match="clip_iqa"):
            build()
    with pytest.raises(ValueError, match="Unknown prompt"):
        ttm.multimodal.CLIPImageQualityAssessment(clip_dir, prompts=("crispness",), **CPU)
    with pytest.raises(ValueError, match="data_range"):
        ttm.multimodal.CLIPImageQualityAssessment(clip_dir, data_range=0, **CPU)


# ----------------------------------------------------------- a user embedder

_EMB = np.random.default_rng(21).normal(size=(64, 12)).astype(np.float32)


class _Embedder:
    """A deterministic user embedder: images by a projection of their first 12 values,
    texts by summed word embeddings. ``lib`` is ``jnp`` or ``torch``."""

    def __init__(self, lib) -> None:
        self.lib = lib

    def _array(self, x):
        return jnp.asarray(x) if self.lib is jnp else torch.from_numpy(np.ascontiguousarray(x))

    def get_image_features(self, images):
        flat = np.stack([np.asarray(i, np.float32).reshape(-1)[:12] for i in images])
        return self._array(flat @ _EMB[:12, :8])

    def get_text_features(self, texts):
        return self._array(np.stack([_EMB[[sum(map(ord, w)) % 64 for w in t.split()], :8].sum(0) for t in texts]))


def test_user_embedder_matches_jax():
    images = _images(3, seed=8)
    texts = CAPTIONS[:3]
    want = jtm.functional.clip_score(images, texts, model_name_or_path=_Embedder(jnp))
    got = ttm.functional.clip_score(_port(images), texts, model_name_or_path=_Embedder(torch), **CPU)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=SCORE_ATOL)
    jax_metric = jtm.multimodal.CLIPScore(model_name_or_path=_Embedder(jnp))
    port_metric = ttm.multimodal.CLIPScore(model_name_or_path=_Embedder(torch), **CPU)
    for pair in ((images, texts), (texts[:2], texts[1:])):
        jax_metric.update(*pair)
        port_metric.update(*(_port(p) for p in pair))
    np.testing.assert_allclose(float(port_metric.compute()), float(jax_metric.compute()), rtol=0, atol=SCORE_ATOL)
    assert int(port_metric.n_samples) == 5
    imgs = _unit_images(2)
    want = jtm.multimodal.CLIPImageQualityAssessment(_Embedder(jnp), prompts=PROMPTS[:2])
    got = ttm.multimodal.CLIPImageQualityAssessment(_Embedder(torch), prompts=PROMPTS[:2], **CPU)
    want.update(imgs)
    got.update(torch.from_numpy(imgs))
    for name, value in want.compute().items():
        np.testing.assert_allclose(got.compute()[name].numpy(), np.asarray(value), rtol=0, atol=PROB_ATOL)
