"""The port's examples (``python -m torchmetrics_tpu_torch.examples.<name> --device cpu``)
run in subprocesses, print, and give the numbers of the same computation made here
through the JAX package on the same numpy inputs:

- ``checkpoint_resume``: the resumed and the uninterrupted values and the accuracy's
  extrema over the stream within 1e-6 of the JAX package's collection and
  ``MinMaxMetric`` (the same counts; AUROC's binned sums in another order);
- ``fid_clipscore_custom_extractor``: FID within 1e-4 relative of the JAX package's FID
  behind the same numpy projection (the moments, the covariances and the matrix square
  root round differently in XLA and in torch), CLIPScore within 1e-4 behind the same
  ``zlib.crc32`` word embedding;
- ``distributed_eval_loop`` (two gloo ranks): the values of the JAX package's
  collection over the whole epoch, the confusion matrix equal, the rest within 1e-6.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("checkpoint_resume", "fid_clipscore_custom_extractor", "distributed_eval_loop")
WALL_S = 300
VALUE_ATOL = 1e-6
FID_RTOL = 1e-4
CLIP_ATOL = 1e-4


class _Runs:
    """Every example started at once; each collected when a test first reads it, so the
    JAX references below run while the examples do."""

    def __init__(self, cwd: pathlib.Path) -> None:
        env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
        env.update(PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]), GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS="1")
        self.procs = {name: subprocess.Popen(
            [sys.executable, "-m", f"torchmetrics_tpu_torch.examples.{name}", "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(cwd)) for name in EXAMPLES}
        self.done: dict = {}

    def __getitem__(self, name: str) -> tuple:
        """``(rc, stdout, stderr)`` of one example."""
        if name not in self.done:
            stdout, stderr = self.procs[name].communicate(timeout=WALL_S)
            self.done[name] = (self.procs[name].returncode, stdout, stderr)
        return self.done[name]

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started = _Runs(tmp_path_factory.mktemp("examples"))
    yield started
    started.close()


def _numbers(runs, name) -> dict:
    rc, stdout, stderr = runs[name]
    assert rc == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


def test_checkpoint_resume_numbers_equal_the_jax_computation(runs):
    from torchmetrics_tpu import MetricCollection
    from torchmetrics_tpu.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
    from torchmetrics_tpu.wrappers import MinMaxMetric

    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(5), size=512).astype(np.float32)
    target = rng.integers(0, 5, 512).astype(np.int32)
    collection = MetricCollection({
        "acc": MulticlassAccuracy(num_classes=5, average="micro"),
        "f1": MulticlassF1Score(num_classes=5, average="macro"),
        "auroc": MulticlassAUROC(num_classes=5, thresholds=64),
    })
    tracker = MinMaxMetric(MulticlassAccuracy(num_classes=5, average="micro"))
    for i in range(0, 512, 64):
        p, t = jnp.asarray(probs[i:i + 64]), jnp.asarray(target[i:i + 64])
        collection.update(p, t)
        tracker(p, t)
    want = {k: float(v) for k, v in collection.compute().items()}
    extrema = {k: float(v) for k, v in tracker.compute().items()}
    got = _numbers(runs, "checkpoint_resume")
    assert got["truncated_rejected"] is True
    for block in ("resumed", "uninterrupted"):
        assert set(got[block]) == set(want)
        for key, value in want.items():
            assert abs(got[block][key] - value) <= VALUE_ATOL, (block, key)
    assert set(got["extrema"]) == set(extrema)
    for key, value in extrema.items():
        assert abs(got["extrema"][key] - value) <= VALUE_ATOL, key


def test_fid_and_clipscore_numbers_equal_the_jax_computation(runs):
    from torchmetrics_tpu.image import FrechetInceptionDistance
    from torchmetrics_tpu.multimodal import CLIPScore
    from torchmetrics_tpu_torch.examples.fid_clipscore_custom_extractor import tiny_projection

    rng = np.random.default_rng(0)
    proj = jnp.asarray(tiny_projection())

    @jax.jit
    def extractor(imgs):
        pooled = imgs.reshape(imgs.shape[0], 3, -1)
        return jnp.concatenate([pooled.mean(-1), pooled.std(-1)], axis=-1) @ proj

    fid = FrechetInceptionDistance(feature=extractor, normalize=True)
    fid.update(jnp.asarray(rng.random((64, 3, 32, 32)).astype(np.float32)), real=True)
    fid.update(jnp.asarray((rng.random((64, 3, 32, 32)) * 0.8).astype(np.float32)), real=False)
    want_fid = float(fid.compute())
    got = _numbers(runs, "fid_clipscore_custom_extractor")
    assert abs(got["fid"] - want_fid) <= FID_RTOL * abs(want_fid), (got["fid"], want_fid)

    emb = rng.normal(size=(512, 48)).astype(np.float32)

    class ToyClip:
        def get_image_features(self, images):
            return jnp.stack([jnp.asarray(i, jnp.float32).reshape(-1)[:48] for i in images])

        def get_text_features(self, texts):
            return jnp.stack([jnp.asarray(emb[[zlib.crc32(w.encode()) % 512 for w in t.split()]].sum(0))
                              for t in texts])

    clip_score = CLIPScore(model_name_or_path=ToyClip())
    images = [jnp.asarray(rng.random((3, 16, 16)).astype(np.float32)) for _ in range(8)]
    clip_score.update(images, [f"a photo of object {i}" for i in range(8)])
    assert abs(got["clip_score"] - float(clip_score.compute())) <= CLIP_ATOL


def test_distributed_eval_loop_values_equal_the_jax_collection(runs):
    from torchmetrics_tpu import MetricCollection
    from torchmetrics_tpu.classification import (
        MulticlassAccuracy,
        MulticlassAUROC,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
    )

    collection = MetricCollection({
        "acc": MulticlassAccuracy(10, average="micro"),
        "f1": MulticlassF1Score(10, average="macro"),
        "auroc": MulticlassAUROC(10, thresholds=128),
        "confmat": MulticlassConfusionMatrix(10),
    })
    rng = np.random.default_rng(0)
    for _ in range(4):
        logits = rng.normal(size=(1024, 10)).astype(np.float32)
        target = rng.integers(0, 10, 1024).astype(np.int32)
        collection.update(jax.nn.softmax(jnp.asarray(logits)), jnp.asarray(target))
    want = collection.compute()
    got = _numbers(runs, "distributed_eval_loop")
    assert got["ranks"] == 2 and got["backend"] == "gloo"
    np.testing.assert_array_equal(np.asarray(got["values"]["confmat"]), np.asarray(want["confmat"]))
    for key in ("acc", "f1", "auroc"):
        assert abs(got["values"][key] - float(want[key])) <= VALUE_ATOL, key


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu_and_prints(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, stderr[-3000:]
    lines = stdout.strip().splitlines()
    assert len(lines) >= 2, stdout
    assert isinstance(json.loads(lines[-1]), dict)
