"""Rules of the PyTorch/CUDA port that hold whatever the numbers:

- no module of ``torchmetrics_tpu_torch`` and not ``chip_smoke.py`` imports JAX or the
  JAX package (top-level module names compared exactly: ``torchmetrics_tpu_torch``
  starts with ``torchmetrics_tpu`` and must not match it);
- an entry point whose device is left at its default (CUDA) raises where there is no
  CUDA, instead of running on the CPU;
- every ``Example:`` block in the port's docstrings runs.
"""

from __future__ import annotations

import ast
import doctest
import importlib
import pathlib
import pkgutil

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.classification import MulticlassAccuracy
from torchmetrics_tpu_torch import (audio, classification, clustering, detection, functional, image, multimodal,
                                    nominal, regression, retrieval, segmentation, shape, text, utilities, video,
                                    wrappers)
from torchmetrics_tpu_torch.image import (
    FrechetInceptionDistance,
    InceptionScore,
    InceptionV3Features,
    KernelInceptionDistance,
    MemorizationInformedFrechetInceptionDistance,
)
from torchmetrics_tpu_torch.utilities.checks import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "torchmetrics_tpu"}
PORT_FILES = sorted((ROOT / "torchmetrics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_top_levels(source: str) -> set:
    """Top-level names of every absolute import in ``source``."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize(
    "source, flagged",
    [
        ("import jax.numpy as jnp", {"jax"}),
        ("from torchmetrics_tpu.image import FID", {"torchmetrics_tpu"}),
        ("import torchmetrics_tpu_torch.metric", set()),
        ("from torchmetrics_tpu_torch import Metric", set()),
        ("def f():\n    from jax import lax\n", {"jax"}),
        ("from .metric import Metric", set()),
    ],
)
def test_import_scanner_compares_exact_top_level_names(source, flagged):
    assert _imported_top_levels(source) & FORBIDDEN == flagged


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.is_file()
    assert not _imported_top_levels(path.read_text()) & FORBIDDEN


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _toy_extractor(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :4].float()


@pytest.mark.parametrize(
    "build",
    [
        lambda: MulticlassAccuracy(5),
        lambda: InceptionV3Features(),
        lambda: InceptionV3Features.from_numpy_params({}),
        lambda: FrechetInceptionDistance(feature=_toy_extractor),
        lambda: MetricCollection({"acc": MulticlassAccuracy(5, device="cpu")}),
        lambda: resolve_device(None),
        lambda: resolve_device("cuda:0"),
        lambda: detection.PaddedDetectionAccumulator(4),
        lambda: detection.pack_detection_batch([], [], 2, 2),
        lambda: detection.MeanAveragePrecision(),
        lambda: detection.MeanAveragePrecision(backend="device"),
        lambda: detection.DeviceMeanAveragePrecision(),
        lambda: detection.IntersectionOverUnion(),
        lambda: detection.GeneralizedIntersectionOverUnion(),
        lambda: detection.DistanceIntersectionOverUnion(),
        lambda: detection.CompleteIntersectionOverUnion(),
        lambda: KernelInceptionDistance(feature=_toy_extractor),
        lambda: MemorizationInformedFrechetInceptionDistance(feature=_toy_extractor),
        lambda: InceptionScore(feature=_toy_extractor),
        lambda: classification.MulticlassJaccardIndex(3),
        lambda: classification.ExactMatch(task="multiclass", num_classes=3),
        lambda: classification.BinaryAUROC(thresholds=10),
        lambda: classification.MulticlassAveragePrecision(3),
        lambda: functional.binary_auroc([0.25, 0.75], [0, 1]),
        lambda: classification.BinaryCalibrationError(),
        lambda: classification.HingeLoss(task="multiclass", num_classes=3),
        lambda: classification.MultilabelRankingLoss(3),
        lambda: classification.BinaryFairness(2),
        lambda: classification.MulticlassEER(3),
        lambda: classification.LogAUC(task="binary"),
        lambda: classification.MultilabelRecallAtFixedPrecision(3, min_precision=0.5),
        lambda: functional.binary_sensitivity_at_specificity([0.25, 0.75], [0, 1], 0.5),
        lambda: wrappers.BootStrapper(MulticlassAccuracy(3)),
        lambda: wrappers.MinMaxMetric(MulticlassAccuracy(3, device="cpu"), device="cuda"),
        lambda: wrappers.Running(regression.MeanSquaredError()),
        lambda: wrappers.FeatureShare([FrechetInceptionDistance(feature=_toy_extractor)]),
        lambda: wrappers.FeatureShare([FrechetInceptionDistance(feature=_toy_extractor, device="cpu")], device="cuda"),
        lambda: detection.PanopticQuality({0}, {1}),
        lambda: functional.panoptic_quality(np.zeros((1, 2, 2, 2), np.int64), np.zeros((1, 2, 2, 2), np.int64),
                                            {0}, {1}),
        lambda: retrieval.RetrievalNormalizedDCG(top_k=10),
        lambda: segmentation.MeanIoU(),
        lambda: functional.retrieval_reciprocal_rank([0.5, 0.25], [1, 0]),
        lambda: functional.hausdorff_distance(np.zeros((1, 2, 4, 4), np.int64), np.zeros((1, 2, 4, 4), np.int64), 2),
    ],
    ids=["metric", "extractor", "extractor_from_params", "fid", "collection", "resolve_none", "resolve_cuda",
         "accumulator", "pack", "map", "map_device_backend", "device_map", "iou", "giou", "diou", "ciou",
         "kid", "mifid", "inception_score", "jaccard", "exact_match", "auroc_binned", "average_precision",
         "functional_auroc", "calibration", "hinge", "ranking_loss", "fairness", "eer", "logauc", "recall_at_precision",
         "functional_sensitivity_at_specificity", "bootstrapper", "minmax_on_cuda", "running", "feature_share",
         "feature_share_on_cuda", "panoptic_quality", "functional_panoptic_quality", "retrieval_ndcg",
         "lazy_mean_iou", "functional_reciprocal_rank", "functional_hausdorff"],
)
def test_default_device_raises_without_cuda(no_cuda, build):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


REGRESSION_ARGS = {"MinkowskiDistance": (2,), "CriticalSuccessIndex": (0.5,)}


@pytest.mark.parametrize("name", sorted(regression.__all__))
def test_regression_class_at_default_device_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(regression, name)(*REGRESSION_ARGS.get(name, ()))


@pytest.mark.parametrize("name", sorted(functional.regression.__all__))
def test_regression_function_on_host_values_raises_without_cuda(no_cuda, name):
    """Lists, not tensors: the function makes them on the default device, CUDA."""
    extra = (2,) if name in ("minkowski_distance", "critical_success_index") else ()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(functional, name)([[0.5, 0.5]], [[0.5, 0.5]], *extra)


@pytest.mark.parametrize("module, name", [(m, n) for m in (retrieval, segmentation) for n in sorted(m.__all__)])
def test_retrieval_and_segmentation_classes_at_default_device_raise_without_cuda(no_cuda, module, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(module, name)(**({"num_classes": 3} if module is segmentation else {}))


HOST_VALUES = {
    **{name: ([0.5, 0.25, 0.75], [1, 0, 1]) for name in functional.retrieval.__all__},
    **{name: ([[[0, 1], [1, 1]]], [[[0, 1], [1, 0]]]) for name in functional.segmentation.__all__},
}


@pytest.mark.parametrize("name", sorted(HOST_VALUES))
def test_retrieval_and_segmentation_functions_on_host_values_raise_without_cuda(no_cuda, name):
    """Lists, not tensors: the function makes them on the default device, CUDA."""
    preds, target = HOST_VALUES[name]
    kw = {"num_classes": 2, "input_format": "index"} if name in functional.segmentation.__all__ else {}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(functional, name)(preds, target, **kw)


SLICE_13_ARGS = {"ClusterAccuracy": {"num_classes": 3}, "CramersV": {"num_classes": 3},
                 "PearsonsContingencyCoefficient": {"num_classes": 3}, "TheilsU": {"num_classes": 3},
                 "TschuprowsT": {"num_classes": 3}}


@pytest.mark.parametrize("module, name", [(m, n) for m in (clustering, nominal, shape) for n in sorted(m.__all__)])
def test_clustering_nominal_and_shape_classes_at_default_device_raise_without_cuda(no_cuda, module, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(module, name)(**SLICE_13_ARGS.get(name, {}))


SLICE_13_HOST_VALUES = {
    **{name: ([0, 1, 1, 0], [1, 1, 0, 0]) for name in functional.clustering.__all__},
    **{name: ([[0.0, 1.0], [1.0, 0.0], [0.0, 0.0], [1.0, 1.0]], [0, 1, 0, 1])
       for name in ("calinski_harabasz_score", "davies_bouldin_score", "dunn_index")},
    **{name: ([0, 1, 1, 0], [1, 1, 0, 0]) for name in functional.nominal.__all__ if not name.endswith("_matrix")},
    **{name: ([[0, 1], [1, 1], [1, 0]],) for name in functional.nominal.__all__ if name.endswith("_matrix")},
    "fleiss_kappa": ([[1, 2], [2, 1]],),
    **{name: ([[0.5, 0.25], [0.75, 1.0]],) for name in functional.pairwise.__all__},
    "procrustes_disparity": ([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]], [[[0.0, 0.0], [2.0, 0.0], [0.0, 1.0]]]),
}


@pytest.mark.parametrize("name", sorted(SLICE_13_HOST_VALUES))
def test_clustering_nominal_pairwise_and_shape_functions_on_host_values_raise_without_cuda(no_cuda, name):
    """Lists, not tensors: the function makes them on the default device, CUDA."""
    kw = {"num_classes": 2} if name == "cluster_accuracy" else {}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(functional, name)(*SLICE_13_HOST_VALUES[name], **kw)


IMAGE_CLASS_ARGS = {"PeakSignalNoiseRatio": {"data_range": 1.0}, "PeakSignalNoiseRatioWithBlockedEffect": {"data_range": 1.0},
                    "FrechetInceptionDistance": {"feature": _toy_extractor},
                    "KernelInceptionDistance": {"feature": _toy_extractor}, "InceptionScore": {"feature": _toy_extractor},
                    "MemorizationInformedFrechetInceptionDistance": {"feature": _toy_extractor}}


@pytest.mark.parametrize("name", sorted(image.__all__))
def test_image_classes_at_default_device_raise_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(image, name)(**IMAGE_CLASS_ARGS.get(name, {}))


def test_top_level_compat_psnr_at_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torchmetrics_tpu_torch.PeakSignalNoiseRatio()


_IMG = np.full((1, 3, 48, 48), 0.5, np.float32).tolist()
IMAGE_HOST_VALUES = {
    **{name: (_IMG, _IMG) for name in functional.image.__all__},
    "image_gradients": (np.zeros((1, 1, 4, 4), np.float32),),
    "total_variation": (_IMG,),
    "spatial_distortion_index": (_IMG, np.zeros((1, 3, 16, 16), np.float32).tolist(), _IMG),
    "quality_with_no_reference": (_IMG, np.zeros((1, 3, 16, 16), np.float32).tolist(), _IMG),
    "arniqa": (_IMG,),
}


class _LinearGenerator:
    """A PPL generator of 3x16x16 images in [0, 255] from 4-d latents (host lists)."""

    def sample(self, num_samples):
        return np.random.default_rng(num_samples).normal(size=(num_samples, 4)).astype(np.float32).tolist()

    def __call__(self, z):
        return (torch.tanh(z.sum(1))[:, None, None, None] + 1).expand(-1, 3, 16, 16) * 127.5


def _mean_gap(img1, img2):
    return (img1 - img2).abs().mean(dim=(1, 2, 3))


IMAGE_HOST_VALUES["perceptual_path_length"] = (_LinearGenerator(),)


@pytest.mark.parametrize("name", sorted(IMAGE_HOST_VALUES))
def test_image_functions_on_host_values_raise_without_cuda(no_cuda, name):
    """Lists (numpy for the gradients, which ask for a ``shape``), not tensors: the
    function makes them on the default device, CUDA."""
    kw = {"data_range": 1.0} if name.startswith("peak_signal_noise_ratio") else {}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(functional, name)(*IMAGE_HOST_VALUES[name], **kw)


def _no_infer(x):
    return x


AUDIO_VIDEO_CLASS_ARGS = {
    "PermutationInvariantTraining": {"metric_func": functional.scale_invariant_signal_noise_ratio},
    "SpeechReverberationModulationEnergyRatio": {"fs": 8000},
    "DeepNoiseSuppressionMeanOpinionScore": {"fs": 16000, "personalized": False, "infer_fns": (_no_infer, _no_infer)},
    "NonIntrusiveSpeechQualityAssessment": {"fs": 16000},
    "PerceptualEvaluationSpeechQuality": {"fs": 16000, "mode": "wb"},
    "ShortTimeObjectiveIntelligibility": {"fs": 16000},
    "VideoMultiMethodAssessmentFusion": {"model_path": "vmaf_v0.6.1.json"},
}


@pytest.mark.parametrize("module, name", [(m, n) for m in (audio, video) for n in sorted(m.__all__)])
def test_audio_and_video_classes_at_default_device_raise_without_cuda(no_cuda, module, name):
    """Before any gate of a wheel, a model file or a checkpoint: the device comes first."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(module, name)(**AUDIO_VIDEO_CLASS_ARGS.get(name, {}))


_WAVE = [[0.5, -0.25, 0.75, 0.0] * 64]
_SPEAKERS = [[[0.5, -0.25] * 8, [0.25, 0.5] * 8]]
_VIDEO = np.full((1, 3, 2, 8, 8), 0.5, np.float32).tolist()
AUDIO_VIDEO_HOST_VALUES = {
    **{name: (_WAVE, _WAVE) for name in ("signal_noise_ratio", "scale_invariant_signal_noise_ratio",
                                         "scale_invariant_signal_distortion_ratio", "signal_distortion_ratio")},
    "source_aggregated_signal_distortion_ratio": (_SPEAKERS, _SPEAKERS),
    "complex_scale_invariant_signal_noise_ratio": (np.ones((1, 2, 3, 2)).tolist(),) * 2,
    "permutation_invariant_training": (_SPEAKERS, _SPEAKERS, functional.scale_invariant_signal_noise_ratio),
    "pit_permutate": (_SPEAKERS, [[1, 0]]),
    "perceptual_evaluation_speech_quality": (_WAVE, _WAVE, 16000, "wb"),
    "short_time_objective_intelligibility": (_WAVE, _WAVE, 16000),
    "speech_reverberation_modulation_energy_ratio": (_WAVE, 8000),
    "deep_noise_suppression_mean_opinion_score": (_WAVE, 16000, False),
    "non_intrusive_speech_quality_assessment": (_WAVE, 16000),
    "calculate_luma": (_VIDEO,),
    "vmaf_features": (_VIDEO, _VIDEO),
    "video_multi_method_assessment_fusion": (_VIDEO, _VIDEO, False, "vmaf_v0.6.1.json"),
}


@pytest.mark.parametrize("name", sorted(AUDIO_VIDEO_HOST_VALUES))
def test_audio_and_video_functions_on_host_values_raise_without_cuda(no_cuda, name):
    """Lists, not tensors: the function makes them on the default device, CUDA, before
    it looks for a wheel, a model or a checkpoint."""
    kw = {"infer_fns": (_no_infer, _no_infer)} if name.startswith("deep_noise") else {}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(functional, name)(*AUDIO_VIDEO_HOST_VALUES[name], **kw)


def test_vmaf_model_on_host_features_raises_without_cuda(no_cuda):
    names = ["VMAF_feature_adm2_score", "VMAF_feature_motion2_score"]
    model = functional.VmafModel({"feature_names": names, "slopes": [1.0] * 3, "intercepts": [0.0] * 3,
                                  "gamma": 0.1, "rho": 0.0, "sv_coef": [1.0], "support_vectors": [[0.0, 0.0]]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.predict({name: [0.5] for name in names})


def _chars(texts, **kw):
    """A tokenizer of characters: [CLS] 1, a character's id, [SEP] 2, [PAD] 0."""
    rows = [[1] + [3 + ord(c) % 5 for c in t] + [2] for t in texts]
    width = max(len(r) for r in rows)
    return {"input_ids": np.asarray([r + [0] * (width - len(r)) for r in rows]),
            "attention_mask": np.asarray([[1] * len(r) + [0] * (width - len(r)) for r in rows])}


_chars.mask_token_id, _chars.pad_token_id, _chars.sep_token_id, _chars.cls_token_id = 7, 0, 2, 1
_EYE = torch.eye(8)
TEXT_CLASS_ARGS = {
    "BERTScore": {"model": lambda ids, mask: _EYE[ids], "user_tokenizer": _chars, "max_length": 8},
    "InfoLM": {"model": lambda ids, mask: _EYE[ids], "user_tokenizer": _chars, "max_length": 8},
    "LipVertexError": {"mouth_map": [0, 1]},
}


@pytest.mark.parametrize("module, name", [(m, n) for m in (text, multimodal) for n in sorted(m.__all__)])
def test_text_and_multimodal_classes_at_default_device_raise_without_cuda(no_cuda, module, name):
    """Before a model is loaded or moved: the device comes first."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(module, name)(**TEXT_CLASS_ARGS.get(name, {}))


_SENTENCES = (["the cat sat"], [["a cat sat"]])
_SPOKEN = (["the cat sat"], ["a cat sat"])
TEXT_HOST_VALUES = {
    **{name: _SENTENCES for name in ("bleu_score", "sacre_bleu_score", "chrf_score", "translation_edit_rate",
                                     "extended_edit_distance", "rouge_score")},
    **{name: _SPOKEN for name in ("char_error_rate", "word_error_rate", "match_error_rate", "word_information_lost",
                                  "word_information_preserved", "edit_distance")},
    "squad": ([{"prediction_text": "1976", "id": "1"}], [{"answers": {"text": ["1976"]}, "id": "1"}]),
    "perplexity": (np.zeros((1, 2, 3), np.float32).tolist(), [[0, 1]]),
    "bert_score": (["abc"], ["abd"]),
    "infolm": (["abc"], ["abd"]),
    "lip_vertex_error": (np.zeros((2, 3, 3), np.float32).tolist(), np.ones((2, 3, 3), np.float32).tolist(), [0]),
}
class _Embedder:
    """A CLIP stand-in: images by their first 4 values, texts by 4 character codes."""

    def get_image_features(self, images):
        return torch.stack([torch.as_tensor(i, dtype=torch.float32).reshape(-1)[:4] + 1 for i in images])

    def get_text_features(self, texts):
        return torch.tensor([[float(ord(c)) for c in (t * 4)[:4]] for t in texts])


TEXT_HOST_VALUES["clip_score"] = (["a cat"], ["a dog"])
TEXT_HOST_VALUES["clip_image_quality_assessment"] = (np.full((2, 3, 4, 4), 0.5, np.float32).tolist(),)
TEXT_FUNCTION_ARGS = {name: TEXT_CLASS_ARGS["BERTScore"] for name in ("bert_score", "infolm")}
TEXT_FUNCTION_ARGS.update({"clip_score": {"model_name_or_path": _Embedder()},
                           "clip_image_quality_assessment": {"model_name_or_path": _Embedder(),
                                                             "prompts": ("quality", ("a", "b"))}})


@pytest.mark.parametrize("name", sorted(TEXT_HOST_VALUES))
def test_text_and_multimodal_functions_on_host_values_raise_without_cuda(no_cuda, name):
    """Strings and lists, not tensors: the function makes its result (and runs its
    model) on the default device, CUDA."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(functional, name)(*TEXT_HOST_VALUES[name], **TEXT_FUNCTION_ARGS.get(name, {}))


ON_CPU_TENSORS = {"perplexity": lambda a: (torch.tensor(a[0]), torch.tensor(a[1])),
                  "lip_vertex_error": lambda a: (torch.tensor(a[0]), torch.tensor(a[1]), a[2])}


@pytest.mark.parametrize("name", sorted(TEXT_HOST_VALUES))
def test_text_and_multimodal_functions_run_on_the_cpu_when_asked(no_cuda, name):
    """``device="cpu"``, or, for the functions of tensors, CPU tensors."""
    args = TEXT_HOST_VALUES[name]
    if name in ON_CPU_TENSORS:
        value = getattr(functional, name)(*ON_CPU_TENSORS[name](args))
    else:
        value = getattr(functional, name)(*args, **TEXT_FUNCTION_ARGS.get(name, {}), device="cpu")
    leaves = value.values() if isinstance(value, dict) else [value]
    assert all(leaf.device == torch.device("cpu") for leaf in leaves)


def test_utilities_at_the_default_device_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        utilities.check_forward_full_state_property(text.WordErrorRate, input_args={"preds": ["a"], "target": ["a"]})


def test_the_new_modules_are_scanned_and_their_doctests_listed():
    for name in ("text.metrics", "functional.text.bert", "functional.text.infolm", "functional.text.perplexity",
                 "multimodal.lve", "functional.multimodal.lve", "utilities.compute", "utilities.checks",
                 "reliability.retry", "reliability.faults", "reliability.guards", "utilities.plot",
                 "utilities.imports"):
        assert f"torchmetrics_tpu_torch.{name}" in PORT_MODULES
        assert ROOT / "torchmetrics_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES


def test_the_observability_modules_are_scanned_and_their_doctests_listed():
    for name in ("observability.quantile", "observability.histograms", "observability.counters",
                 "observability.events", "observability.spans", "observability.memory", "observability.tracing",
                 "observability.costs", "observability.timeseries", "observability.slo", "observability.flightrec",
                 "observability.export", "streaming.telescope", "aot.keys"):
        assert f"torchmetrics_tpu_torch.{name}" in PORT_MODULES
        assert ROOT / "torchmetrics_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES
    for package in ("observability", "streaming", "aot"):
        assert ROOT / "torchmetrics_tpu_torch" / package / "__init__.py" in PORT_FILES


def test_the_streaming_modules_are_scanned_and_their_doctests_listed():
    for name in ("streaming.window", "streaming.drift", "parallel.async_sync"):
        assert f"torchmetrics_tpu_torch.{name}" in PORT_MODULES
        assert ROOT / "torchmetrics_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES


def test_the_serving_and_quantized_sync_modules_are_scanned_and_their_doctests_listed():
    for name in ("serving.engine", "serving.durability", "parallel.quantize", "parallel.mesh", "kernels.sepconv"):
        assert f"torchmetrics_tpu_torch.{name}" in PORT_MODULES
        assert ROOT / "torchmetrics_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES
    assert ROOT / "torchmetrics_tpu_torch" / "serving" / "__init__.py" in PORT_FILES


def test_serving_engine_at_the_default_device_raises_without_cuda(no_cuda):
    """A template built at the default device raises; the engine's stacks live on the
    template's device, so an engine never carries on on the CPU by itself."""
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(MulticlassAccuracy(3, average="micro", validate_args=False), ServingConfig(capacity=2,
                                                                                                 megabatch_size=2))
    engine = ServingEngine(MulticlassAccuracy(3, average="micro", validate_args=False, device="cpu"),
                           ServingConfig(capacity=2, megabatch_size=2))
    engine.update("t", torch.tensor([[0.5, 0.25, 0.25]]), torch.tensor([0]))
    assert all(v.device.type == "cpu" for v in next(iter(engine._classes.values())).stacked.values())


def test_the_chaos_and_fleet_modules_are_scanned_and_their_doctests_listed():
    for name in ("chaos.traffic", "chaos.schedule", "chaos.soak", "fleet.placement", "fleet.membership",
                 "fleet.controller"):
        assert f"torchmetrics_tpu_torch.{name}" in PORT_MODULES
        assert ROOT / "torchmetrics_tpu_torch" / (name.replace(".", "/") + ".py") in PORT_FILES
    for package in ("chaos", "fleet"):
        assert ROOT / "torchmetrics_tpu_torch" / package / "__init__.py" in PORT_FILES


def test_run_soak_at_the_default_device_raises_without_cuda(no_cuda, tmp_path):
    """The soaks build their metrics themselves: at the default device they raise where
    there is no CUDA, before any traffic; ``device="cpu"`` runs. A fleet's hosts take
    the device of the metric its factory builds."""
    import warnings

    from torchmetrics_tpu_torch.chaos import FaultSchedule, SoakConfig, TrafficConfig, run_fleet_soak, run_soak
    from torchmetrics_tpu_torch.fleet import FleetController

    small = SoakConfig(traffic=TrafficConfig(seed=1, tenants=4, steps=12), faults=FaultSchedule([]), capacity=4,
                       megabatch_size=2, sync_every=6)
    fleet = SoakConfig(traffic=TrafficConfig(seed=1, tenants=4, steps=12), capacity=4, megabatch_size=2,
                       durability_dir=str(tmp_path / "fleet"), fleet_hosts=2)
    for call in (lambda: run_soak(small), lambda: run_soak(fleet), lambda: run_fleet_soak(fleet),
                 lambda: FleetController(lambda: MulticlassAccuracy(3), root=str(tmp_path / "fc"), hosts=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        report = run_soak(small, device="cpu")
    assert report.counters["unrecovered_faults"] == 0 and report.counters["admitted"] > 0
    assert "device" not in report.counters and "device" not in report.config
    fc = FleetController(lambda: MulticlassAccuracy(3, device="cpu"), root=str(tmp_path / "fc"), hosts=2)
    assert all(e._device == torch.device("cpu") for e in fc.engines().values())
    fc.close()


def test_explicit_cpu_device_runs_without_cuda(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    metric = MulticlassAccuracy(5, device="cpu")
    assert metric.device == torch.device("cpu") and metric.tp.device == torch.device("cpu")


PORT_MODULES = sorted(
    info.name
    for info in pkgutil.walk_packages(torchmetrics_tpu_torch.__path__, prefix="torchmetrics_tpu_torch.")
    if not info.ispkg
)


@pytest.mark.parametrize("module_name", PORT_MODULES)
def test_port_module_doctests(module_name):
    module = importlib.import_module(module_name)
    failures = []
    for test in doctest.DocTestFinder(exclude_empty=True).find(module, module_name):
        runner = doctest.DocTestRunner(optionflags=doctest.NORMALIZE_WHITESPACE)
        out: list = []
        runner.run(test, out=out.append)
        if runner.failures:
            failures.append("".join(out))
    assert not failures, "\n".join(failures)


MODEL_BACKED_CPU = {
    "LearnedPerceptualImagePatchSimilarity": (lambda: image.LearnedPerceptualImagePatchSimilarity(
        pretrained=False, normalize=True, device="cpu"), (torch.rand(2, 3, 32, 32), torch.rand(2, 3, 32, 32))),
    "DeepImageStructureAndTextureSimilarity": (lambda: image.DeepImageStructureAndTextureSimilarity(
        pretrained=False, device="cpu"), (torch.rand(1, 3, 32, 32), torch.rand(1, 3, 32, 32))),
    "ARNIQA": (lambda: image.ARNIQA(scorer=lambda x: x.mean(dim=(1, 2, 3)), device="cpu"),
               (torch.rand(2, 3, 8, 8),)),
    "PerceptualPathLength": (lambda: image.PerceptualPathLength(num_samples=4, batch_size=2, sim_net=_mean_gap,
                                                                lower_discard=None, upper_discard=None,
                                                                device="cpu"), (_LinearGenerator(),)),
    "CLIPScore": (lambda: multimodal.CLIPScore(_Embedder(), device="cpu"), (["a cat"], ["a dog"])),
    "CLIPImageQualityAssessment": (lambda: multimodal.CLIPImageQualityAssessment(_Embedder(), device="cpu"),
                                   (torch.rand(2, 3, 4, 4),)),
}


@pytest.mark.parametrize("name", sorted(MODEL_BACKED_CPU))
def test_model_backed_classes_run_on_the_cpu_when_asked(no_cuda, name):
    build, inputs = MODEL_BACKED_CPU[name]
    metric = build()
    metric.update(*inputs)
    value = metric.compute()
    leaves = value.values() if isinstance(value, dict) else value if isinstance(value, tuple) else [value]
    assert all(leaf.device == torch.device("cpu") and torch.isfinite(leaf).all() for leaf in leaves)
    for state in metric.metric_state.values():
        assert all(t.device == torch.device("cpu") for t in (state if isinstance(state, list) else [state]))


MODEL_BACKED_FUNCTIONS_CPU = {
    "learned_perceptual_image_patch_similarity": lambda: functional.learned_perceptual_image_patch_similarity(
        torch.rand(1, 3, 32, 32), torch.rand(1, 3, 32, 32), pretrained=False),
    "deep_image_structure_and_texture_similarity": lambda: functional.deep_image_structure_and_texture_similarity(
        torch.rand(1, 3, 32, 32), torch.rand(1, 3, 32, 32), pretrained=False),
    "arniqa": lambda: functional.arniqa(torch.rand(2, 3, 8, 8), scorer=lambda x: x.mean(dim=(1, 2, 3))),
    "perceptual_path_length": lambda: functional.perceptual_path_length(
        _LinearGenerator(), num_samples=4, batch_size=2, sim_net=_mean_gap, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(MODEL_BACKED_FUNCTIONS_CPU))
def test_model_backed_image_functions_run_on_the_cpu_when_asked(no_cuda, name):
    """CPU tensors, or ``device="cpu"`` for perceptual path length."""
    value = MODEL_BACKED_FUNCTIONS_CPU[name]()
    for leaf in value if isinstance(value, tuple) else [value]:
        assert leaf.device == torch.device("cpu") and torch.isfinite(leaf).all()


@pytest.mark.parametrize("name", ["LearnedPerceptualImagePatchSimilarity", "DeepImageStructureAndTextureSimilarity"])
def test_model_backed_networks_follow_the_metric_to_its_device(name):
    metric = MODEL_BACKED_CPU[name][0]()
    assert all(b.device == torch.device("cpu") for b in metric.net.buffers())
    assert metric.to("cpu") is metric and metric.device == torch.device("cpu")
