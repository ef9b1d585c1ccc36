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
from torchmetrics_tpu_torch import (classification, clustering, detection, functional, nominal, regression, retrieval,
                                    segmentation, shape, wrappers)
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
