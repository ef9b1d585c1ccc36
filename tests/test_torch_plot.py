"""The port's ``plot`` (``Metric.plot``, ``MetricCollection.plot``, the curve and
confusion-matrix overrides, ``utilities/plot.py``) held against the JAX package's.

The same numpy-seeded batches go through both packages' metrics; each figure's lines
(``get_xydata``), bars, images, texts, tick labels, axis labels and title must agree:
strings equal, numbers within 1e-6 relative (torch and XLA may round a ratio's last bit
in another order). The class attributes ``plot`` reads must equal the JAX package's on
every exported class, and every class's ``plot`` must draw the same kind of figure.
"""

from __future__ import annotations

import importlib
import inspect

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

import torchmetrics_tpu as tm  # noqa: E402
import torchmetrics_tpu_torch as tt  # noqa: E402
from torchmetrics_tpu_torch.utilities import plot as port_plot  # noqa: E402

CPU = {"device": "cpu"}
N, C, L = 24, 5, 4


def _binary(rng):
    return rng.random(N, dtype=np.float32), rng.integers(0, 2, N).astype(np.int32)


def _multiclass(rng):
    return rng.normal(size=(N, C)).astype(np.float32), rng.integers(0, C, N).astype(np.int32)


def _multilabel(rng):
    return rng.random((N, L), dtype=np.float32), rng.integers(0, 2, (N, L)).astype(np.int32)


def _reg(rng):
    return rng.random(N, dtype=np.float32), rng.random(N, dtype=np.float32) + 0.1


def _image(rng):
    return rng.random((2, 3, 16, 16), dtype=np.float32), rng.random((2, 3, 16, 16), dtype=np.float32)


def _retrieval(rng):
    return rng.random(N, dtype=np.float32), rng.integers(0, 2, N).astype(np.int32), \
        np.sort(rng.integers(0, 4, N)).astype(np.int32)


def _labels_pair(rng):
    return rng.integers(0, 4, N).astype(np.int32), rng.integers(0, 4, N).astype(np.int32)


def _values(rng):
    return (rng.random(N, dtype=np.float32),)


# the 12 classes of tests/test_plot_smoke.py, then a ROC, a PR curve and a confusion
# matrix of each override, and a score built on a curve's states
CASES = {
    "BinaryAccuracy": (lambda lib, **kw: lib.BinaryAccuracy(**kw), _binary),
    "MulticlassAccuracy": (lambda lib, **kw: lib.MulticlassAccuracy(C, **kw), _multiclass),
    "MulticlassConfusionMatrix": (lambda lib, **kw: lib.MulticlassConfusionMatrix(C, **kw), _multiclass),
    "BinaryROC": (lambda lib, **kw: lib.BinaryROC(thresholds=16, **kw), _binary),
    "BinaryPrecisionRecallCurve": (lambda lib, **kw: lib.BinaryPrecisionRecallCurve(thresholds=16, **kw), _binary),
    "MulticlassStatScores": (lambda lib, **kw: lib.MulticlassStatScores(C, **kw), _multiclass),
    "MeanSquaredError": (lambda lib, **kw: lib.MeanSquaredError(**kw), _reg),
    "PeakSignalNoiseRatio": (lambda lib, **kw: lib.PeakSignalNoiseRatio(data_range=1.0, **kw), _image),
    "RetrievalMAP": (lambda lib, **kw: lib.RetrievalMAP(**kw), _retrieval),
    "MutualInfoScore": (lambda lib, **kw: lib.MutualInfoScore(**kw), _labels_pair),
    "CramersV": (lambda lib, **kw: lib.CramersV(num_classes=4, **kw), _labels_pair),
    "MeanMetric": (lambda lib, **kw: lib.MeanMetric(**kw), _values),
    "BinaryROC_exact": (lambda lib, **kw: lib.BinaryROC(**kw), _binary),
    "MulticlassROC": (lambda lib, **kw: lib.MulticlassROC(C, thresholds=16, **kw), _multiclass),
    "MultilabelPrecisionRecallCurve": (
        lambda lib, **kw: lib.MultilabelPrecisionRecallCurve(L, thresholds=8, **kw), _multilabel),
    "MultilabelConfusionMatrix": (lambda lib, **kw: lib.MultilabelConfusionMatrix(L, **kw), _multilabel),
    "BinaryAUROC": (lambda lib, **kw: lib.BinaryAUROC(thresholds=16, **kw), _binary),
    "MulticlassJaccardIndex": (lambda lib, **kw: lib.MulticlassJaccardIndex(C, average=None, **kw), _multiclass),
}


def _pair(name, seed=0, updates=2):
    """The port's and the JAX package's metric of ``name`` after the same updates."""
    make, gen = CASES[name]
    port, ref = make(tt, **CPU), make(tm)
    rng = np.random.default_rng(seed)
    for _ in range(updates):
        batch = gen(rng)
        port.update(*map(torch.from_numpy, batch))
        ref.update(*map(jnp.asarray, batch))
    return port, ref


def _numbers(values) -> np.ndarray:
    return np.asarray(values, dtype=np.float64)


def figure_summary(fig) -> dict:
    """What a reader sees of a figure: per axes, its lines, bars, images, texts, labels,
    ticks and title."""
    out = {}
    for i, ax in enumerate(fig.axes):
        out[f"{i}.title"] = ax.get_title()
        out[f"{i}.labels"] = (ax.get_xlabel(), ax.get_ylabel())
        out[f"{i}.texts"] = [t.get_text() for t in ax.texts]
        out[f"{i}.xticklabels"] = [t.get_text() for t in ax.get_xticklabels()]
        out[f"{i}.ylim"] = _numbers(ax.get_ylim())
        for j, line in enumerate(ax.get_lines()):
            out[f"{i}.line{j}"] = _numbers(line.get_xydata())
            out[f"{i}.line{j}.label"] = line.get_label()
        out[f"{i}.bars"] = _numbers([p.get_height() for p in ax.patches])
        for j, image in enumerate(ax.get_images()):
            out[f"{i}.image{j}"] = _numbers(image.get_array())
        legend = ax.get_legend()
        out[f"{i}.legend"] = [t.get_text() for t in legend.get_texts()] if legend is not None else []
    return out


def assert_same_figure(port_fig, ref_fig):
    got, want = figure_summary(port_fig), figure_summary(ref_fig)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].shape == value.shape, key
            np.testing.assert_allclose(got[key], value, rtol=1e-6, atol=1e-7, equal_nan=True, err_msg=key)
        else:
            assert got[key] == value, key
    plt.close(port_fig)
    plt.close(ref_fig)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plot_draws_the_jax_packages_figure(name):
    port, ref = _pair(name)
    port_fig, port_ax = port.plot()
    ref_fig, ref_ax = ref.plot()
    assert port_ax is port_fig.axes[0] and len(port_fig.axes) == len(ref_fig.axes)
    assert_same_figure(port_fig, ref_fig)


def test_plot_of_values_over_steps_and_into_a_given_axes():
    port_vals, ref_vals = [], []
    for seed in range(3):
        port, ref = _pair("MulticlassAccuracy", seed=seed, updates=1)
        port_vals.append(port.compute())
        ref_vals.append(ref.compute())
    assert_same_figure(port.plot(port_vals)[0], ref.plot(ref_vals)[0])
    fig, ax = plt.subplots()
    got_fig, got_ax = port.plot(port_vals[0], ax=ax)
    assert got_fig is fig and got_ax is ax
    plt.close(fig)


def test_curve_plot_with_a_score_title():
    port, ref = _pair("BinaryROC")
    port_auc, ref_auc = _pair("BinaryAUROC")
    port_fig, _ = port.plot(score=port_auc.compute())
    ref_fig, _ = ref.plot(score=ref_auc.compute())
    assert port_fig.axes[0].get_title().startswith("BinaryROC (score=")
    assert_same_figure(port_fig, ref_fig)


@pytest.mark.parametrize("together", [False, True])
def test_collection_plot_is_the_jax_packages(together):
    rng = np.random.default_rng(5)
    batch = _multiclass(rng)

    def members(lib, **kw):
        return {"acc": lib.MulticlassAccuracy(C, **kw), "f1": lib.MulticlassF1Score(C, average=None, **kw)}

    port = tt.MetricCollection(members(tt, **CPU), **CPU)
    ref = tm.MetricCollection(members(tm))
    port.update(*map(torch.from_numpy, batch))
    ref.update(*map(jnp.asarray, batch))
    port_figs, ref_figs = port.plot(together=together), ref.plot(together=together)
    assert len(port_figs) == len(ref_figs) == (1 if together else 2)
    for (port_fig, _), (ref_fig, _) in zip(port_figs, ref_figs):
        assert_same_figure(port_fig, ref_fig)


# ----------------------------------------------------------------------- values


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.int32])
def test_to_np_takes_low_precision_and_grad_tensors(dtype):
    value = torch.arange(6, dtype=torch.float32).reshape(2, 3).div(7).to(dtype)
    want = value.float().numpy() if dtype in (torch.bfloat16, torch.float16) else value.numpy()
    got = port_plot._to_np(value)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if value.is_floating_point():
        leaf = value.clone().requires_grad_(True)
        np.testing.assert_array_equal(port_plot._to_np({"k": leaf})["k"], want)
        np.testing.assert_array_equal(port_plot._to_np((leaf, 1.5))[0], want)


def test_to_np_takes_what_np_asarray_takes():
    for value in (0.25, [1, 2, 3], np.float32(2.0), np.arange(3)):
        np.testing.assert_array_equal(port_plot._to_np(value), np.asarray(value))


def test_without_matplotlib_plot_raises_the_jax_packages_text(monkeypatch):
    from torchmetrics_tpu.utilities import plot as jax_plot

    monkeypatch.setattr(port_plot, "_MATPLOTLIB_AVAILABLE", False)
    monkeypatch.setattr(jax_plot, "_MATPLOTLIB_AVAILABLE", False)
    port, ref = _pair("MulticlassConfusionMatrix")
    for metric in (port, ref):
        with pytest.raises(ModuleNotFoundError) as err:
            metric.plot()
        assert str(err.value) == jax_plot._error_msg == port_plot._error_msg


# ------------------------------------------------------------ class attributes

PLOT_ATTRS = ("higher_is_better", "plot_lower_bound", "plot_upper_bound", "plot_legend_name")
SUBPACKAGES = ("", ".aggregation", ".audio", ".classification", ".clustering", ".detection", ".image",
               ".multimodal", ".nominal", ".regression", ".retrieval", ".segmentation", ".shape", ".text",
               ".video", ".wrappers")


def _exported_classes():
    pairs = {}
    for sub in SUBPACKAGES:
        jax_mod = importlib.import_module("torchmetrics_tpu" + sub)
        port_mod = importlib.import_module("torchmetrics_tpu_torch" + sub)
        for name in getattr(jax_mod, "__all__", []):
            cls = getattr(jax_mod, name)
            if inspect.isclass(cls) and issubclass(cls, tm.Metric):
                pairs[f"torchmetrics_tpu{sub}.{name}"] = (getattr(port_mod, name), cls)
    return pairs


EXPORTED = _exported_classes()


def _plot_kind(cls, package) -> str:
    """Which figure ``cls.plot`` draws: the value's, a curve or a confusion matrix."""
    owner = next(c for c in cls.__mro__ if "plot" in c.__dict__)
    source = inspect.getsource(owner.__dict__["plot"])
    if "plot_curve" in source:
        return "curve"
    if "plot_confusion_matrix" in source:
        return "confusion_matrix"
    assert "plot_single_or_multi_val" in source or "Metric.plot" in source, (package, cls)
    return "value"


@pytest.mark.parametrize("name", sorted(EXPORTED))
def test_plot_attributes_and_kind_are_the_jax_packages(name):
    port_cls, jax_cls = EXPORTED[name]
    for attr in PLOT_ATTRS:
        got, want = getattr(port_cls, attr), getattr(jax_cls, attr)
        assert got == want and type(got) is type(want), attr
    assert _plot_kind(port_cls, "port") == _plot_kind(jax_cls, "jax")
