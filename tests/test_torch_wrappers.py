"""The port's wrappers against the JAX package's, on the CPU.

The same seeded numpy batches go through each JAX wrapper and its port (the wrapped
metrics on ``device="cpu"``). Tolerances:

- integer states (counts) bit for bit, BootStrapper's replicas included: both packages
  draw the resamples by the same calls on ``np.random.default_rng(seed)``;
- float states within ``STATE_RTOL`` relative (``STATE_ATOL`` near 0): the JAX package
  adds in float32 in XLA's order, the port in float64 rounded once;
- values within ``VALUE_ATOL`` (means, std and quantiles over replicas are float32 in
  both, reduced in other orders).

Also here: the ``_jittable_compute`` flag of every ported class and BootStrapper's path
choice against the JAX package's, checkpoints that cross over (a JAX wrapper's
``state_dict`` loads into the port's with equal keys and computes the same values),
the JAX package's ``TypeError`` when a wrapper over a ``MetricCollection`` saves a
checkpoint (kept in both), FeatureShare's single extractor call per update on numpy
input, and the wrappers' device rule.
"""

from __future__ import annotations

import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu import wrappers as jw
from torchmetrics_tpu_torch import wrappers as tw
from torchmetrics_tpu_torch.metric import Metric as PortMetric
from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError, TorchMetricsUserError

CPU = {"device": "cpu"}
STATE_RTOL, STATE_ATOL = 1e-6, 1e-6
VALUE_ATOL = 1e-6
N, C = 24, 4  # rows per batch, classes: one shape per metric, so JAX compiles each once
_rng = np.random.default_rng(2024)
LOGITS = [_rng.normal(size=(N, C)).astype(np.float32) for _ in range(4)]
LABELS = [_rng.integers(0, C, size=N) for _ in range(4)]
REG = [(_rng.normal(size=N).astype(np.float32), _rng.normal(size=N).astype(np.float32)) for _ in range(4)]


# ---------------------------------------------------------------- helpers

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, ctx="", bitwise=False, atol=VALUE_ATOL, rtol=0.0):
    """Same structure; leaves equal bit for bit or within the tolerance, NaN by place."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (ctx, list(got), list(want))
        for k in want:
            _close(got[k], want[k], f"{ctx}.{k}", bitwise, atol, rtol)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), ctx
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{ctx}[{i}]", bitwise, atol, rtol)
        return
    if want is None:
        assert got is None, ctx
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (ctx, g.shape, w.shape)
    if bitwise:
        np.testing.assert_array_equal(g, w, err_msg=ctx)
    else:
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=rtol, atol=atol, err_msg=ctx)


def _states_close(got: dict, want: dict, ctx=""):
    """Metric states: integer leaves bit for bit, float leaves within STATE_RTOL (keys in
    any order: JAX's vmap gives its dicts back with sorted keys)."""
    assert sorted(got) == sorted(want), (ctx, list(got), list(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert len(g) == len(w), (ctx, k)
            for i, (gi, wi) in enumerate(zip(g, w)):
                _states_close({k: gi}, {k: wi}, f"{ctx}[{i}]")
            continue
        w = np.asarray(w)
        exact = not np.issubdtype(w.dtype, np.floating)
        _close(g, w, f"{ctx}.{k}", bitwise=exact, atol=STATE_ATOL, rtol=STATE_RTOL)
        assert _np(g).dtype == w.dtype, (ctx, k, _np(g).dtype, w.dtype)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _both(build):
    """``build(lib, kw)`` for the JAX package and the port (``kw`` = device for the port)."""
    return build(J, {}), build(T, CPU)


def _jax_args(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _port_args(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


# ---------------------------------------------------------------- exports and flags

def test_exports_the_jax_packages_names():
    assert sorted(tw.__all__) == sorted(jw.__all__)
    for name in ("BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper",
                 "MultitaskWrapper", "Running"):
        assert getattr(T, name) is getattr(tw, name)
    assert {"PanopticQuality", "ModifiedPanopticQuality"} <= set(T.detection.__all__)
    assert {"panoptic_quality", "modified_panoptic_quality"} <= set(T.functional.detection.__all__)


def _toy_extractor(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :4]


def _identity(*args):
    return args[0]


FILL = {"num_classes": 3, "num_labels": 3, "min_recall": 0.5, "min_precision": 0.5, "min_specificity": 0.5,
        "min_sensitivity": 0.5, "num_groups": 2, "p": 2, "threshold": 0.5, "beta": 2.0, "feature": _toy_extractor,
        "things": {0, 1}, "stuffs": {2}, "data_range": 1.0, "metric_func": _identity, "fs": 16000,
        "personalized": False, "infer_fns": (_identity, _identity), "pretrained": False}
# classes that need a wheel, a checkpoint or a model file to build
NEEDS_FILES = {"PerceptualEvaluationSpeechQuality", "ShortTimeObjectiveIntelligibility",
               "NonIntrusiveSpeechQualityAssessment", "VideoMultiMethodAssessmentFusion"}
TASKS = {"binary": {}, "multiclass": {}, "multilabel": {}}


def _flag_cases():
    cases = []
    for modname in ("classification", "regression", "detection", "image", "aggregation", "retrieval", "segmentation",
                    "clustering", "nominal", "shape", "audio", "video"):
        module = getattr(T, modname)
        for name in module.__all__:
            cls = getattr(module, name)
            if not inspect.isclass(cls) or name == "BaseAggregator" or name in NEEDS_FILES:
                continue
            if not issubclass(cls, PortMetric) and "task" not in inspect.signature(cls.__new__).parameters:
                continue
            params = {**inspect.signature(cls.__init__).parameters, **inspect.signature(cls.__new__).parameters}
            tasks = list(TASKS) if "task" in params and params["task"].default is inspect.Parameter.empty else [None]
            for task in tasks:
                for thresholds in ([None, 5] if "thresholds" in params else [None]):
                    if task is not None and not _facade_takes(cls, task):
                        continue
                    cases.append((modname, name, task, thresholds))
    return cases


def _facade_takes(facade, task: str) -> bool:
    """Whether a task facade serves ``task`` (CohenKappa has no multilabel form, say)."""
    params = inspect.signature(facade.__new__).parameters
    try:
        _quiet(facade, task=task, **{k: v for k, v in FILL.items() if k in params}, **CPU)
    except ValueError:
        return False
    return True


FLAG_CASES = _flag_cases()


@pytest.mark.parametrize("modname, name, task, thresholds", FLAG_CASES,
                         ids=[f"{n}-{t}-{th}" for _, n, t, th in FLAG_CASES])
def test_jittable_compute_and_the_bootstrap_path_match_the_jax_package(modname, name, task, thresholds):
    """Every ported class (task facades per task, curve classes with and without
    thresholds): the flag, and BootStrapper's choice of the stacked or the list path
    under multinomial sampling, equal the JAX package's."""
    params = {**inspect.signature(getattr(getattr(T, modname), name).__init__).parameters,
              **inspect.signature(getattr(getattr(T, modname), name).__new__).parameters}
    kw = {k: v for k, v in FILL.items() if k in params}
    if task is not None:
        kw["task"] = task
    if thresholds is not None:
        kw["thresholds"] = thresholds
    jax_metric = _quiet(getattr(getattr(J, modname), name), **kw)
    port_metric = _quiet(getattr(getattr(T, modname), name), **kw, **CPU)
    assert type(port_metric).__name__ == type(jax_metric).__name__
    assert port_metric._jittable_compute is jax_metric._jittable_compute
    jax_boot = jw.BootStrapper(jax_metric, num_bootstraps=2, sampling_strategy="multinomial")
    port_boot = tw.BootStrapper(port_metric, num_bootstraps=2, sampling_strategy="multinomial")
    assert port_boot._use_stacked is jax_boot._use_vmap
    assert port_boot.device == torch.device("cpu")


# ---------------------------------------------------------------- BootStrapper

BOOT_KW = {"num_bootstraps": 5, "quantile": [0.1, 0.9], "raw": True, "seed": 3}


def _boot_pair(base, sampling, **kw):
    return _both(lambda lib, d: lib.wrappers.BootStrapper(base(lib, d), sampling_strategy=sampling,
                                                          **{**BOOT_KW, **kw}))


def _replica_states(boot, port: bool):
    if (boot._use_stacked if port else boot._use_vmap):
        return [dict(boot._stacked)]
    return [m._state for m in boot.metrics] + [{"count": np.asarray([m._update_count for m in boot.metrics])}]


BOOT_BASES = {
    "accuracy": (lambda lib, d: lib.classification.MulticlassAccuracy(C, average="micro", **d), "cls"),
    "confmat": (lambda lib, d: lib.classification.MulticlassConfusionMatrix(C, **d), "cls"),
    "mse": (lambda lib, d: lib.regression.MeanSquaredError(**d), "reg"),
    "pearson": (lambda lib, d: lib.regression.PearsonCorrCoef(**d), "reg"),
}


def _batch(kind: str, i: int):
    return (LOGITS[i], LABELS[i]) if kind == "cls" else REG[i]


@pytest.mark.parametrize("sampling", ["multinomial", "poisson"])
@pytest.mark.parametrize("base", sorted(BOOT_BASES))
def test_bootstrapper_replicas_and_values_match_the_jax_package(base, sampling):
    """Three updates and a forward (whose second draw estimates the batch alone): every
    replica's states after each step, and every output, as in the JAX package."""
    build, kind = BOOT_BASES[base]
    jax_boot, port_boot = _boot_pair(build, sampling)
    assert port_boot._use_stacked is jax_boot._use_vmap is (sampling == "multinomial")
    for i in range(4):
        if i == 2:
            want = _quiet(jax_boot.forward, *_jax_args(*_batch(kind, i)))
            got = _quiet(port_boot.forward, *_port_args(*_batch(kind, i)))
            _close(got, want, f"{base} forward")
        else:
            jax_boot.update(*_jax_args(*_batch(kind, i)))
            port_boot.update(*_batch(kind, i))  # numpy input, moved to the device once
        for r, (g, w) in enumerate(zip(_replica_states(port_boot, True), _replica_states(jax_boot, False))):
            _states_close(g, w, f"{base} step {i} replica {r}")
    _close(_quiet(port_boot.compute), _quiet(jax_boot.compute), f"{base} compute")
    port_boot.reset()
    jax_boot.reset()
    _states_close(_replica_states(port_boot, True)[0], _replica_states(jax_boot, False)[0], "reset")


@pytest.mark.parametrize("sampling", ["multinomial", "poisson"])
@pytest.mark.parametrize("base", ["accuracy", "pearson"])
def test_bootstrapper_merge_state_of_three_shards_matches_the_jax_package(base, sampling):
    """Shards fold replica by replica: a custom merge (Pearson's moments) through the
    base's ``_merge``, sum states by their tags."""
    build, kind = BOOT_BASES[base]
    results = []
    for lib, d, as_args in ((J, {}, _jax_args), (T, CPU, _port_args)):
        shards = [lib.wrappers.BootStrapper(build(lib, d), sampling_strategy=sampling, **{**BOOT_KW, "seed": s})
                  for s in range(3)]
        for s, shard in enumerate(shards):
            shard.update(*as_args(*_batch(kind, s)))
        for shard in shards[1:]:
            shards[0].merge_state(shard)
        assert shards[0]._update_count == 3
        results.append(shards[0])
    jax_boot, port_boot = results
    for r, (g, w) in enumerate(zip(_replica_states(port_boot, True), _replica_states(jax_boot, False))):
        _states_close(g, w, f"replica {r}")
    _close(_quiet(port_boot.compute), _quiet(jax_boot.compute), "compute")


@pytest.mark.parametrize("sampling", ["multinomial", "poisson"])
def test_bootstrapper_checkpoint_crosses_over(sampling):
    """The stacked path saves its replicas under ``_wrapper_extra.``, the list path its
    clones under ``_child{i}.``; a JAX checkpoint loads into the port and computes the
    same values, and the key sets are equal both ways."""
    build, kind = BOOT_BASES["accuracy"]
    jax_boot, port_boot = _boot_pair(build, sampling)
    for boot, as_args in ((jax_boot, _jax_args), (port_boot, _port_args)):
        boot.persistent(True)
        for i in range(2):
            boot.update(*as_args(*_batch(kind, i)))
    jax_sd, port_sd = jax_boot.state_dict(), port_boot.state_dict()
    assert set(jax_sd) == set(port_sd)
    assert any(k.startswith("_wrapper_extra." if sampling == "multinomial" else "_child4.") for k in jax_sd)
    restored = tw.BootStrapper(build(T, CPU), sampling_strategy=sampling, **BOOT_KW)
    restored.load_state_dict(jax_sd)
    assert restored._update_count == 2
    _close(_quiet(restored.compute), _quiet(jax_boot.compute), "restored")


def _detections(rng, n_imgs: int = 6, n_cls: int = 3):
    preds, target = [], []
    for _ in range(n_imgs):
        ng, nd = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        xy = rng.uniform(0, 50, size=(ng, 2))
        gt = np.concatenate([xy, xy + rng.uniform(5, 20, size=(ng, 2))], -1).astype(np.float32)
        boxes = np.concatenate([gt, gt + 2.0], 0)[:nd].astype(np.float32)
        labels = rng.integers(0, n_cls, size=ng)
        target.append({"boxes": gt, "labels": labels})
        preds.append({"boxes": boxes, "scores": rng.uniform(size=len(boxes)).astype(np.float32),
                      "labels": np.concatenate([labels, labels])[:len(boxes)]})
    return preds, target


def _as_lib(samples, asarray):
    return [{k: asarray(v) for k, v in s.items()} for s in samples]


def test_bootstrapper_resamples_whole_images_of_a_detection_list():
    """Sample lists resample whole elements (images), on the list path: each replica's
    list states hold the same images in both packages, and mAP agrees."""
    preds, target = _detections(np.random.default_rng(4))
    jax_boot, port_boot = _both(lambda lib, d: lib.wrappers.BootStrapper(
        lib.detection.MeanAveragePrecision(**d), num_bootstraps=3, seed=1))
    assert not port_boot._use_stacked and not jax_boot._use_vmap
    jax_boot.update(_as_lib(preds, jnp.asarray), _as_lib(target, jnp.asarray))
    port_boot.update(_as_lib(preds, torch.from_numpy), _as_lib(target, torch.from_numpy))
    for r, (g, w) in enumerate(zip(port_boot.metrics, jax_boot.metrics)):
        assert g._update_count == w._update_count
        for key in w._state:
            _close(torch.cat([torch.atleast_1d(t) for t in g._state[key]]) if g._state[key] else torch.zeros(0),
                   np.concatenate([np.atleast_1d(np.asarray(t)) for t in w._state[key]]) if w._state[key] else
                   np.zeros(0), f"replica {r} {key}", bitwise=True)
    got, want = _quiet(port_boot.compute), _quiet(jax_boot.compute)
    for stat in ("mean", "std"):
        _close(got[stat]["map"], want[stat]["map"], stat)


# ---------------------------------------------------------------- MinMax, Classwise

def test_minmax_tracks_the_jax_extrema_and_crosses_over():
    pairs = []
    for lib, d, as_args in ((J, {}, _jax_args), (T, CPU, _port_args)):
        metric = lib.wrappers.MinMaxMetric(lib.classification.MulticlassAccuracy(C, average="micro", **d))
        metric.persistent(True)
        outs = [metric.forward(*as_args(LOGITS[i], LABELS[i])) for i in range(3)]
        pairs.append((metric, outs, metric.compute()))
    (jax_m, jax_outs, jax_val), (port_m, port_outs, port_val) = pairs
    _close(port_outs, jax_outs, "forward", bitwise=True)
    _close(port_val, jax_val, "compute", bitwise=True)
    assert port_m.max_val.dtype == torch.float32 and port_m.max_val.device == torch.device("cpu")
    jax_sd, port_sd = jax_m.state_dict(), port_m.state_dict()
    assert set(jax_sd) == set(port_sd) and "_wrapper_extra.min_val" in jax_sd
    restored = tw.MinMaxMetric(T.classification.MulticlassAccuracy(C, average="micro", **CPU))
    restored.load_state_dict(jax_sd)
    _close(restored.compute(), jax_val, "restored", bitwise=True)
    shard = tw.MinMaxMetric(T.classification.MulticlassAccuracy(C, average="micro", **CPU))
    shard.update(*_port_args(LOGITS[3], LABELS[3]))
    shard.compute()
    port_m.merge_state(shard)
    assert float(port_m.min_val) == min(float(shard.min_val), float(jax_val["min"]))
    port_m.reset()
    assert float(port_m.max_val) == -np.inf and port_m._update_count == 0


def test_minmax_takes_a_python_float_value():
    """``torch.maximum`` refuses a Python float, which ``jnp.maximum`` takes."""
    class FloatValue(T.aggregation.SumMetric):
        def _compute(self, state):
            return float(super()._compute(state))

    metric = tw.MinMaxMetric(FloatValue(**CPU))
    metric.update(2.5)
    out = metric.compute()
    assert out["raw"] == 2.5 and float(out["max"]) == 2.5 and out["min"].dtype == torch.float32


def test_classwise_labels_prefixes_and_errors_match_the_jax_package():
    outs = []
    for lib, d, as_args in ((J, {}, _jax_args), (T, CPU, _port_args)):
        named = lib.wrappers.ClasswiseWrapper(lib.classification.MulticlassAccuracy(C, average=None, **d),
                                              labels=["a", "b", "c", "d"], postfix="_acc")
        plain = lib.wrappers.ClasswiseWrapper(lib.classification.MulticlassRecall(C, average=None, **d))
        batch_vals = [named.forward(*as_args(LOGITS[0], LABELS[0])), plain.forward(*as_args(LOGITS[0], LABELS[0]))]
        named.update(*as_args(LOGITS[1], LABELS[1]))
        wrong = lib.wrappers.ClasswiseWrapper(lib.classification.MulticlassAccuracy(C, average=None, **d),
                                              labels=["a"])
        wrong.update(*as_args(LOGITS[1], LABELS[1]))
        with pytest.raises(ValueError) as err:
            wrong.compute()
        named.persistent(True)
        outs.append((batch_vals, named.compute(), plain.compute(), str(err.value), named.state_dict()))
    _close(outs[1][:3], outs[0][:3], "classwise", bitwise=True)
    assert outs[1][3] == outs[0][3]
    assert set(outs[1][4]) == set(outs[0][4])
    restored = tw.ClasswiseWrapper(T.classification.MulticlassAccuracy(C, average=None, **CPU),
                                   labels=["a", "b", "c", "d"], postfix="_acc")
    restored.load_state_dict(outs[0][4])
    _close(restored.compute(), outs[0][1], "restored", bitwise=True)


def test_classwise_labels_sparse_detection_classes_by_class_id():
    """MeanAveragePrecision's per-class vectors follow its observed class ids
    (``classes``): labels are indexed by id, and ``classes`` passes through prefixed."""
    rng = np.random.default_rng(6)
    preds, target = _detections(rng, n_imgs=4, n_cls=3)
    for sample in preds + target:
        sample["labels"] = sample["labels"] * 2 + 1  # ids 1, 3, 5: sparse, and never 0
    results = []
    for lib, d, asarray in ((J, {}, jnp.asarray), (T, CPU, torch.from_numpy)):
        metric = lib.wrappers.ClasswiseWrapper(lib.detection.MeanAveragePrecision(class_metrics=True, **d),
                                               labels=[f"l{i}" for i in range(6)])
        metric.update(_as_lib(preds, asarray), _as_lib(target, asarray))
        results.append(_quiet(metric.compute))
    jax_out, port_out = results
    assert list(port_out) == list(jax_out)
    assert "meanaverageprecision_map_l1" in port_out and "meanaverageprecision_map_l0" not in port_out
    _close(port_out, jax_out, "classwise map")


# ---------------------------------------------------------------- Multioutput, Multitask

def _multioutput_data(seed: int, n_nan: int = 3):
    rng = np.random.default_rng(seed)
    preds, target = rng.normal(size=(N, 3)).astype(np.float32), rng.normal(size=(N, 3)).astype(np.float32)
    preds[rng.integers(0, N, n_nan), rng.integers(0, 3, n_nan)] = np.nan
    target[rng.integers(0, N, n_nan), rng.integers(0, 3, n_nan)] = np.nan
    return preds, target


@pytest.mark.parametrize("base", ["mse", "pearson"])
def test_multioutput_with_nan_rows_matches_the_jax_package(base):
    build = BOOT_BASES[base][0]
    results = []
    for lib, d, as_args in ((J, {}, _jax_args), (T, CPU, _port_args)):
        shards = [lib.wrappers.MultioutputWrapper(build(lib, d), num_outputs=3) for _ in range(2)]
        batch_val = shards[0].forward(*as_args(*_multioutput_data(0)))
        shards[0].update(*as_args(*_multioutput_data(1)))
        shards[1].update(*as_args(*_multioutput_data(2)))
        shards[0].merge_state(shards[1])
        shards[0].persistent(True)
        results.append((batch_val, shards[0]))
    (jax_batch, jax_m), (port_batch, port_m) = results
    _close(port_batch, jax_batch, "forward")
    for g, w in zip(port_m.metrics, jax_m.metrics):
        _states_close(g._state, w._state, "output")
    _close(port_m.compute(), jax_m.compute(), "compute")
    jax_sd = jax_m.state_dict()
    assert set(jax_sd) == set(port_m.state_dict())
    restored = tw.MultioutputWrapper(build(T, CPU), num_outputs=3)
    restored.load_state_dict(jax_sd)
    _close(restored.compute(), jax_m.compute(), "restored")
    port_m.reset()
    assert all(m._update_count == 0 for m in port_m.metrics)


def _tasks(lib, d):
    return {"cls": lib.classification.BinaryAccuracy(**d), "reg": lib.regression.MeanSquaredError(**d)}


def _task_batch(i: int, as_args):
    probs = 1 / (1 + np.exp(-LOGITS[i][:, 0]))
    preds = dict(zip(("cls", "reg"), as_args(probs, REG[i][0])))
    target = dict(zip(("cls", "reg"), as_args(LABELS[i] % 2, REG[i][1])))
    return preds, target


def test_multitask_matches_the_jax_package_and_checks_its_keys():
    results = []
    for lib, d, as_args in ((J, {}, _jax_args), (T, CPU, _port_args)):
        shards = [lib.wrappers.MultitaskWrapper(_tasks(lib, d), prefix="t_") for _ in range(3)]
        batch_val = shards[0].forward(*_task_batch(0, as_args))
        for s, shard in enumerate(shards):
            shard.update(*_task_batch(s + 1, as_args))
        for shard in shards[1:]:
            shards[0].merge_state(shard)
        with pytest.raises(ValueError) as keys_err:
            shards[0].update({"cls": as_args(REG[0][0])[0]}, {"cls": as_args(REG[0][0])[0]})
        other = lib.wrappers.MultitaskWrapper({"cls": lib.classification.BinaryAccuracy(**d)})
        with pytest.raises(ValueError) as merge_err:
            shards[0].merge_state(other)
        clone = shards[0].clone(prefix="c_")
        shards[0].persistent(True)
        results.append((batch_val, shards[0], clone, str(keys_err.value), str(merge_err.value)))
    (jax_b, jax_m, jax_c, jax_k, jax_e), (port_b, port_m, port_c, port_k, port_e) = results
    _close(port_b, jax_b, "forward")
    _close(port_m.compute(), jax_m.compute(), "compute")
    _close(port_c.compute(), jax_c.compute(), "clone")
    assert list(port_c.compute()) == ["c_cls", "c_reg"] and port_m._prefix == "t_"
    assert port_k == jax_k and port_e == jax_e
    assert list(port_m.keys()) == list(jax_m.keys()) and port_m["cls"] is port_m.task_metrics["cls"]
    jax_sd = jax_m.state_dict()
    assert set(jax_sd) == set(port_m.state_dict())
    restored = tw.MultitaskWrapper(_tasks(T, CPU), prefix="t_")
    restored.load_state_dict(jax_sd)
    _close(restored.compute(), jax_m.compute(), "restored")


def test_a_wrapper_over_a_collection_cannot_checkpoint_in_either_package():
    """``WrapperMetric.state_dict`` passes ``(destination, prefix)`` to each child, and a
    collection's ``state_dict`` takes no arguments: ``TypeError`` in both packages."""
    errors = []
    for lib, d in ((J, {}), (T, CPU)):
        coll_kw = {"device": "cpu"} if lib is T else {}
        coll = lib.MetricCollection({"acc": lib.classification.BinaryAccuracy(**d)}, **coll_kw)
        wrapper = lib.wrappers.MultitaskWrapper({"c": coll, "r": lib.regression.MeanSquaredError(**d)})
        wrapper.persistent(True)
        with pytest.raises(TypeError) as err:
            wrapper.state_dict()
        errors.append(type(err.value))
    assert errors == [TypeError, TypeError]


# ---------------------------------------------------------------- Running

@pytest.mark.parametrize("base", ["sum", "cat"])
def test_running_window_matches_the_jax_package_and_crosses_over(base):
    def build(lib, d):
        metric = lib.aggregation.SumMetric(**d) if base == "sum" else lib.aggregation.CatMetric(**d)
        return lib.wrappers.Running(metric, window=3)

    results = []
    for lib, d, as_args in ((J, {}, _jax_args), (T, CPU, _port_args)):
        metric = build(lib, d)
        metric.persistent(True)
        batch_vals = [metric.forward(*as_args(REG[0][0]))]
        for i in range(1, 4):
            metric.update(*as_args(REG[i][0][: 5 + i]))
        with pytest.raises(Exception) as err:
            metric.merge_state(build(lib, d))
        results.append((batch_vals, metric, err))
    (jax_b, jax_m, jax_err), (port_b, port_m, port_err) = results
    assert isinstance(port_err.value, TorchMetricsUserError) and str(port_err.value) == str(jax_err.value)
    _close(port_b, jax_b, "forward", atol=1e-5 if base == "sum" else 0.0)
    _close(port_m.compute(), jax_m.compute(), "compute", atol=1e-5 if base == "sum" else 0.0)
    jax_sd, port_sd = jax_m.state_dict(), port_m.state_dict()
    assert set(jax_sd) == set(port_sd)
    if base == "cat":
        assert jax_sd["_ring0.value._len"] == port_sd["_ring0.value._len"] == 1
    restored = build(T, CPU)
    restored.load_state_dict(jax_sd)
    assert restored._update_count == 4
    _close(restored.compute(), jax_m.compute(), "restored", atol=1e-5 if base == "sum" else 0.0)
    truncated = {k: v for k, v in jax_sd.items() if k != "_ring_len"}
    for lib, kw in ((J, {}), (T, CPU)):
        with pytest.raises(Exception) as err:
            build(lib, kw).load_state_dict(truncated)
        assert type(err.value).__name__ == "StateCorruptionError"
    lost = next(k for k in jax_sd if k.startswith("_ring1.") and not k.endswith("._len"))
    with pytest.raises(StateCorruptionError):
        build(T, CPU).load_state_dict({k: v for k, v in jax_sd.items() if k != lost})


# ---------------------------------------------------------------- Tracker, transforms

def test_tracker_best_metric_matches_the_jax_package():
    results = []
    for lib, d, as_args in ((J, {}, _jax_args), (T, CPU, _port_args)):
        single = lib.wrappers.MetricTracker(lib.classification.MulticlassAccuracy(C, **d))
        per_class = lib.wrappers.MetricTracker(lib.classification.MulticlassAccuracy(C, average=None, **d),
                                               maximize=True)
        coll_kw = {"device": "cpu"} if lib is T else {}
        coll = lib.wrappers.MetricTracker(lib.MetricCollection({
            "acc": lib.classification.MulticlassAccuracy(C, **d),
            "err": lib.classification.MulticlassHammingDistance(C, **d)}, **coll_kw))
        for epoch in range(3):
            for tracker in (single, per_class, coll):
                tracker.increment()
                tracker.update(*as_args(LOGITS[epoch], LABELS[(epoch * 2) % 4]))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:  # per-class values: numpy's flat argmax indexes the steps, as in JAX
                none_best = per_class.best_metric(return_step=True)
            except IndexError as err:
                none_best = ("IndexError", str(err))
        results.append((single.compute_all(), single.best_metric(return_step=True), coll.compute_all(),
                        coll.best_metric(return_step=True), none_best, len(caught) > 0, single.n_steps))
    jax_r, port_r = results
    _close(port_r[0], jax_r[0], "compute_all", bitwise=True)
    assert port_r[1] == jax_r[1] and port_r[3] == jax_r[3]
    _close(port_r[2], jax_r[2], "collection compute_all", bitwise=True)
    assert port_r[4] == jax_r[4] and port_r[5] == jax_r[5]
    assert port_r[6] == jax_r[6] == 3


def test_input_transformers_match_the_jax_package():
    results = []
    for lib, d, as_args in ((J, {}, _jax_args), (T, CPU, _port_args)):
        scores = 1 / (1 + np.exp(-LOGITS[0][:, 0]))
        target = REG[0][1]  # floats, binarised at 0.25
        binary = lib.wrappers.BinaryTargetTransformer(lib.classification.BinaryAccuracy(**d), threshold=0.25)
        flipped = lib.wrappers.LambdaInputTransformer(lib.classification.BinaryAccuracy(**d),
                                                      transform_pred=lambda p: 1 - p)
        transformed = binary.transform_target(as_args(target)[0])
        batch = binary.forward(*as_args(scores, target))
        binary.update(*as_args(scores[::-1].copy(), target))
        flipped.update(*as_args(scores, (target > 0.25).astype(np.int32)))
        results.append((transformed, batch, binary.compute(), flipped.compute()))
    _close(results[1], results[0], "transformers", bitwise=True)
    assert results[1][0].dtype == torch.int32


# ---------------------------------------------------------------- FeatureShare

class CountingExtractor:
    """A toy extractor counting its calls: the first 8 pixels of each image, as floats in
    [0, 1] (raw levels would put KID's cubic kernel where float32 cancels)."""

    def __init__(self, port: bool) -> None:
        self.calls, self.port = 0, port

    def __call__(self, imgs):
        self.calls += 1
        flat = imgs.reshape(imgs.shape[0], -1)[:, :8]
        return flat.float() / 255 if self.port else flat.astype(jnp.float32) / 255


def test_feature_share_calls_the_shared_extractor_once_per_update_on_numpy_input():
    """Every member of the port's FeatureShare sees the same tensor (the collection moves
    numpy input to the device once), so the id-keyed cache hits for all but the first:
    one extractor call per update, as in the JAX package; the values agree."""
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, size=(6, 3, 8, 8)).astype(np.uint8) for _ in range(4)]
    results = []
    for lib, d, port in ((J, {}, False), (T, CPU, True)):
        extractor = CountingExtractor(port)
        share = lib.wrappers.FeatureShare([
            lib.image.FrechetInceptionDistance(feature=extractor, **d),
            lib.image.KernelInceptionDistance(feature=extractor, subset_size=4, seed=0, **d),
        ])
        built = extractor.calls  # the members may probe the extractor's width when built
        for i, batch in enumerate(imgs):
            share.update(batch, real=i % 2 == 0)
            assert extractor.calls - built == i + 1
        results.append(_quiet(share.compute))
    _close(results[1], results[0], "feature share", atol=1e-5, rtol=1e-5)


def test_feature_share_members_on_two_devices_raise():
    extractor = CountingExtractor(True)
    fid = T.image.FrechetInceptionDistance(feature=extractor, **CPU)
    kid = T.image.KernelInceptionDistance(feature=extractor, subset_size=4, **CPU)
    kid.to("meta")
    with pytest.raises(ValueError, match="different devices"):
        tw.FeatureShare([fid, kid])


# ---------------------------------------------------------------- devices

def test_a_wrapper_runs_on_its_wrapped_metrics_device():
    boot = tw.BootStrapper(T.classification.MulticlassAccuracy(num_classes=3, **CPU))
    assert boot.device == torch.device("cpu")
    boot.update(torch.zeros(4, 3), torch.zeros(4, dtype=torch.long))
    assert all(m.device == torch.device("cpu") for m in boot.metrics)


def test_a_given_device_moves_the_children():
    base = T.classification.MulticlassAccuracy(num_classes=3, **CPU)
    minmax = tw.MinMaxMetric(base, device="meta")
    assert minmax.device.type == "meta" and base.device.type == "meta" and minmax.max_val.device.type == "meta"
    boot = tw.BootStrapper(T.classification.MulticlassAccuracy(3, **CPU), sampling_strategy="multinomial",
                           device="meta")
    assert boot.base_metric.device.type == "meta" and all(v.device.type == "meta" for v in boot._stacked.values())


def test_wrapped_metrics_on_two_devices_raise():
    a = T.classification.BinaryAccuracy(**CPU)
    b = T.regression.MeanSquaredError(**CPU).to("meta")
    with pytest.raises(ValueError, match="different devices"):
        tw.MultitaskWrapper({"a": a, "b": b})
