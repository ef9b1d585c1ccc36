"""The port's detection slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function or class and the
port's counterpart (``device="cpu"``):

- the box functions and the IoU family, functional and class: within 1e-6 (float32
  arithmetic on both sides; ``atan`` and the divisions may round differently);
- ``MeanAveragePrecision`` (the host evaluator): summary values equal, and
  ``extended_summary``'s precision/recall arrays equal exactly. Both run the same
  numpy in float64; the matcher's outputs are booleans;
- ``DeviceMeanAveragePrecision``: within 1e-4 of both JAX evaluators on the summary
  values, on ``tests/test_map_device.py``'s kind of data and at its bound. The device
  evaluators resolve IoU and recall thresholds in float32, where the host one compares
  in float64: a ratio that rounds onto a threshold in float32 resolves the other way,
  and on data with few ground truths per class that moves a value by more than 1e-4.
  There the port is held to the JAX device evaluator within 1e-6 (the same float32
  arithmetic, summed in another order).

The JAX device evaluator compiles one program per geometry, so its cases share one
geometry (capacity 2048, 6 classes) where they can.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import detection as jax_det
from torchmetrics_tpu.functional.detection import _box_ops as jax_box_ops
from torchmetrics_tpu.functional import detection as jax_fdet
from torchmetrics_tpu_torch import detection as port_det
from torchmetrics_tpu_torch.functional import detection as port_fdet
from torchmetrics_tpu_torch.functional.detection import _box_ops as port_box_ops
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

CPU = {"device": "cpu"}
IOU_ATOL = 1e-6
DEVICE_ATOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "_data", "coco_golden.json")


def _boxes(rng, n, lo=0.0, hi=120.0, min_wh=2.0, max_wh=60.0):
    xy = rng.uniform(lo, hi, size=(n, 2))
    wh = rng.uniform(min_wh, max_wh, size=(n, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def _dataset(rng, n_imgs=9, n_cls=6, max_det=12, max_gt=8, crowd_rate=0.0, area_rate=0.0, degenerate_rate=0.0,
             empty_rate=0.15, correlated=True):
    """One batch of COCO-shaped preds/targets. ``correlated``: half the detections are
    jittered copies of a ground truth with its label, so that matches happen."""
    preds, target = [], []
    for _ in range(n_imgs):
        nd = 0 if rng.random() < empty_rate else int(rng.integers(1, max_det + 1))
        ng = 0 if rng.random() < empty_rate else int(rng.integers(1, max_gt + 1))
        gt = _boxes(rng, ng)
        gt_labels = rng.integers(0, n_cls, ng).astype(np.int32)
        boxes, labels = _boxes(rng, nd), rng.integers(0, n_cls, nd).astype(np.int32)
        if correlated and ng and nd:
            copy = rng.random(nd) < 0.5
            src = rng.integers(0, ng, nd)
            boxes = np.where(copy[:, None], gt[src] + rng.uniform(-4, 4, (nd, 4)).astype(np.float32), boxes)
            labels = np.where(copy, gt_labels[src], labels).astype(np.int32)
        if degenerate_rate and nd:
            flip = rng.random(nd) < degenerate_rate  # zero/negative extent boxes
            boxes[flip] = boxes[flip][:, [2, 3, 0, 1]]
        preds.append({"boxes": boxes.astype(np.float32), "scores": rng.uniform(0, 1, nd).astype(np.float32),
                      "labels": labels})
        tgt = {"boxes": gt, "labels": gt_labels}
        if crowd_rate:
            tgt["iscrowd"] = (rng.random(ng) < crowd_rate).astype(np.int32)
        if area_rate:
            area = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])).astype(np.float32)
            use = rng.random(ng) < area_rate
            tgt["area"] = np.where(use, area * rng.uniform(0.2, 30.0, ng).astype(np.float32), 0.0).astype(np.float32)
        target.append(tgt)
    return preds, target


def _as_torch(items):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in items]


def _np(value):
    return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _assert_equal_results(got: dict, want: dict, atol: float = 0.0, keys=None) -> None:
    keys = set(want) if keys is None else keys
    for key in keys:
        if isinstance(want[key], dict):
            assert set(got[key]) == set(want[key]), key
            for cell in want[key]:
                np.testing.assert_allclose(_np(got[key][cell]), _np(want[key][cell]), atol=atol, err_msg=f"{key}{cell}")
            continue
        g, w = _np(got[key]), _np(want[key])
        assert g.shape == w.shape, key
        if atol == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=atol, err_msg=key)


# ------------------------------------------------------------------ box functions


MATRIX_FNS = ["box_iou_matrix", "generalized_box_iou_matrix", "distance_box_iou_matrix", "complete_box_iou_matrix"]


@pytest.mark.parametrize("name", MATRIX_FNS)
def test_box_matrices_match_jax(name):
    rng = np.random.default_rng(1)
    preds, target = _boxes(rng, 7), _boxes(rng, 5)
    preds[0] = preds[0][[2, 3, 0, 1]]  # a degenerate box
    batched = (_boxes(rng, 6).reshape(2, 3, 4), _boxes(rng, 8).reshape(2, 4, 4))  # leading batch axis
    for p, t in ((preds, target), batched):
        got = getattr(port_box_ops, name)(torch.from_numpy(p), torch.from_numpy(t))
        want = np.asarray(getattr(jax_box_ops, name)(jnp.asarray(p), jnp.asarray(t)))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=IOU_ATOL)


def test_box_convert_area_and_crowd_iou_match_jax():
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 6)
    for fmt in ("xyxy", "xywh", "cxcywh"):
        got = port_box_ops.box_convert(torch.from_numpy(boxes), fmt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_box_ops.box_convert(jnp.asarray(boxes), fmt)))
    with pytest.raises(ValueError, match="xyxy"):
        port_box_ops.box_convert(torch.from_numpy(boxes), "xyxy", "xywh")
    np.testing.assert_array_equal(port_box_ops.box_area(torch.from_numpy(boxes)).numpy(),
                                  np.asarray(jax_box_ops.box_area(jnp.asarray(boxes))))
    target, crowd = _boxes(rng, 4), np.array([True, False, True, False])
    got = port_box_ops.box_iou_matrix_crowd(torch.from_numpy(boxes), torch.from_numpy(target), torch.from_numpy(crowd))
    want = jax_box_ops.box_iou_matrix_crowd(jnp.asarray(boxes), jnp.asarray(target), jnp.asarray(crowd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=IOU_ATOL)


FUNCTIONAL = ["intersection_over_union", "generalized_intersection_over_union",
              "distance_intersection_over_union", "complete_intersection_over_union"]


@pytest.mark.parametrize("name", FUNCTIONAL)
@pytest.mark.parametrize("aggregate", [True, False])
@pytest.mark.parametrize("threshold", [None, 0.3])
def test_iou_functional_matches_jax(name, aggregate, threshold):
    rng = np.random.default_rng(3)
    preds, target = _boxes(rng, 5), _boxes(rng, 5)
    kwargs = {"aggregate": aggregate} if threshold is None else {
        "aggregate": aggregate, "iou_threshold": threshold, "replacement_val": -1}
    got = getattr(port_fdet, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    want = np.asarray(getattr(jax_fdet, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=IOU_ATOL)
    empty = torch.zeros((0, 4))
    assert tuple(getattr(port_fdet, name)(empty, torch.from_numpy(target), aggregate=False).shape) == (5, 5)
    with pytest.raises(ValueError, match="shape"):
        getattr(port_fdet, name)(torch.zeros((3, 5)), torch.from_numpy(target))


CLASSES = ["IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
           "CompleteIntersectionOverUnion"]


@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("respect_labels", [True, False])
@pytest.mark.parametrize("class_metrics", [True, False])
def test_iou_classes_match_jax(name, respect_labels, class_metrics):
    rng = np.random.default_rng(4)
    kwargs = {"respect_labels": respect_labels, "class_metrics": class_metrics, "iou_threshold": 0.2}
    ours, ref = getattr(port_det, name)(**kwargs, **CPU), getattr(jax_det, name)(**kwargs)
    for _ in range(3):
        preds, target = _dataset(rng, n_imgs=3, n_cls=3, max_det=6, max_gt=5, empty_rate=0.2)
        ours.update(_as_torch(preds), _as_torch(target))
        ref.update(preds, target)
    got, want = ours.compute(), ref.compute()
    assert set(got) == set(want)
    _assert_equal_results(got, want, atol=IOU_ATOL)
    value = ours(_as_torch(preds), _as_torch(target))  # forward: the batch alone
    fresh = getattr(jax_det, name)(**kwargs)
    fresh.update(preds, target)
    _assert_equal_results(value, fresh.compute(), atol=IOU_ATOL)


# ------------------------------------------------------------------ host mAP


def _host_pair(batches, **kwargs):
    ours, ref = port_det.MeanAveragePrecision(**kwargs, **CPU), jax_det.MeanAveragePrecision(**kwargs)
    for preds, target in batches:
        ours.update(_as_torch(preds), _as_torch(target))
        ref.update(preds, target)
    return ours.compute(), ref.compute()


HOST_CASES = {
    "fuzz": ({}, {}),
    "class_metrics": ({"class_metrics": True}, {}),
    "crowds_and_areas": ({"class_metrics": True}, {"crowd_rate": 0.3, "area_rate": 0.5}),
    "degenerate": ({}, {"degenerate_rate": 0.4}),
    "micro": ({"average": "micro", "class_metrics": True}, {}),
    "unsorted_thresholds": ({"iou_thresholds": [0.75, 0.5, 0.6, 1.0], "rec_thresholds": [0.5, 0.0, 1.0, 0.25],
                             "max_detection_thresholds": [20, 2, 5]}, {"max_det": 25}),
    "xywh": ({"box_format": "xywh"}, {}),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_map_equals_jax(case):
    kwargs, data = HOST_CASES[case]
    rng = np.random.default_rng(10 + list(HOST_CASES).index(case))
    got, want = _host_pair([_dataset(rng, **data) for _ in range(2)], **kwargs)
    assert set(got) == set(want)
    _assert_equal_results(got, want)
    assert float(got["map"]) > 0.0


def test_host_map_extended_summary_arrays_are_exact():
    rng = np.random.default_rng(20)
    got, want = _host_pair([_dataset(rng, crowd_rate=0.2, area_rate=0.3)], extended_summary=True)
    for key in ("precision", "recall", "scores"):
        assert got[key].dtype == torch.float32
    _assert_equal_results(got, want)  # ious per (image, class) cell included


def test_host_map_segm_and_both_iou_types():
    rng = np.random.default_rng(21)
    preds, target = _dataset(rng, n_imgs=6, n_cls=3, empty_rate=0.0)
    for items in (preds, target):
        for item in items:  # filled-box masks on a 48-px canvas (boxes / 3)
            yy, xx = np.mgrid[0:48, 0:48]
            item["masks"] = np.stack([(xx >= b[0] / 3) & (xx < b[2] / 3) & (yy >= b[1] / 3) & (yy < b[3] / 3)
                                      for b in item["boxes"]]).reshape(-1, 48, 48)
    for iou_type in ("segm", ("bbox", "segm")):
        got, want = _host_pair([(preds, target)], iou_type=iou_type, class_metrics=True)
        assert set(got) == set(want)
        _assert_equal_results(got, want)


def test_host_map_empty_sides_and_no_images():
    rng = np.random.default_rng(22)
    preds, target = _dataset(rng, n_imgs=4, empty_rate=0.0)
    no_dets = [{"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
                "labels": np.zeros(0, np.int32)} for _ in preds]
    no_gts = [{"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int32)} for _ in target]
    for batch in ((no_dets, target), (preds, no_gts)):
        got, want = _host_pair([batch], class_metrics=True)
        _assert_equal_results(got, want)
    empty = port_det.MeanAveragePrecision(**CPU)
    with pytest.warns(UserWarning, match="before the ``update``"):
        got = empty.compute()
    assert float(got["map"]) == -1.0 and got["classes"].numel() == 0


def test_host_map_lifecycle_forward_merge_and_coco_roundtrip(tmp_path):
    rng = np.random.default_rng(23)
    batches = [_dataset(rng) for _ in range(3)]
    single = port_det.MeanAveragePrecision(**CPU)
    shards = [port_det.MeanAveragePrecision(**CPU) for _ in batches]
    values = [shard(_as_torch(p), _as_torch(t)) for shard, (p, t) in zip(shards, batches)]
    for preds, target in batches:
        single.update(preds, target)
    jax_first = jax_det.MeanAveragePrecision()
    jax_first.update(*batches[0])
    _assert_equal_results(values[0], jax_first.compute())  # forward: the batch alone
    shards[0].merge_state(shards[1])
    shards[0].merge_state(shards[2])
    _assert_equal_results(shards[0].compute(), single.compute())
    base = str(tmp_path / "roundtrip")
    single.tm_to_coco(base)
    preds2, target2 = port_det.MeanAveragePrecision.coco_to_tm(f"{base}_preds.json", f"{base}_target.json")
    jax_preds, jax_target = jax_det.MeanAveragePrecision.coco_to_tm(f"{base}_preds.json", f"{base}_target.json")
    assert len(preds2) == len(jax_preds) and all(
        np.array_equal(a["boxes"].numpy(), np.asarray(b["boxes"])) for a, b in zip(preds2, jax_preds))
    again = port_det.MeanAveragePrecision(**CPU)
    again.update(preds2, target2)
    _assert_equal_results(again.compute(), single.compute(), atol=1e-5)


def test_host_map_functional_and_input_errors():
    rng = np.random.default_rng(24)
    preds, target = _dataset(rng)
    got = port_fdet.mean_average_precision(_as_torch(preds), _as_torch(target), class_metrics=True, **CPU)
    want = jax_fdet.mean_average_precision(preds, target, class_metrics=True)
    _assert_equal_results(got, want)
    m = port_det.MeanAveragePrecision(**CPU)
    with pytest.raises(ValueError, match="Expected argument `preds` and `target` to have the same length"):
        m.update([], [dict(boxes=np.zeros((0, 4)), labels=np.zeros(0))])
    with pytest.raises(ValueError, match="Expected all dicts in `preds`"):
        m.update([dict(boxes=np.zeros((0, 4)))], [dict(boxes=np.zeros((0, 4)), labels=np.zeros(0))])
    with pytest.raises(ValueError, match="different length"):
        m.update([dict(boxes=np.zeros((2, 4)), scores=np.zeros(1), labels=np.zeros(2))],
                 [dict(boxes=np.zeros((0, 4)), labels=np.zeros(0))])
    for bad, match in (({"average": "weird"}, "average"), ({"max_detection_thresholds": [10]}, "length 3"),
                       ({"iou_type": "keypoints"}, "iou_type"), ({"box_format": "yxyx"}, "box_format"),
                       ({"backend": "other"}, "backend"), ({"iou_thresholds": 0.5}, "iou_thresholds")):
        with pytest.raises(ValueError, match=match):
            port_det.MeanAveragePrecision(**bad, **CPU)


with open(GOLDEN) as _f:
    _GOLDEN = json.load(_f)


def _unpack(sample):
    out = {}
    for k, v in sample.items():
        if k == "masks":
            sent = v.index(-1)
            shape = tuple(v[sent + 1 :])
            bits = np.unpackbits(np.asarray(v[:sent], np.uint8), count=int(np.prod(shape)))
            out[k] = bits.reshape(shape).astype(bool)
        elif k in ("labels", "iscrowd"):
            out[k] = np.asarray(v, np.int32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("name", list(_GOLDEN))
def test_host_map_matches_the_cocoeval_golden_fixtures_and_jax(name):
    """``tests/test_coco_golden.py``'s fixtures: the golden COCOeval numbers within
    1e-6 (their bound: float32 boxes against the oracle's float64) and the JAX
    evaluator exactly."""
    fx = _GOLDEN[name]
    preds, target = [_unpack(p) for p in fx["preds"]], [_unpack(t) for t in fx["target"]]
    got, want = _host_pair([(preds, target)], iou_type=fx["iou_type"], class_metrics=True, **fx["opts"])
    _assert_equal_results(got, want)
    for key, golden in fx["stats"].items():
        if key == "classes":
            assert got["classes"].tolist() == golden
        else:
            np.testing.assert_allclose(_np(got[key]).astype(np.float64), np.asarray(golden), atol=1e-6, err_msg=key)


# ------------------------------------------------------------------ device mAP


def _device_triple(batches, host_kwargs=None, dev_kwargs=None, n_cls=6):
    """The port's device evaluator and both JAX evaluators on the same batches."""
    host = jax_det.MeanAveragePrecision(**(host_kwargs or {}))
    jax_dev = jax_det.MeanAveragePrecision(backend="device", num_classes=n_cls, capacity=2048, **(dev_kwargs or {}))
    ours = port_det.MeanAveragePrecision(backend="device", num_classes=n_cls, capacity=2048, **(dev_kwargs or {}),
                                         **CPU)
    assert isinstance(ours, port_det.DeviceMeanAveragePrecision)
    for preds, target in batches:
        host.update(preds, target)
        jax_dev.update(preds, target)
        ours.update(_as_torch(preds), _as_torch(target))
    return ours.compute(), host.compute(), jax_dev.compute(), ours


def _assert_device_parity(got, host, jax_dev, class_metrics=False, last=100):
    for key, val in host.items():
        arr = np.asarray(val)
        if arr.ndim == 0 and arr.dtype.kind == "f":
            for ref in (val, jax_dev[key]):
                assert abs(float(got[key]) - float(ref)) <= DEVICE_ATOL, (key, float(got[key]), float(ref))
    if class_metrics:
        for ref in (host, jax_dev):
            np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(ref["classes"]))
            for key in ("map_per_class", f"mar_{last}_per_class"):
                np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=DEVICE_ATOL, err_msg=key)


DEVICE_CASES = {  # tests/test_map_device.py's cases: independent random boxes and labels
    "fuzz0": ({}, {}),
    "fuzz1": ({}, {"empty_rate": 0.3}),
    "fuzz2": ({}, {"max_det": 20}),
    "crowds_and_areas0": ({}, {"crowd_rate": 0.3, "area_rate": 0.5}),
    "crowds_and_areas1": ({}, {"crowd_rate": 0.3, "area_rate": 0.5, "max_gt": 12}),
    "degenerate": ({}, {"degenerate_rate": 0.4}),
    "class_metrics": ({"class_metrics": True}, {}),
}


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_device_map_within_1e4_of_both_jax_evaluators(case):
    kwargs, data = DEVICE_CASES[case]
    rng = np.random.default_rng(30 + list(DEVICE_CASES).index(case))
    batches = [_dataset(rng, correlated=False, **data) for _ in range(2)]
    got, host, jax_dev, _ = _device_triple(batches, kwargs, kwargs)
    _assert_device_parity(got, host, jax_dev, class_metrics=bool(kwargs))
    assert got["map"].dtype == torch.float32 and got["classes"].dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1])
def test_device_map_follows_the_jax_device_evaluator_where_recall_rounds_onto_a_threshold(seed):
    """Half the detections copy a ground truth, so each class has a few non-ignored gts
    and recalls ``k / n`` such as 3/5 round in float32 onto a recall threshold (float32
    0.6 is above 0.6): the device evaluators, which compare in float32, pick the next
    precision there and may leave the host evaluator by more than 1e-4. The port keeps
    the JAX device evaluator's float32 semantics: within 1e-6 of it."""
    rng = np.random.default_rng(50 + seed)
    got, host, jax_dev, _ = _device_triple([_dataset(rng, crowd_rate=0.2, area_rate=0.3) for _ in range(2)],
                                           {"class_metrics": True}, {"class_metrics": True})
    for key, val in jax_dev.items():
        np.testing.assert_allclose(_np(got[key]), np.asarray(val), atol=1e-6, err_msg=key)
    assert float(got["map"]) > 0.0


def test_device_map_custom_maxdets_and_empty_sides():
    rng = np.random.default_rng(40)
    kw = {"max_detection_thresholds": [2, 5, 20]}
    got, host, jax_dev, _ = _device_triple([_dataset(rng, max_det=25, correlated=False)], kw, kw)
    _assert_device_parity(got, host, jax_dev, last=20)
    assert "mar_2" in got and "mar_20" in got
    preds, target = _dataset(rng, n_imgs=8, correlated=False)
    no_dets = [{"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
                "labels": np.zeros(0, np.int32)} for _ in preds]
    no_gts = [{"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int32)} for _ in target]
    for batch in ((no_dets, target), (preds, no_gts)):
        _assert_device_parity(*_device_triple([batch])[:3])


def test_device_map_sentinel_reset_and_reuse():
    dev = port_det.DeviceMeanAveragePrecision(**CPU)
    with pytest.warns(UserWarning, match="before the ``update``"):
        out = dev.compute()
    assert float(out["map"]) == -1.0 and float(out["mar_100"]) == -1.0 and out["classes"].numel() == 0
    rng = np.random.default_rng(41)
    _, _, _, dev = _device_triple([_dataset(rng, correlated=False)])
    dev.reset()
    assert dev._rows_used == {"det": 0, "gt": 0, "img": 0} and int(dev.det_n) == 0
    preds, target = _dataset(rng, correlated=False)
    host = jax_det.MeanAveragePrecision()
    host.update(preds, target)
    dev.update(_as_torch(preds), _as_torch(target))
    got = dev.compute()
    want = host.compute()
    assert all(abs(float(got[k]) - float(want[k])) <= DEVICE_ATOL for k in want if np.asarray(want[k]).ndim == 0)


def test_device_map_state_matches_jax_bit_for_bit():
    """The padded rows, cursors and re-based image ids equal the JAX evaluator's."""
    rng = np.random.default_rng(42)
    ours = port_det.DeviceMeanAveragePrecision(capacity=64, num_classes=6, **CPU)
    ref = jax_det.DeviceMeanAveragePrecision(capacity=64, num_classes=6)
    for _ in range(3):
        preds, target = _dataset(rng, n_imgs=2, max_det=4, max_gt=3)
        ours.update(_as_torch(preds), _as_torch(target))
        ref.update(preds, target)
    for key in ("det_rows", "gt_rows", "det_n", "gt_n", "img_n"):
        np.testing.assert_array_equal(getattr(ours, key).numpy(), np.asarray(getattr(ref, key)), err_msg=key)


def test_device_map_capacity_overflow_and_exact_fit():
    rng = np.random.default_rng(43)
    dev = port_det.DeviceMeanAveragePrecision(capacity=64, num_classes=6, **CPU)
    preds, target = _dataset(rng, n_imgs=4, empty_rate=0.0)
    dev.update(preds, target)
    before = {k: v.clone() for k, v in dev._state.items()}
    big_preds, big_target = _dataset(rng, n_imgs=40, empty_rate=0.0)
    with pytest.raises(TorchMetricsUserError, match="overflow"):
        dev.update(big_preds, big_target)
    assert all(torch.equal(dev._state[k], v) for k, v in before.items())  # raised before the append
    assert float(dev.compute()["map"]) >= -1.0
    one_det = [{"boxes": np.asarray([[0.0, 0.0, 10.0, 10.0]], np.float32),
                "scores": np.asarray([0.9], np.float32), "labels": np.asarray([0], np.int32)}]
    one_gt = [{"boxes": np.asarray([[0.0, 0.0, 10.0, 10.0]], np.float32), "labels": np.asarray([0], np.int32)}]
    fit = port_det.DeviceMeanAveragePrecision(capacity=2, num_classes=2, **CPU)
    fit.update(one_det, one_gt)
    fit.update(one_det, one_gt)  # det rows exactly at capacity: the spare row takes the padding
    assert int(fit.det_n) == 2 and fit.det_rows.shape == (2, 7) and float(fit.compute()["map"]) == 1.0
    with pytest.raises(TorchMetricsUserError, match="overflow"):
        fit.update(one_det, one_gt)


def test_device_map_validation():
    dev = port_det.DeviceMeanAveragePrecision(capacity=256, num_classes=3, gt_group_cap=2, **CPU)
    bad_label = [{"boxes": np.asarray([[0.0, 0.0, 5.0, 5.0]], np.float32),
                  "scores": np.asarray([0.5], np.float32), "labels": np.asarray([3], np.int32)}]
    empty_gt = [{"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int32)}]
    with pytest.raises(ValueError, match="num_classes"):
        dev.update(bad_label, empty_gt)
    empty_det = [{"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
                  "labels": np.zeros(0, np.int32)}]
    crowded = [{"boxes": np.tile(np.asarray([[0.0, 0.0, 5.0, 5.0]], np.float32), (3, 1)),
                "labels": np.zeros(3, np.int32)}]
    with pytest.raises(ValueError, match="gt_group_cap"):
        dev.update(empty_det, crowded)
    for bad, match in (({"iou_type": "segm"}, "iou_type"), ({"extended_summary": True}, "extended summary"),
                       ({"average": "micro"}, "average"), ({"capacity": 0}, "capacity"),
                       ({"backend": "pycocotools"}, "backend")):
        with pytest.raises(ValueError, match=match):
            port_det.DeviceMeanAveragePrecision(**bad, **CPU)
    host = port_det.MeanAveragePrecision(**CPU)
    assert not isinstance(host, port_det.DeviceMeanAveragePrecision)
