"""The port's segmentation metrics against the JAX package, on the CPU: Dice, generalized
Dice, mean IoU and the Hausdorff distance, functions and classes, in the ``one-hot``,
``index`` and ``mixed`` input formats.

The same numpy inputs, made from a seed, go through the JAX package and the port.
Tolerances:

- the statistics are counts of 0/1 products: the port counts in int64 and casts once,
  the JAX package sums in float32, exact below 2**24, so the counts, ``DiceScore``'s cat
  rows and the states' counts (``samples``, ``num_batches``, ``total``) equal bit for bit;
- Hausdorff distances equal bit for bit (the port gathers the edges and keeps the JAX
  package's float32 formulas as XLA rounds them);
- values within ``VALUE_ATOL`` (1e-6), and the float sums of ``MeanIoU``,
  ``GeneralizedDiceScore`` and ``HausdorffDistance`` within ``SUM_RTOL`` (1e-6
  relative): the JAX package adds ratios and distances in float32 in XLA's order, the
  port in float64 rounded once.

Hausdorff runs at 16 x 16 and 10 x 9 x 7 at most: the JAX package compares every pixel
with every pixel.
"""

from __future__ import annotations

import importlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sync import PortCoalescedWorld

from torchmetrics_tpu import functional as jax_fn
from torchmetrics_tpu import segmentation as jax_seg
from torchmetrics_tpu_torch import functional as port_fn
from torchmetrics_tpu_torch import segmentation as port_seg
from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError, TorchMetricsUserError

jax_utils = importlib.import_module("torchmetrics_tpu.functional.segmentation.utils")
port_utils = importlib.import_module("torchmetrics_tpu_torch.functional.segmentation.utils")

CPU = {"device": "cpu"}
VALUE_ATOL = 1e-6
SUM_RTOL = 1e-6
NB, N, C, H, W = 2, 4, 5, 16, 16  # the shapes of tests/test_segmentation.py, two updates


def _data(seed: int = 0) -> dict:
    """Inputs per format, ``(NB, N, ...)``: multi-hot one-hot pairs, index pairs with
    void labels (255 and -1) in the target, float logits with argmax ties beside index
    targets (mixed), and index pairs in which class 3 never appears."""
    rng = np.random.default_rng(seed)
    onehot_p = rng.integers(0, 2, size=(NB, N, C, H, W))
    onehot_t = rng.integers(0, 2, size=(NB, N, C, H, W))
    index_p = rng.integers(0, C, size=(NB, N, H, W))
    index_t = rng.integers(0, C, size=(NB, N, H, W))
    void = rng.random(index_t.shape)
    index_t[void < 0.08] = 255
    index_t[void > 0.95] = -1
    logits = np.round(rng.normal(size=(NB, N, C, H, W)), 0).astype(np.float32)  # many argmax ties
    absent_p, absent_t = index_p.copy(), index_t.copy()
    absent_p[absent_p == 3] = 0
    absent_t[absent_t == 3] = 1
    return {
        "one-hot": (onehot_p, onehot_t),
        "index": (index_p, index_t),
        "mixed": (logits, index_t),
        "logits": (logits, onehot_t),
        "absent": (absent_p, absent_t),
    }


DATA = _data()
FORMAT = {"one-hot": "one-hot", "index": "index", "mixed": "mixed", "logits": "one-hot", "absent": "index"}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    np.testing.assert_allclose(p.astype(np.float64), r.astype(np.float64), rtol=0, atol=VALUE_ATOL, err_msg=context)


def _bitwise(port, ref, context: str = "") -> None:
    p, r = _np(port), _np(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, f"{context}: {p.dtype}{p.shape} vs {r.dtype}{r.shape}"
    np.testing.assert_array_equal(p, r, err_msg=context)


def _batch(kind: str, b: int = 0):
    p, t = DATA[kind]
    return (jnp.asarray(p[b]), jnp.asarray(t[b])), (torch.from_numpy(p[b]), torch.from_numpy(t[b]))


KINDS = ["one-hot", "index", "mixed", "logits", "absent"]

# ---------------------------------------------------------------- formatting


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("include_background", [True, False])
def test_inputs_format_equals_the_jax_packages(kind, include_background):
    (jp, jt), (pp, pt) = _batch(kind)
    got = port_utils._segmentation_inputs_format(pp, pt, include_background, C, FORMAT[kind])
    want = jax_utils._segmentation_inputs_format(jp, jt, include_background, C, FORMAT[kind])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
        # the one-hots the format builds are int32; one-hot inputs keep their dtype
        assert g.dtype in (torch.int32, torch.int64)


@pytest.mark.parametrize("rank, connectivity", [(2, 1), (2, 2), (3, 1), (3, 3), (2, 0)])
@pytest.mark.parametrize("border_value", [0, 1])
def test_binary_erosion_equals_the_jax_packages(rank, connectivity, border_value):
    rng = np.random.default_rng(rank * 10 + connectivity)
    image = (rng.random((2, 2) + (7,) * rank) > 0.3).astype(np.int32)
    structure = jax_utils.generate_binary_structure(rank, connectivity)
    np.testing.assert_array_equal(port_utils.generate_binary_structure(rank, connectivity), structure)
    got = port_utils.binary_erosion(torch.from_numpy(image), structure, border_value)
    _bitwise(got, jax_utils.binary_erosion(jnp.asarray(image), structure, border_value))
    _bitwise(port_utils._mask_edges(torch.from_numpy(image)), jax_utils._mask_edges(jnp.asarray(image)))


# ---------------------------------------------------------------- functions


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("aggregation_level", ["samplewise", "global"])
@pytest.mark.parametrize("include_background", [True, False])
def test_dice_score_function(kind, aggregation_level, include_background):
    (jp, jt), (pp, pt) = _batch(kind)
    for average in ("micro", "macro", "weighted", "none"):
        kw = {"num_classes": C, "include_background": include_background, "average": average,
              "input_format": FORMAT[kind], "aggregation_level": aggregation_level}
        _close(port_fn.dice_score(pp, pt, **kw), jax_fn.dice_score(jp, jt, **kw), average)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("include_background", [True, False])
def test_dice_statistics_are_exact_counts(kind, include_background):
    from torchmetrics_tpu.functional.segmentation.dice import _dice_score_update as jax_update
    from torchmetrics_tpu_torch.functional.segmentation.dice import _dice_score_update as port_update

    (jp, jt), (pp, pt) = _batch(kind)
    for g, w in zip(port_update(pp, pt, C, include_background, FORMAT[kind]),
                    jax_update(jp, jt, C, include_background, FORMAT[kind])):
        _bitwise(g, w)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("weight_type", ["square", "simple", "linear"])
def test_generalized_dice_function(kind, weight_type):
    (jp, jt), (pp, pt) = _batch(kind)
    for per_class, include_background in itertools.product([False, True], [True, False]):
        kw = {"num_classes": C, "include_background": include_background, "per_class": per_class,
              "weight_type": weight_type, "input_format": FORMAT[kind]}
        _close(port_fn.generalized_dice_score(pp, pt, **kw), jax_fn.generalized_dice_score(jp, jt, **kw),
               f"per_class={per_class} background={include_background}")


@pytest.mark.parametrize("kind", KINDS)
def test_mean_iou_function(kind):
    (jp, jt), (pp, pt) = _batch(kind)
    for per_class, include_background in itertools.product([False, True], [True, False]):
        kw = {"num_classes": C, "include_background": include_background, "per_class": per_class,
              "input_format": FORMAT[kind]}
        _close(port_fn.mean_iou(pp, pt, **kw), jax_fn.mean_iou(jp, jt, **kw),
               f"per_class={per_class} background={include_background}")


def test_absent_class_scores_minus_one_per_class():
    (jp, jt), (pp, pt) = _batch("absent")
    got = port_fn.mean_iou(pp, pt, C, per_class=True, input_format="index")
    assert (got[:, 3] == -1.0).all()
    _close(got, jax_fn.mean_iou(jp, jt, C, per_class=True, input_format="index"))


def test_mean_iou_promotes_2d_index_inputs():
    p, t = DATA["index"]
    got = port_fn.mean_iou(torch.from_numpy(p[0, 0]), torch.from_numpy(t[0, 0]), C, input_format="index")
    _close(got, jax_fn.mean_iou(jnp.asarray(p[0, 0]), jnp.asarray(t[0, 0]), C, input_format="index"))


# the formats reach Hausdorff through the same formatting as the other metrics, tested above
HAUSDORFF_2D = {kind: (DATA[kind][0][0, :2], DATA[kind][1][0, :2]) for kind in ("one-hot", "absent")}
_rng3 = np.random.default_rng(3)
HAUSDORFF_3D = ((_rng3.random((2, 3, 10, 9, 7)) > 0.5).astype(np.int32), (_rng3.random((2, 3, 10, 9, 7)) > 0.6).astype(np.int32))


@pytest.mark.parametrize("kind", sorted(HAUSDORFF_2D))
@pytest.mark.parametrize("distance_metric", ["euclidean", "chessboard", "taxicab"])
def test_hausdorff_2d_bit_for_bit(kind, distance_metric):
    p, t = HAUSDORFF_2D[kind]
    for directed, spacing, background in ((False, None, False), (True, [0.7, 1.3], True)):
        kw = {"num_classes": C, "include_background": background, "distance_metric": distance_metric,
              "spacing": spacing, "directed": directed, "input_format": FORMAT[kind]}
        _bitwise(port_fn.hausdorff_distance(torch.from_numpy(p), torch.from_numpy(t), **kw),
                 jax_fn.hausdorff_distance(jnp.asarray(p), jnp.asarray(t), **kw), f"{kw}")


@pytest.mark.parametrize("distance_metric", ["euclidean", "chessboard", "taxicab"])
@pytest.mark.parametrize("spacing", [None, [1.0, 1.0, 1.0], [0.3, 1.7, 2.9]])
def test_hausdorff_3d_anisotropic_bit_for_bit(distance_metric, spacing):
    p, t = HAUSDORFF_3D
    for directed in (False, True):
        kw = {"num_classes": 3, "include_background": True, "distance_metric": distance_metric, "spacing": spacing,
              "directed": directed}
        _bitwise(port_fn.hausdorff_distance(torch.from_numpy(p), torch.from_numpy(t), **kw),
                 jax_fn.hausdorff_distance(jnp.asarray(p), jnp.asarray(t), **kw), f"directed={directed}")


def test_hausdorff_of_an_absent_class_is_zero_and_spacing_may_be_a_tensor():
    p, t = HAUSDORFF_2D["absent"]
    got = port_fn.hausdorff_distance(torch.from_numpy(p), torch.from_numpy(t), C, input_format="index",
                                     spacing=torch.tensor([2.0, 0.5]))
    assert (got[:, 2] == 0).all()  # class 3 with the background dropped
    _bitwise(got, jax_fn.hausdorff_distance(jnp.asarray(p), jnp.asarray(t), C, input_format="index",
                                            spacing=jnp.asarray([2.0, 0.5])))


def test_hausdorff_blocks_split_the_rows(monkeypatch):
    """Blocks of a few rows give the same distances as one block."""
    p, t = HAUSDORFF_3D
    whole = port_fn.hausdorff_distance(torch.from_numpy(p), torch.from_numpy(t), 3, include_background=True)
    monkeypatch.setattr(port_utils, "_BLOCK_BYTES", 8 * 40 * 3)
    _bitwise(port_fn.hausdorff_distance(torch.from_numpy(p), torch.from_numpy(t), 3, include_background=True), whole)


@pytest.mark.parametrize(
    "call",
    [
        lambda f, a: f.dice_score(a([[[0, 1]]]), a([[[0, 1]]]), num_classes=0),
        lambda f, a: f.dice_score(a([[[0, 1]]]), a([[[0, 1]]]), num_classes=2, average="bogus"),
        lambda f, a: f.dice_score(a([[[0, 1]]]), a([[[0, 1]]]), num_classes=2, input_format="bogus"),
        lambda f, a: f.dice_score(a([[[0, 1]]]), a([[[0, 1]]]), num_classes=2, aggregation_level="bogus"),
        lambda f, a: f.generalized_dice_score(a([[[0, 1]]]), a([[[0, 1]]]), num_classes=2, weight_type="bogus"),
        lambda f, a: f.mean_iou(a([[[0, 1]]]), a([[[0, 1]]]), input_format="index"),
        lambda f, a: f.hausdorff_distance(a([[[0, 1]]]), a([[[0, 1]]]), num_classes=2, distance_metric="bogus"),
        lambda f, a: f.hausdorff_distance(a([[[0, 1]]]), a([[[0, 1]]]), num_classes=2, spacing=3.0),
        lambda f, a: f.dice_score(a([0, 1]), a([0, 1]), num_classes=2, input_format="index"),
    ],
    ids=["num_classes", "average", "input_format", "aggregation_level", "weight_type", "miou_index",
         "distance_metric", "spacing", "rank"],
)
def test_function_errors_like_the_jax_package(call):
    with pytest.raises(ValueError) as jax_err:
        call(jax_fn, jnp.asarray)
    with pytest.raises(ValueError) as port_err:
        call(port_fn, torch.tensor)
    assert str(port_err.value) == str(jax_err.value)


def test_shape_errors_raise_in_both():
    for fmt, p, t in (("one-hot", (2, 3, 4, 4), (2, 3, 4, 5)), ("mixed", (2, 3, 4, 4), (2, 4, 5))):
        for f, make in ((jax_fn, jnp.zeros), (port_fn, lambda s: torch.zeros(s, dtype=torch.int32))):
            with pytest.raises(RuntimeError):
                f.dice_score(make(p), make(t), num_classes=3, input_format=fmt)


# ------------------------------------------------------------------ classes

CLASS_CASES = [
    *[(f"dice_{avg}_{level}", "DiceScore", {"num_classes": C, "average": avg, "aggregation_level": level})
      for avg in ("micro", "macro", "weighted", "none") for level in ("samplewise", "global")],
    ("dice_no_background", "DiceScore", {"num_classes": C, "include_background": False}),
    *[(f"gds_{wt}_{pc}", "GeneralizedDiceScore", {"num_classes": C, "weight_type": wt, "per_class": pc})
      for wt in ("square", "simple", "linear") for pc in (False, True)],
    ("gds_no_background", "GeneralizedDiceScore", {"num_classes": C, "include_background": False, "per_class": True}),
    ("miou", "MeanIoU", {"num_classes": C}),
    ("miou_per_class", "MeanIoU", {"num_classes": C, "per_class": True}),
    ("miou_no_background", "MeanIoU", {"num_classes": C, "include_background": False, "per_class": True}),
    ("hausdorff", "HausdorffDistance", {"num_classes": C}),
    ("hausdorff_directed_taxicab", "HausdorffDistance",
     {"num_classes": C, "directed": True, "distance_metric": "taxicab", "include_background": True}),
]
COUNT_STATES = {"samples", "num_batches", "total"}
FLOAT_SUMS = {"score"}  # MeanIoU's, GeneralizedDiceScore's and HausdorffDistance's


def _run_classes(cls: str, kw: dict, kind: str):
    jax_metric = getattr(jax_seg, cls)(**kw, input_format=FORMAT[kind])
    port_metric = getattr(port_seg, cls)(**kw, input_format=FORMAT[kind], **CPU)
    p, t = DATA[kind]
    batches = range(NB) if cls != "HausdorffDistance" else range(1)
    for b in batches:
        pb, tb = (p[b], t[b]) if cls != "HausdorffDistance" else (p[b, :2], t[b, :2])
        jax_metric.update(jnp.asarray(pb), jnp.asarray(tb))
        port_metric.update(torch.from_numpy(pb), torch.from_numpy(tb))
    return jax_metric, port_metric


def _hold_states(port_metric, jax_metric) -> None:
    for key, want in jax_metric._state.items():
        got = port_metric._state[key]
        if isinstance(want, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _bitwise(g, w, key)
        elif key in FLOAT_SUMS:
            np.testing.assert_allclose(_np(got), _np(want), rtol=SUM_RTOL, atol=0, err_msg=key)
        else:
            _bitwise(got, want, key)
        assert (got[0] if isinstance(got, list) else got).dtype == torch.float32


@pytest.mark.parametrize("kind", ["one-hot", "index", "mixed"])
@pytest.mark.parametrize("case, cls, kw", CLASS_CASES, ids=[c[0] for c in CLASS_CASES])
def test_classes_match_the_jax_package(case, cls, kw, kind):
    jax_metric, port_metric = _run_classes(cls, kw, kind)
    _hold_states(port_metric, jax_metric)
    _close(port_metric.compute(), jax_metric.compute(), case)


def test_void_labels_count_in_the_prediction_only():
    """A void target pixel predicted as class c adds to c's prediction sum and union, as
    the JAX package's one-hot of 255 (an all-zero row) gives."""
    p = torch.tensor([[[0, 1], [1, 1]]])
    t = torch.tensor([[[0, 255], [1, -1]]])
    got = port_fn.mean_iou(p, t, 2, per_class=True, input_format="index")
    want = jax_fn.mean_iou(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()), 2, per_class=True, input_format="index")
    _bitwise(got, want)
    assert got.tolist() == [[1.0, np.float32(1 / 3)]]


@pytest.mark.parametrize("kind", ["one-hot", "mixed", "mixed_target_hot"])
def test_mean_iou_infers_num_classes_lazily(kind):
    if kind == "mixed_target_hot":
        p, t = DATA["index"][0], DATA["one-hot"][1]
        fmt = "mixed"
    else:
        p, t = DATA[kind]
        fmt = FORMAT[kind]
    jax_metric, port_metric = jax_seg.MeanIoU(input_format=fmt, per_class=True), port_seg.MeanIoU(input_format=fmt,
                                                                                                  per_class=True, **CPU)
    with pytest.raises(TorchMetricsUserError):
        port_metric.update_state({}, torch.from_numpy(p[0]), torch.from_numpy(t[0]))
    assert port_metric.state_dict() == {} and not port_metric._defaults
    for b in range(NB):
        jax_metric.update(jnp.asarray(p[b]), jnp.asarray(t[b]))
        port_metric.update(torch.from_numpy(p[b]), torch.from_numpy(t[b]))
    assert port_metric.num_classes == jax_metric.num_classes == C
    _hold_states(port_metric, jax_metric)
    _close(port_metric.compute(), jax_metric.compute())
    # the lazily added states behave as any: pure update, clone, merge, reset, checkpoint
    state = port_metric.update_state(port_metric.init_state(), torch.from_numpy(p[0]), torch.from_numpy(t[0]))
    assert state["score"].shape == (C,)
    twin = port_metric.clone()
    twin.merge_state(port_metric)
    _close(twin._state["num_batches"], 2 * port_metric._state["num_batches"])
    port_metric.persistent(True)
    saved = port_metric.state_dict()
    port_metric.reset()
    assert float(port_metric._state["score"].sum()) == 0.0
    port_metric.load_state_dict(saved)
    _close(port_metric.compute(), jax_metric.compute())


def test_mean_iou_index_without_num_classes_raises_like_the_jax_package():
    with pytest.raises(ValueError) as jax_err:
        jax_seg.MeanIoU(input_format="index")
    with pytest.raises(ValueError) as port_err:
        port_seg.MeanIoU(input_format="index", **CPU)
    assert str(port_err.value) == str(jax_err.value)


def test_forward_gives_the_batch_value_and_accumulates():
    p, t = DATA["index"]
    port_metric = port_seg.GeneralizedDiceScore(C, input_format="index", **CPU)
    jax_metric = jax_seg.GeneralizedDiceScore(C, input_format="index")
    for b in range(NB):
        alone = port_seg.GeneralizedDiceScore(C, input_format="index", **CPU)
        alone.update(torch.from_numpy(p[b]), torch.from_numpy(t[b]))
        _bitwise(port_metric(torch.from_numpy(p[b]), torch.from_numpy(t[b])), alone.compute())
        jax_metric.update(jnp.asarray(p[b]), jnp.asarray(t[b]))
    _close(port_metric.compute(), jax_metric.compute())


def test_dice_cat_rows_through_the_coalesced_sync():
    p, t = DATA["one-hot"]
    ranks = []
    for b in range(NB):
        m = port_seg.DiceScore(C, average="none", **CPU)
        m.update(torch.from_numpy(p[b]), torch.from_numpy(t[b]))
        ranks.append(m)
    world = PortCoalescedWorld([m._state for m in ranks], ranks[0]._reductions)
    ranks[0].sync(dist_sync_fn=world, distributed_available=lambda: True)
    jax_metric = jax_seg.DiceScore(C, average="none")
    for b in range(NB):
        jax_metric.update(jnp.asarray(p[b]), jnp.asarray(t[b]))
    _close(ranks[0].compute(), jax_metric.compute())
    ranks[0].unsync()


STATE_CARRY = [
    ("DiceScore", {"num_classes": C, "average": "weighted"}, "one-hot"),
    ("MeanIoU", {"per_class": True}, "one-hot"),  # lazily sized on the JAX side
    ("HausdorffDistance", {"num_classes": C}, "index"),
]


@pytest.mark.parametrize("cls, kw, kind", STATE_CARRY, ids=[c[0] for c in STATE_CARRY])
def test_jax_state_dict_loads_into_the_port(cls, kw, kind):
    jax_metric, _ = _run_classes(cls, kw, kind)
    jax_metric.persistent(True)
    port_kw = {"num_classes": C, **kw}
    port_metric = getattr(port_seg, cls)(**port_kw, input_format=FORMAT[kind], **CPU)
    port_metric.load_state_dict(jax_metric.state_dict())
    _hold_states(port_metric, jax_metric)
    _close(port_metric.compute(), jax_metric.compute())
    truncated = {k: v for k, v in jax_metric.state_dict().items() if k != next(iter(jax_metric._state))}
    with pytest.raises(StateCorruptionError):
        getattr(port_seg, cls)(**port_kw, input_format=FORMAT[kind], **CPU).load_state_dict(truncated)


def test_state_dtypes_are_float32_before_any_update():
    for metric in (port_seg.GeneralizedDiceScore(C, **CPU), port_seg.MeanIoU(C, **CPU),
                   port_seg.HausdorffDistance(C, **CPU)):
        assert all(v.dtype == torch.float32 for v in metric._state.values())


def test_exports_equal_the_jax_packages():
    import torchmetrics_tpu as jtm
    import torchmetrics_tpu_torch as ttm

    assert sorted(port_seg.__all__) == sorted(jax_seg.__all__)
    assert sorted(port_fn.segmentation.__all__) == sorted(jax_fn.segmentation.__all__)
    for name in port_seg.__all__:
        assert getattr(ttm, name) is getattr(port_seg, name)
        assert name in jtm.__all__ and name in ttm.__all__
    for name in port_fn.segmentation.__all__:
        assert getattr(port_fn, name) is getattr(port_fn.segmentation, name)
