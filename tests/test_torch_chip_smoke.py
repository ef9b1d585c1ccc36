"""``chip_smoke.py`` on the CPU: what it can check without a card.

The script drives the port on one GPU; here it must refuse to run (exit 2, no result
line), its list of the trunk's separable convs must be the port trunk's own, and its
report helpers must read ptxas's output and the bound as the kernels line states them.
"""

from __future__ import annotations

import collections
import math
import warnings
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_without_cuda_it_exits_2_and_prints_no_result(chip_smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 2
    assert '"ok"' not in capsys.readouterr().out


def test_trunk_shapes_are_the_port_trunks_separable_convs(chip_smoke):
    from torchmetrics_tpu_torch.image import InceptionV3Features

    trunk = InceptionV3Features(seed=0, device="cpu")
    convs = [(m.w.shape[1], m.w.shape[0], m.sep_axis) for m in trunk.modules() if getattr(m, "sep_axis", None)]
    assert len(convs) == chip_smoke.SEPCONV_PER_FORWARD == 26
    assert collections.Counter(convs) == collections.Counter(chip_smoke.trunk_sepconv_shapes())


PTXAS_LOG = """\
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized in '_ZN2tc20sepconv7_bf16_kernelE'
ptxas info    : Compiling entry function '_ZN2tc20sepconv7_bf16_kernelE' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc20sepconv7_bf16_kernelE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN2tc20sepconv7_tf32_kernelE' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc20sepconv7_tf32_kernelE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 152 registers, used 16 barriers
"""


def test_ptxas_report_keys_each_instantiation_by_its_dtype_path(chip_smoke):
    report = chip_smoke.ptxas_report(PTXAS_LOG)
    assert report["bf16 (wgmma)"] == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", "Used 168 registers, used 16 barriers"]
    assert report["f32 (wgmma, 3xTF32)"][1] == "Used 152 registers, used 16 barriers"
    assert len(report["warnings"]) == 1 and "C7520" in report["warnings"][0]


@pytest.mark.parametrize("dtype, peak", [(torch.bfloat16, 989e12), (torch.float32, 495e12 / 3)])
def test_sepconv_bound_is_the_operations_at_the_dtypes_peak(chip_smoke, dtype, peak):
    """bf16 at the tensor cores' bf16 peak; f32 as three TF32 products at the TF32 peak."""
    bound_ms, flops = chip_smoke.sepconv_bound_ms(512, 160, 160, dtype)
    assert flops == 2 * 512 * 17 * 17 * 160 * 160 * 7
    assert bound_ms == pytest.approx(1e3 * flops / peak)  # ~1,000 operations a byte: never bytes


@pytest.mark.parametrize("k", [2, 3])
def test_lower_index_topk_mask_is_the_jax_top_k(chip_smoke, k):
    """The topk_ties phase's independent rule (rank = values above + equal values before)
    gives the JAX package's ``select_topk`` and the port's on scores full of ties."""
    import jax.numpy as jnp
    import numpy as np

    from torchmetrics_tpu.utilities.data import select_topk as jax_select_topk
    from torchmetrics_tpu_torch.utilities.data import select_topk

    scores = (np.random.default_rng(k).integers(0, 5, (200, 5)) / 4).astype(np.float32)
    mask = chip_smoke.lower_index_topk_mask(torch.from_numpy(scores), k)
    assert mask.dtype == torch.int32 and int(mask.sum()) == 200 * k
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_select_topk(jnp.asarray(scores), k)))
    assert torch.equal(mask, select_topk(torch.from_numpy(scores), k))


def test_hold_against_cpu_takes_counts_exactly_and_ratios_within_1e6(chip_smoke):
    want = {"confmat": torch.tensor([[3.0, 1.0], [0.0, 4.0]]), "acc": torch.tensor(0.875), "tp": torch.tensor([2, 5], dtype=torch.int32)}
    assert chip_smoke.hold_against_cpu("same", dict(want), want) == 0.0
    assert chip_smoke.hold_against_cpu("ratio", {**want, "acc": torch.tensor(0.8750005)}, want) > 0.0
    for key, value in (("confmat", torch.tensor([[3.0, 1.0], [0.0, 4.0000005]])), ("acc", torch.tensor(0.876)),
                       ("tp", torch.tensor([2, 6], dtype=torch.int32)), ("tp", torch.tensor([2, 5], dtype=torch.int64))):
        with pytest.raises(AssertionError):
            chip_smoke.hold_against_cpu(key, {**want, key: value}, want)


def test_collective_counter_takes_the_process_groups_work_names_only(chip_smoke):
    """The sync_nccl profile counts c10d's work records (``nccl:``/``gloo:``), not the
    dispatcher ops, launches or device kernels of the same collectives."""
    names = ["nccl:all_gather", "cudaLaunchKernel", "c10d::allgather_", "nccl:all_gather", "record_param_comms",
             "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "gloo:all_reduce",
             "Memcpy DtoD (Device -> Device)", "nccl:all_gather"]
    ops = chip_smoke.count_collective_ops(names)
    assert ops == {"total": 4, "by_name": {"nccl:all_gather": 3, "gloo:all_reduce": 1}}
    assert chip_smoke.count_collective_ops(iter(["aten::add", "aten::cat"])) == {"total": 0, "by_name": {}}


def _sync_states():
    """The sync_nccl phase's members in small: int32 counts, float32 FID-like sums and an
    int32 count, a list state, the weighted mean's two sums and a max."""
    from torchmetrics_tpu_torch import CatMetric, MaxMetric, MeanMetric
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix

    members = [MulticlassAccuracy(5, average="micro", device="cpu"), MulticlassConfusionMatrix(5, device="cpu"),
               CatMetric(device="cpu"), MeanMetric(device="cpu"), MaxMetric(device="cpu")]
    members[0].update(torch.randn(16, 5), torch.randint(0, 5, (16,)))
    members[1].update(torch.randn(16, 5), torch.randint(0, 5, (16,)))
    for m in members[2:]:
        m.update(torch.randn(9))
    return [m._state for m in members], [m._reductions for m in members]


def test_expected_collectives_are_collective_counts_arithmetic(chip_smoke):
    from torchmetrics_tpu_torch.parallel import collective_counts

    states, reductions = _sync_states()
    expected = chip_smoke.expected_collectives(states, reductions)
    counts = collective_counts(states, reductions)
    dtypes = {v[0].dtype if isinstance(v, list) else v.dtype for s in states for v in s.values()}
    assert dtypes == {torch.int32, torch.float32}
    assert expected["sync_coalesced"] == counts["process_coalesced"] == 1 + len(dtypes)
    assert expected["sync_per_leaf"] == 2 * counts["leaves"] == 2 * expected["leaves"] == 2 * (4 + 1 + 1 + 2 + 1)
    # reduce_many: int32 sums, float32 sums, float32 max and float32 gathers for the cat leaf
    assert expected["reduce_coalesced"] == counts["in_graph_coalesced"] == 4
    assert expected["reduce_per_leaf"] == counts["in_graph_per_leaf"] == 9


def test_shipped_bytes_are_the_metadata_row_and_every_payload(chip_smoke):
    from torchmetrics_tpu_torch.parallel import coalesce

    states, reductions = _sync_states()
    meta = coalesce.build_local_metadata(states, reductions)
    assert meta.nbytes == 4 * (6 + 9 * 11 + 2 * 53 + 2 * 374)  # header, 9 leaf records, counter and histogram tails
    payload = 4 * (4 * 5 + 25 + 9 + 2 + 1)  # tp/fp/tn/fn per class, the 5x5 counts, 9 cat values, 2 sums, a max
    assert chip_smoke.shipped_bytes(states, reductions) == meta.nbytes + payload


def test_states_equal_is_bit_for_bit_and_reads_lists_by_their_concatenation(chip_smoke):
    a = {"x": torch.tensor([1.0, 2.0]), "c": [torch.tensor([1.0]), torch.tensor([2.0, 3.0])]}
    assert chip_smoke.states_equal({"x": torch.tensor([1.0, 2.0]), "c": [torch.tensor([1.0, 2.0, 3.0])]}, a)
    assert not chip_smoke.states_equal({**a, "x": torch.tensor([1.0, 2.0000002])}, a)
    assert not chip_smoke.states_equal({**a, "x": torch.tensor([1.0, 2.0], dtype=torch.float64)}, a)
    assert not chip_smoke.states_equal({"x": a["x"]}, a)


def test_two_rank_shares_cover_the_whole_batch_and_the_cat_shortfall(chip_smoke):
    world, n = 2, chip_smoke.TWO_RANK_CAT
    shares = [chip_smoke.rank_slices(n, r, world) for r in range(world)]
    assert [(s.start, s.stop) for s in shares] == [(0, n // 2), (n // 2, n)]
    cat = [chip_smoke.rank_slices(n, r, world, chip_smoke.CAT_SHORTFALL) for r in range(world)]
    assert [s.stop - s.start for s in cat] == [n // 2, n // 2 - 7]
    assert chip_smoke.rank_slices(n, 0, 1) == slice(0, n)


def test_total_order_table_is_ieee_total_order(chip_smoke):
    """The topk_ties phase's table of bit patterns runs from -NaN to +NaN in IEEE total
    order, and the port's select_topk ranks it so on the CPU, in float32 and bfloat16."""
    import numpy as np

    from torchmetrics_tpu_torch.utilities.data import select_topk

    bits = np.asarray(chip_smoke.TOTAL_ORDER_F32, np.int64).astype(np.int32)
    values = bits.view(np.float32)
    assert np.isnan(values[0]) and np.signbit(values[0]) and np.isnan(values[-1]) and not np.signbit(values[-1])
    assert np.signbit(values[3]) and values[3] == 0 and not np.signbit(values[4])
    assert list(values[1:3]) == [-np.inf, -1.0] and list(values[5:8]) == [0.5, 1.0, np.inf]
    place = torch.from_numpy(np.random.default_rng(0).integers(0, len(bits), (300, 5)))
    table = torch.from_numpy(bits.astype(np.int64))[place].to(torch.int32)
    for value in (table.view(torch.float32), (table >> 16).to(torch.int16).view(torch.bfloat16)):
        for k in (2, 3):
            assert torch.equal(select_topk(value, k), chip_smoke.lower_index_topk_mask(place.float(), k))


def test_coco_scale_dataset_has_the_stated_shape(chip_smoke):
    """100 detections and 1-14 ground truths per image, mean about 7.5 (val2017: 36,781
    over 5000 images), 80% ground-truth copies, about 1% crowds, hundredths for scores."""
    import numpy as np

    preds, target = chip_smoke.coco_scale_dataset(np.random.default_rng(6), 400)
    gts = np.asarray([t["labels"].size for t in target])
    assert all(p["labels"].size == chip_smoke.COCO_DETS for p in preds) and gts.min() >= 1 and gts.max() <= 14
    assert 7.0 <= gts.mean() <= 8.0
    crowd = np.concatenate([t["iscrowd"] for t in target]).mean()
    assert 0.002 <= crowd <= 0.03
    scores = np.concatenate([p["scores"] for p in preds])
    np.testing.assert_allclose(scores * 100, np.round(scores * 100), atol=1e-4)  # hundredths: ties are common
    labels = np.concatenate([p["labels"] for p in preds])
    assert labels.min() >= 0 and labels.max() < chip_smoke.COCO_CLASSES
    assert len(chip_smoke.batches_of(preds * 13, chip_smoke.IMAGES_PER_STEP)) == 163


def test_detection_state_sizes_are_the_stated_ones(chip_smoke):
    """The accumulator's state at COCO size is 26.0 MB, the device evaluator's 31.5 MB."""
    from torchmetrics_tpu_torch.detection import DeviceMeanAveragePrecision, PaddedDetectionAccumulator

    acc = PaddedDetectionAccumulator(chip_smoke.COCO_IMAGES, chip_smoke.COCO_DETS, chip_smoke.COCO_MAX_GT, device="cpu")
    assert round(chip_smoke.state_bytes(acc.init()) / 1e6, 1) == 26.0
    dev = DeviceMeanAveragePrecision(capacity=chip_smoke.DEVICE_MAP_CAPACITY, num_classes=chip_smoke.COCO_CLASSES,
                                     gt_group_cap=chip_smoke.GT_GROUP_CAP, device="cpu")
    assert round(chip_smoke.state_bytes(dev._state) / 1e6, 1) == 31.5
    assert chip_smoke.COCO_IMAGES * chip_smoke.COCO_DETS <= chip_smoke.DEVICE_MAP_CAPACITY


def test_lists_equal_is_bit_for_bit_by_key(chip_smoke):
    import numpy as np

    a = [{"boxes": np.zeros((1, 4), np.float32), "labels": np.asarray([1], np.int32)}]
    assert chip_smoke.lists_equal(a, [{"boxes": np.zeros((1, 4)), "labels": np.asarray([1])}])
    assert not chip_smoke.lists_equal(a, [{"boxes": np.ones((1, 4)), "labels": np.asarray([1])}])
    assert not chip_smoke.lists_equal(a, a + a)


def test_flagship_rehearsal_and_its_collective_prediction(chip_smoke):
    """The flagship phase on the CPU at a small size, without a group: every value
    finite, and the sync's predicted collectives: one int32 sum bucket for the
    classification counts, the accumulator's float32 and int32 gathers, FID's float32
    and int32 sums."""
    import numpy as np

    from torchmetrics_tpu_torch.detection import pack_detection_batch

    preds, target = chip_smoke.coco_scale_dataset(np.random.default_rng(1), 40, n_det=20)

    def extractor(imgs):
        return imgs.reshape(imgs.shape[0], -1)[:, :16].float()

    extractor.num_features = 16
    flagship = chip_smoke.Flagship(extractor, 40, 20, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    states = flagship.init()
    for p, t in zip(chip_smoke.batches_of(preds, 8), chip_smoke.batches_of(target, 8)):
        states = flagship.update(states, torch.randn((64, 5), generator=gen), torch.randint(0, 5, (64,), generator=gen),
                                 pack_detection_batch(p, t, 20, 16, device="cpu"),
                                 torch.rand((8, 3, 4, 4), generator=gen), torch.rand((8, 3, 4, 4), generator=gen) ** 2)
    assert flagship.expected_collectives(states) == 5
    values = flagship.finalize(flagship.sync(states))
    assert set(values) == {"acc", "f1", "map", "fid"} and all(np.isfinite(float(v)) for v in values.values())
    assert 0.0 < float(values["map"]) < 1.0


def test_fid_state_diff_takes_counts_exactly_and_sums_within_the_trunk_bound(chip_smoke):
    def extractor(imgs):
        return imgs.reshape(imgs.shape[0], -1)[:, :16].float()

    extractor.num_features = 16
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    fid = FrechetInceptionDistance(feature=extractor, normalize=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    real, fake = torch.rand((8, 3, 4, 4), generator=gen), torch.rand((8, 3, 4, 4), generator=gen)
    want = fid.update_state(fid.update_state(fid.init_state(), real, True), fake, False)
    diffs = chip_smoke.fid_state_diff("same", dict(want), want)
    assert set(diffs) == {k for k in want if not k.endswith("num_samples")} and max(diffs.values()) == 0.0
    off = {**want, "fake_features_sum": want["fake_features_sum"] * (1 + 2 * chip_smoke.TRUNK_BF16_L2)}
    with pytest.raises(AssertionError, match="fake_features_sum"):
        chip_smoke.fid_state_diff("off", off, want)
    with pytest.raises(AssertionError, match="real_features_num_samples"):
        chip_smoke.fid_state_diff("count", {**want, "real_features_num_samples": torch.tensor(9, dtype=torch.int32)},
                                  want)


def test_kid_bound_is_the_fp64_products_at_published_settings(chip_smoke):
    """100 subsets x three 1000x2048x1000 products: 1.23 TFLOP, about 18 ms at 67 TFLOP/s."""
    bound = chip_smoke.kid_bound_ms(100, 1000, 2048, 2048, 2048)
    assert bound["flops"] == 100 * 3 * 2 * 1000 * 2048 * 1000 and bound["bound_by"] == "operations"
    assert bound["bound_ms"] == pytest.approx(1e3 * 1.2288e12 / 67e12)
    tiny = chip_smoke.kid_bound_ms(1, 2, 2048, 10**6, 10**6)  # few products over a large state: bytes
    assert tiny["bound_by"] == "bytes" and tiny["bound_ms"] == pytest.approx(1e3 * (2 * 10**6 * 2048 * 4 + 8) / 3.35e12)


def _groups_rehearsal(chip_smoke):
    gen = torch.Generator().manual_seed(0)
    coll = chip_smoke.groups_collection(True, "cpu")
    for _ in range(2):
        coll.update(torch.randn((64, 5), generator=gen), torch.randint(0, 5, (64,), generator=gen))
    return coll


def test_collection_groups_rehearsal_forms_the_stated_groups(chip_smoke):
    coll = _groups_rehearsal(chip_smoke)
    assert chip_smoke.group_sets(coll) == chip_smoke.EXPECTED_GROUPS
    assert chip_smoke.members_alias(coll)
    plain = chip_smoke.groups_collection(False, "cpu")
    plain.update(torch.zeros((4, 5)), torch.zeros(4, dtype=torch.long))
    assert chip_smoke.group_sets(plain) == []
    clone = coll.clone()
    clone["f1"]._state = dict(clone["f1"]._state)
    assert not chip_smoke.members_alias(clone)


def test_sync_prediction_comes_from_the_distinct_state_dicts(chip_smoke):
    """The grouped collection holds two dicts (tp/fp/tn/fn and the confusion matrix), the
    ungrouped one five; both ship one metadata gather and one int32 bucket, and the
    grouped one 3 x 4 x 5 int32 counts fewer."""
    grouped = _groups_rehearsal(chip_smoke)
    plain = chip_smoke.groups_collection(False, "cpu")
    plain.update(torch.zeros((4, 5)), torch.zeros(4, dtype=torch.long))
    g_states, g_reds = chip_smoke.distinct_states(grouped)
    p_states, p_reds = chip_smoke.distinct_states(plain)
    assert len(g_states) == 2 and len(p_states) == 5
    assert chip_smoke.expected_collectives(g_states, g_reds)["sync_coalesced"] == 2
    assert chip_smoke.expected_collectives(p_states, p_reds)["sync_coalesced"] == 2
    assert chip_smoke.expected_collectives(g_states, g_reds)["leaves"] == 5
    payload = chip_smoke.shipped_bytes(p_states, p_reds) - chip_smoke.shipped_bytes(g_states, g_reds)
    assert payload >= 3 * 4 * 5 * 4


def test_generative_cpu_twin_and_float64_values(chip_smoke):
    """The CPU reference holds the card metric's states on a metric whose extractor is
    never called, and its float64 values round to ``compute()``'s float32 ones."""
    from torchmetrics_tpu_torch.image import InceptionScore, KernelInceptionDistance, \
        MemorizationInformedFrechetInceptionDistance

    def extractor(imgs):
        return imgs.reshape(imgs.shape[0], -1)[:, :8].float()

    gen = torch.Generator().manual_seed(1)
    imgs = torch.rand((24, 3, 4, 4), generator=gen)
    built = {
        "kid": lambda f: KernelInceptionDistance(feature=f, subsets=3, subset_size=10, seed=0, device="cpu"),
        "mifid": lambda f: MemorizationInformedFrechetInceptionDistance(feature=f, device="cpu"),
        "is": lambda f: InceptionScore(feature=f, splits=3, seed=0, device="cpu"),
    }
    for name, build in built.items():
        metric = build(extractor)
        if name == "is":
            metric.update(imgs)
        else:
            metric.update(imgs, real=True)
            metric.update(imgs ** 2, real=False)
        twin = chip_smoke.cpu_twin(metric, lambda: build(chip_smoke.Width(8)))
        value = metric.compute()
        value = list(value) if isinstance(value, tuple) else [value]
        f64 = chip_smoke.float64_values(twin, twin._concat_state())
        assert [float(torch.tensor(v, dtype=torch.float32)) for v in f64] == [float(v) for v in value]
    with pytest.raises(AssertionError, match="extracts nothing"):
        chip_smoke.Width(8)(imgs)
    assert chip_smoke.relative_diff(1.0, 1.0) == 0.0 and chip_smoke.relative_diff(0.5, 0.0) == 0.5


def test_logits_head_gives_the_class_count(chip_smoke):
    head = chip_smoke.LogitsHead(lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :6],
                                 torch.ones((6, chip_smoke.IS_CLASSES)))
    assert head.num_features == 1008 and head(torch.ones((2, 3, 2, 2))).shape == (2, 1008)


def test_he_scaled_params_scale_every_conv_weight_by_sqrt2(chip_smoke):
    import math

    import numpy as np

    from torchmetrics_tpu_torch.image import InceptionV3Features

    params = InceptionV3Features._random_params(0)
    scaled = chip_smoke.he_scaled(params)
    stem = scaled["stem1"]
    np.testing.assert_allclose(stem["w"], params["stem1"]["w"] * math.sqrt(2.0), rtol=1e-6)
    assert stem["w"].dtype == np.float32 and np.array_equal(stem["var"], params["stem1"]["var"])
    assert np.array_equal(scaled["mixed_e2"]["pool"]["w"], params["mixed_e2"]["pool"]["w"] * np.float32(math.sqrt(2.0)))


def test_classification_tower_rehearsal_holds_the_cpu_port(chip_smoke):
    """The tower's data makers and checker at a small size: two runs on the same inputs
    agree bit for bit, and a changed count or value is caught."""
    gen = torch.Generator().manual_seed(0)
    inputs = chip_smoke.tower_inputs(gen, batch=256, labels=6, multidim=(32, 4), device="cpu")
    assert inputs["multiclass"][0].shape == (256, 5) and inputs["multilabel"][0].shape == (256, 6)
    assert float((inputs["multidim"][0] == inputs["multidim"][1]).float().mean()) > 0.8
    first = chip_smoke.run_tower(chip_smoke.tower_metrics("cpu", labels=6), inputs)
    second = chip_smoke.run_tower(chip_smoke.tower_metrics("cpu", labels=6), inputs)
    assert chip_smoke.hold_tower(second, first, bitwise=True) == 0.0
    assert set(first) == {"jaccard_macro", "mcc", "kappa_quadratic", "exact_match_multidim", "jaccard_multilabel",
                          "mcc_multilabel", "exact_match_multilabel"}
    states, value = second["mcc"]
    second["mcc"] = ({"confmat": states["confmat"] + torch.eye(5, dtype=torch.int32)}, value)
    with pytest.raises(AssertionError, match="states differ"):
        chip_smoke.hold_tower(second, first)
    second["mcc"] = (states, value + 1e-5)
    with pytest.raises(AssertionError, match="values differ"):
        chip_smoke.hold_tower(second, first)


def test_curve_data_makers_have_the_stated_shape(chip_smoke):
    gen = torch.Generator().manual_seed(1)
    preds, target = chip_smoke.ctr_scores(gen, n=20000, device="cpu")
    assert 0.02 < float(target.float().mean()) < 0.04
    assert torch.equal(preds, torch.round(preds * 1000) / 1000) and torch.unique(preds).numel() <= 1001
    probs, labels = chip_smoke.imagenet_scores(gen, rows=64, classes=10, device="cpu")
    assert probs.shape == (64, 10) and torch.allclose(probs.sum(1), torch.ones(64))
    assert float((probs.argmax(1) == labels).float().mean()) > 0.5
    assert chip_smoke.curve_sources(["auroc_exact", "ap_exact", "auroc_binned", "roc_macro_binned", "auroc_max_fpr"]) \
        == {"auroc_exact": "auroc_exact", "ap_exact": "auroc_exact", "auroc_binned": "auroc_binned",
            "roc_macro_binned": "auroc_binned", "auroc_max_fpr": "auroc_exact"}


@pytest.mark.parametrize("workload", ["ctr", "imagenet"])
def test_curve_reference_rehearsal(chip_smoke, workload):
    """Both workloads at a small size on the CPU: the metrics of one state family share
    the leader's states, and the reference's values are the metrics' own."""
    gen = torch.Generator().manual_seed(2)
    if workload == "ctr":
        preds, target = chip_smoke.ctr_scores(gen, n=4096, device="cpu")
        build = lambda device: chip_smoke.ctr_metrics(device, thresholds=11)  # noqa: E731
    else:
        preds, target = chip_smoke.imagenet_scores(gen, rows=200, classes=7, device="cpu")
        build = lambda device: chip_smoke.imagenet_metrics(device, classes=7, thresholds=9)  # noqa: E731
    batches = list(zip(preds.chunk(4), target.chunk(4)))
    metrics = build("cpu")
    for metric in metrics.values():
        for batch in batches:
            metric.update(*batch)
    values = chip_smoke.cpu_reference(metrics, build("cpu"), batches, chip_smoke.curve_sources(metrics))
    for name, metric in metrics.items():
        assert chip_smoke.compare_curves(name, metric.compute(), values[name]) == 0.0
        assert chip_smoke.metric_state_bytes(metric) > 0
    metrics[next(iter(metrics))].update(*batches[0])
    with pytest.raises(AssertionError, match="states differ"):
        chip_smoke.cpu_reference(metrics, build("cpu"), batches, chip_smoke.curve_sources(metrics))


def test_compare_curves_takes_thresholds_bitwise_and_nan_by_place(chip_smoke):
    curve = (torch.tensor([0.5, float("nan")]), torch.tensor([1.0, 0.0]), torch.tensor([0.0, 1.0]))
    assert chip_smoke.compare_curves("c", curve, curve) == 0.0
    signed = (curve[0], curve[1], torch.tensor([-0.0, 1.0]))
    with pytest.raises(AssertionError, match="bit for bit"):
        chip_smoke.compare_curves("c", signed, curve)
    moved = (torch.tensor([float("nan"), 0.5]), curve[1], curve[2])
    with pytest.raises(AssertionError, match="NaN"):
        chip_smoke.compare_curves("c", moved, curve)
    assert chip_smoke.compare_curves("c", (curve[0], curve[1] + 1e-7, curve[2]), curve) <= 1e-6
    assert chip_smoke.compare_curves("c", [torch.tensor(0.25)], [torch.tensor(0.25)]) == 0.0


def test_curve_edge_cases_hold_nan_zeros_and_unsorted_thresholds(chip_smoke):
    inputs = chip_smoke.curve_edge_inputs()
    preds = inputs["binary"][0]
    assert np.isnan(preds).any() and (np.signbit(preds) & (preds == 0)).any()
    results = chip_smoke.curve_edge_results(inputs, "cpu")
    again = chip_smoke.curve_edge_results(inputs, "cpu")
    assert all(chip_smoke.compare_curves(name, value, again[name]) == 0.0 for name, value in results.items())
    assert results["binary_roc_list"][2].tolist() == chip_smoke.UNSORTED_THRESHOLDS[::-1]
    assert torch.isnan(results["multiclass_ap_none_exact"][3]) and torch.isnan(results["binary_pr_curve_exact"][2]).any()


def _tail_data(chip_smoke, ctr_n: int = 8192, rows: int = 400, classes: int = 12):
    """The curves phase's data at a small size, as ``curves_phase`` returns it (without
    the metrics)."""
    gen = torch.Generator().manual_seed(10)
    logits, target = chip_smoke.ctr_logits(gen, n=ctr_n, device="cpu")
    image_logits, labels = chip_smoke.imagenet_logits(gen, rows=rows, classes=classes, device="cpu")
    data = {"ctr": {"logits": logits, "scores": chip_smoke.ctr_probabilities(logits), "target": target},
            "imagenet": {"logits": image_logits, "scores": image_logits.softmax(1), "target": labels}}
    for workload, parts in (("ctr", 4), ("imagenet", 5)):
        entry = data[workload]
        entry["batches"] = list(zip(entry["scores"].chunk(parts), entry["target"].chunk(parts)))
    return data


def test_tail_data_makers_give_the_curves_data_and_skewed_groups(chip_smoke):
    """The logits makers draw what the score makers draw; the groups are 8 and skewed."""
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    scores, target = chip_smoke.ctr_scores(a, n=5000, device="cpu")
    logits, target2 = chip_smoke.ctr_logits(b, n=5000, device="cpu")
    assert torch.equal(scores, chip_smoke.ctr_probabilities(logits)) and torch.equal(target, target2)
    probs, labels = chip_smoke.imagenet_scores(a, rows=50, classes=6, device="cpu")
    image_logits, labels2 = chip_smoke.imagenet_logits(b, rows=50, classes=6, device="cpu")
    assert torch.equal(probs, image_logits.softmax(dim=1)) and torch.equal(labels, labels2)
    groups = chip_smoke.fairness_groups(torch.Generator().manual_seed(11), 40000, device="cpu")
    counts = torch.bincount(groups, minlength=chip_smoke.FAIRNESS_GROUPS)
    assert counts.numel() == 8 and bool((counts[:-1] > counts[1:]).all())
    data = _tail_data(chip_smoke)
    ml = chip_smoke.tower_inputs(torch.Generator().manual_seed(9), batch=64, labels=10, device="cpu")["multilabel"]
    inputs = chip_smoke.tail_inputs(data, ml, torch.zeros(8192, dtype=torch.int64))
    assert {kind: len(batches) for kind, batches in inputs.items()} == {
        "ctr_scores": 4, "ctr_logits": 4, "ctr_groups": 4, "imagenet_scores": 5, "imagenet_logits": 5, "multilabel": 1}
    assert torch.equal(torch.cat([b[0] for b in inputs["ctr_groups"]]), data["ctr"]["scores"])


def test_tower_tail_rehearsal_holds_the_cpu_port(chip_smoke):
    """Every tail metric at a small size, twice on the same inputs: equal bit for bit; a
    changed count, float sum or value is caught."""
    data = _tail_data(chip_smoke)
    ml = chip_smoke.tower_inputs(torch.Generator().manual_seed(9), batch=256, labels=10, device="cpu")["multilabel"]
    groups = chip_smoke.fairness_groups(torch.Generator().manual_seed(11), 8192, device="cpu")
    inputs = chip_smoke.tail_inputs(data, ml, groups)

    def run():
        return chip_smoke.run_tail(chip_smoke.tail_metrics("cpu", classes=12, labels=10), inputs, timed=False)

    first, second = run(), run()
    assert chip_smoke.hold_tail(second, first, bitwise=True) == {"sums": 0.0, "values": 0.0}
    assert list(first["fairness"]["value"]) == [k for k in first["fairness"]["value"] if k[:3] in ("DP_", "EO_")]
    states = second["group_rates"]["states"]
    second["group_rates"]["states"] = {**states, "tp": states["tp"] + 1}
    with pytest.raises(AssertionError, match="states differ"):
        chip_smoke.hold_tail(second, first)
    second["group_rates"]["states"] = states
    conf = second["calibration_l1"]["states"]["conf_bin"]
    second["calibration_l1"]["states"]["conf_bin"] = conf * (1 + 1e-5)
    with pytest.raises(AssertionError, match="states differ by"):
        chip_smoke.hold_tail(second, first)
    second["calibration_l1"]["states"]["conf_bin"] = conf
    second["ranking_loss"]["value"] = second["ranking_loss"]["value"] * (1 + 1e-5)
    with pytest.raises(AssertionError, match="values differ"):
        chip_smoke.hold_tail(second, first)


def test_lost_launches_are_the_launches_without_a_device_event(chip_smoke):
    """A trace's launches are matched to its device events by correlation id; each lost
    one is named by the op that made it, timed from the trace's first launch."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(kind, corr, start_us, name, parent=None):
        return SimpleNamespace(device_type=kind, id=corr, name=name, time_range=SimpleNamespace(start=start_us),
                               cpu_parent=SimpleNamespace(name=parent) if parent else None)

    launches = [event(DeviceType.CPU, 7, 100.0, "cudaLaunchKernel", "aten::index_add_"),
                event(DeviceType.CPU, 8, 350.0, "cudaLaunchKernel", "aten::sum"),
                event(DeviceType.CPU, 9, 1100.0, "cuLaunchKernel")]
    events = launches + [event(DeviceType.CUDA, 7, 120.0, "indexFuncLargeIndex")]
    assert chip_smoke.lost_launches(events, launches) == {
        "count": 2, "first": [["aten::sum", 0.25], ["cuLaunchKernel", 1.0]]}
    assert chip_smoke.lost_launches(events, launches, shown=1)["first"] == [["aten::sum", 0.25]]
    assert chip_smoke.lost_launches(events, []) == {"count": 0, "first": []}


def test_step_events_keep_the_steps_range_and_the_device_work_after_the_pause(chip_smoke):
    """Host events count inside the step's range; device events from the middle of the
    pause on, less the device copies of host ranges; the lead launches drop out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(kind, name, start_us, end_us, annotation=False):
        return SimpleNamespace(device_type=kind, name=name, is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=start_us, end=end_us))

    pause_us = chip_smoke.PROFILE_MARGIN_S * 1e6
    begin = 1000.0 + pause_us
    mark = event(DeviceType.CPU, chip_smoke.PROFILE_RANGE, begin, begin + 500.0)
    lead = [event(DeviceType.CPU, "cudaLaunchKernel", 10.0, 12.0), event(DeviceType.CUDA, "add", 20.0, 22.0)]
    inside = [event(DeviceType.CPU, "aten::sum", begin + 5.0, begin + 40.0),
              event(DeviceType.CPU, "cudaLaunchKernel", begin + 10.0, begin + 12.0),
              event(DeviceType.CUDA, "reduce_kernel", begin + 20.0, begin + 30.0),
              event(DeviceType.CUDA, "Memcpy DtoH", begin - 10.0, begin + 2.0)]
    ranges = [event(DeviceType.CUDA, "nccl:all_gather", begin + 20.0, begin + 60.0, annotation=True),
              event(DeviceType.CUDA, chip_smoke.PROFILE_RANGE, begin + 1.0, begin + 499.0)]
    after = [event(DeviceType.CPU, "aten::zeros", begin + 490.0, begin + 510.0)]
    kept = chip_smoke.step_events([*lead, mark, *inside, *ranges, *after])
    assert kept == inside
    with pytest.raises(AssertionError, match="2 host ranges"):
        chip_smoke.step_events([mark, mark])


def test_range_events_keep_the_last_named_range_and_the_device_work_it_launched(chip_smoke):
    """Within a step, a named host range (a soak's sync epoch) counts by its last
    occurrence: the host events inside it, the device events whose correlation id is one
    of theirs, and its own wall time; a step without the range fails."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(kind, name, start_us, end_us, ident=0):
        return SimpleNamespace(device_type=kind, name=name, id=ident,
                               time_range=SimpleNamespace(start=start_us, end=end_us))

    first = event(DeviceType.CPU, "soak.sync_epoch", 100.0, 200.0)
    before = [event(DeviceType.CPU, "cudaLaunchKernel", 110.0, 112.0, 1), event(DeviceType.CUDA, "k1", 120.0, 130.0, 1)]
    last = event(DeviceType.CPU, "soak.sync_epoch", 300.0, 450.0)
    inside = [event(DeviceType.CPU, "aten::add", 305.0, 320.0, 2),
              event(DeviceType.CPU, "cudaLaunchKernel", 310.0, 312.0, 3),
              event(DeviceType.CPU, "cudaMemcpyAsync", 330.0, 340.0, 4)]
    device = [event(DeviceType.CUDA, "k3", 315.0, 460.0, 3), event(DeviceType.CUDA, "Memcpy HtoD", 341.0, 345.0, 4)]
    after = [event(DeviceType.CPU, "cudaLaunchKernel", 455.0, 457.0, 5), event(DeviceType.CUDA, "k5", 458.0, 470.0, 5)]
    kept, wall_us = chip_smoke.range_events([first, *before, last, *inside, *device, *after], "soak.sync_epoch")
    assert kept == [*inside, *device] and wall_us == 150.0
    with pytest.raises(AssertionError, match="no host range named soak.sync_epoch"):
        chip_smoke.range_events([*before, *after], "soak.sync_epoch")


def test_largest_rel_diff_reads_nan_by_place_and_zero_as_absolute(chip_smoke):
    a = torch.tensor([1.0, 0.0, float("nan")])
    assert chip_smoke.largest_rel_diff(a, a) == 0.0
    assert chip_smoke.largest_rel_diff(torch.tensor([1.5, 1e-7, float("nan")]), a) == pytest.approx(0.5)
    assert chip_smoke.largest_rel_diff(torch.tensor([1.0, 0.0, 0.0]), a) == float("inf")


@pytest.mark.parametrize("workload", ["ctr", "imagenet"])
def test_point_metrics_adopt_the_curve_states_without_an_update(chip_smoke, workload):
    """The operating-point metrics take the curves phase's states by reference and give
    what the functional entry points give on the whole data."""
    import warnings

    from torchmetrics_tpu_torch import functional as tf

    data = _tail_data(chip_smoke)[workload]
    thresholds = 11 if workload == "ctr" else 9
    kwargs = {} if workload == "ctr" else {"classes": 12}
    build = chip_smoke.ctr_metrics if workload == "ctr" else chip_smoke.imagenet_metrics
    sources = build("cpu", thresholds=thresholds, **kwargs)
    for name in ("auroc_exact", "auroc_binned"):
        for batch in data["batches"]:
            sources[name].update(*batch)
    metrics = chip_smoke.point_metrics(workload, "cpu", thresholds=thresholds, **kwargs)
    chip_smoke.adopt_states(metrics, {"exact": sources["auroc_exact"], "binned": sources["auroc_binned"]})
    assert metrics["eer" + ("_none" if workload == "imagenet" else "") + "_exact"]._state["preds"][0] is \
        sources["auroc_exact"]._state["preds"][0]
    assert ("eer_macro_exact" in metrics) is False and ("eer_macro_binned" in metrics) is (workload == "imagenet")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for tag, thr in (("exact", None), ("binned", thresholds)):
            if workload == "ctr":
                want = tf.binary_recall_at_fixed_precision(data["scores"], data["target"], 0.2, thr)
            else:
                want = tf.multiclass_recall_at_fixed_precision(data["scores"], data["target"], 12, 0.2, thr)
            assert chip_smoke.compare_points(tag, metrics[f"recall_at_precision_{tag}"].compute(), want) == 0.0


def test_compare_points_takes_thresholds_bitwise_and_nan_by_place(chip_smoke):
    point = (torch.tensor([0.5, 0.0]), torch.tensor([0.25, float("nan")]))
    assert chip_smoke.compare_points("p", point, point) == 0.0
    with pytest.raises(AssertionError, match="bit for bit"):
        chip_smoke.compare_points("p", (point[0], torch.tensor([0.25 + 2**-25, float("nan")])), point)
    with pytest.raises(AssertionError, match="bit for bit"):
        chip_smoke.compare_points("p", (point[0], torch.tensor([float("nan"), 0.25])), point)
    assert chip_smoke.compare_points("p", (point[0] + 1e-7, point[1]), point) <= 1e-6
    assert chip_smoke.compare_points("p", torch.tensor(0.125), torch.tensor(0.125)) == 0.0


def test_curve_point_edge_cases_reach_both_fallbacks(chip_smoke):
    inputs = chip_smoke.curve_edge_inputs()
    results = chip_smoke.curve_point_edge_results(inputs, "cpu")
    again = chip_smoke.curve_point_edge_results(inputs, "cpu")
    assert len(results) == 112
    assert all(chip_smoke.compare_points(name, value, again[name]) == 0.0 for name, value in results.items())
    assert results["multiclass_specificity_at_sensitivity_0.5_scores_exact"][1][3].item() == 1e6
    assert torch.isnan(results["multiclass_recall_at_fixed_precision_0.5_scores_exact"][1][3])
    assert torch.isnan(results["binary_precision_at_fixed_recall_0.5_scores_list"][1]).item() is False


def test_m5_inputs_are_intermittent_counts_with_positive_forecasts(chip_smoke):
    forecast, sold = chip_smoke.m5_inputs(series=4000, device="cpu")
    assert forecast.shape == sold.shape == (chip_smoke.M5_DAYS, 4000)
    assert forecast.dtype == sold.dtype == torch.float32
    assert abs(float((sold == 0).float().mean()) - chip_smoke.M5_ZERO_SHARE) < 0.01
    sales = sold[sold > 0]
    assert bool((sales >= 1).all()) and torch.equal(sales, sales.round())
    assert bool((forecast > 0).all())


def test_weather_inputs_hold_the_four_variables_around_their_climatology(chip_smoke):
    forecast, truth = chip_smoke.weather_inputs(inits=3, points=5000, device="cpu")
    assert forecast.shape == truth.shape == (3, 5000, len(chip_smoke.WB_VARIABLES))
    assert chip_smoke.WB_POINTS == 29040 and chip_smoke.WB_INITS == 64
    for i, (_, mean, spread, error) in enumerate(chip_smoke.WB_VARIABLES):
        assert abs(float(truth[..., i].mean()) - mean) < 0.1 * spread
        assert abs(float((forecast - truth)[..., i].std()) / error - 1) < 0.05


def test_ensemble_and_nowcast_inputs_have_the_stated_shapes(chip_smoke):
    batches = chip_smoke.ensemble_inputs(points=300, members=5, updates=2, device="cpu")
    assert len(batches) == 2 and batches[0][0].shape == (300, 5) and batches[0][1].shape == (300,)
    assert chip_smoke.ENSEMBLE_POINTS == 1038240
    nowcast = chip_smoke.nowcast_inputs((8, 18, 32, 32), updates=4, device="cpu")
    assert len(nowcast) == 4 and nowcast[0][0].shape == (2, 18, 32, 32)
    rain = torch.cat([t for _, t in nowcast])
    assert abs(float((rain == 0).float().mean()) - 0.55) < 0.01 and bool((rain >= 0).all())


def test_moment_split_gives_uneven_shares_of_every_initialisation(chip_smoke):
    shares = [chip_smoke.moment_split(r, 2) for r in range(2)]
    assert [len(s) for s in shares] == [40, 24]
    assert sorted(i for s in shares for i in s) == list(range(chip_smoke.WB_INITS))
    assert list(chip_smoke.moment_split(0, 1)) == list(range(chip_smoke.WB_INITS))


def test_regression_rehearsal_holds_the_cpu_port(chip_smoke):
    """Both phases' metrics over their inputs at a small size, twice on the CPU: the
    holding rules accept equal runs, name every state float32 and give each cancelling
    value its kappa."""
    for inputs, build in ((chip_smoke.regression_inputs("cpu", scale=0.005), chip_smoke.regression_metrics),
                          (chip_smoke.correlation_inputs("cpu", scale=0.005), chip_smoke.correlation_metrics)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs = [chip_smoke.run_tail(build("cpu"), inputs, timed=False) for _ in range(2)]
        worst = chip_smoke.hold_states("rehearsal", runs[0], runs[1])
        assert worst["values"] == 0.0 and worst["sums"] == 0.0
        assert chip_smoke.hold_states("rehearsal", runs[0], runs[1], bitwise=True)["values"] == 0.0
    assert set(chip_smoke.regression_metrics("cpu")) >= {"crps", "csi_8_per_lead", "weather_nrmse_range", "spearman"}


def test_hold_states_is_bitwise_but_for_transcendental_sums_and_cancelling_values(chip_smoke):
    def entry(states, value):
        return {"states": {k: torch.tensor(v, dtype=torch.float32) for k, v in states.items()},
                "value": torch.tensor(value, dtype=torch.float32)}

    want = {"mse": entry({"sum_squared_error": [4.0], "total": 8.0}, 0.5),
            "msle": entry({"sum_squared_log_error": 2.0, "total": 8.0}, 0.25)}
    close = {"mse": want["mse"], "msle": entry({"sum_squared_log_error": 2.0 + 2e-7, "total": 8.0}, 0.25)}
    assert chip_smoke.hold_states("t", close, want)["sums"] > 0.0
    with pytest.raises(AssertionError, match="states differ"):
        chip_smoke.hold_states("t", {**close, "mse": entry({"sum_squared_error": [4.0 + 4e-7], "total": 8.0}, 0.5)},
                               want)
    with pytest.raises(AssertionError, match="float64"):
        bad = {"mse": {"states": {"sum_squared_error": torch.tensor([4.0], dtype=torch.float64),
                                  "total": torch.tensor(8.0)}, "value": torch.tensor(0.5)}}
        chip_smoke.hold_states("t", bad, {"mse": want["mse"]})
    # R2 on data far from 0: sum y^2 = 1e4 * n against tss = n gives kappa 1e4, and a
    # value 1e-3 relative off passes only under that bound
    states = {"sum_squared_error": [10001.0], "sum_error": [100.0], "total": 1.0}
    r2 = {"r2": entry({**states, "residual": [0.5]}, 0.5)}
    assert chip_smoke.cancellation("r2", r2["r2"]["states"]) == pytest.approx(10001.0)
    worst = chip_smoke.hold_states("t", {"r2": entry({**states, "residual": [0.5]}, 0.5005)}, r2)
    assert worst["kappa"]["r2"] == pytest.approx(10001.0) and worst["values"] == pytest.approx(1e-3, rel=1e-3)


def test_kendall_edge_inputs_count_nan_pairs_as_neither(chip_smoke):
    from torchmetrics_tpu_torch.functional.regression.kendall import _pair_counts

    x, y = chip_smoke.kendall_edge_inputs()
    xs, ys = x.double().numpy(), y.double().numpy()
    with np.errstate(invalid="ignore"):
        prod = np.sign(xs[:, None] - xs[None, :]) * np.sign(ys[:, None] - ys[None, :])
    upper = np.triu(np.ones(prod.shape, bool), 1)
    con, dis = _pair_counts(x, y)
    assert (float(con), float(dis)) == (float((upper & (prod > 0)).sum()), float((upper & (prod < 0)).sum()))


def test_largest_rel_diff_with_a_floor_is_absolute_below_it(chip_smoke):
    want = torch.tensor([1000.0, 0.01, float("nan")])
    got = torch.tensor([1000.0, 0.010001, float("nan")])
    assert chip_smoke.largest_rel_diff(got, want) == pytest.approx(1e-4, rel=1e-2)
    assert chip_smoke.largest_rel_diff(got, want, floor=1.0) == pytest.approx(1e-6, rel=1e-2)
    assert chip_smoke.largest_rel_diff(torch.tensor([1000.001, 0.01, float("nan")]), want, floor=1.0) == \
        pytest.approx(1e-6, rel=0.05)
    assert chip_smoke.largest_rel_diff(torch.tensor([1000.0, 0.01, 0.0]), want, floor=1.0) == math.inf


def _small_wrapper_data(chip_smoke):
    return chip_smoke.wrapper_data("cpu", scale=0.004)


def test_wrapper_data_makers_give_the_stated_batches_and_nan_rows(chip_smoke):
    data = _small_wrapper_data(chip_smoke)
    assert len(data["imagenet"]) == chip_smoke.IMAGENET_UPDATES and len(data["ctr"]) == chip_smoke.CTR_UPDATES
    assert len(data["weather"]) == max(2, int(chip_smoke.WB_INITS * 0.004))
    forecast = torch.stack([f for f, _ in data["weather"]])
    rows = int(torch.isnan(forecast).any(-1).sum())
    assert rows == data["nan_rows"] > 0 and int(torch.isnan(forecast).sum()) == rows  # one NaN a row
    assert data["imagenet"][0][0].shape[1] == max(8, int(chip_smoke.IMAGENET_CLASSES * 0.004))


def test_wrapper_suite_rehearsal_holds_the_cpu_port(chip_smoke):
    """The suite twice on the CPU at a small size: the holding rule accepts equal runs,
    Classwise gives one key a class, the tracker a best value and its step."""
    data = _small_wrapper_data(chip_smoke)
    classes = data["imagenet"][0][0].shape[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runs = [chip_smoke.wrapper_suite("cpu", data, classes=classes) for _ in range(2)]
    assert chip_smoke.hold_tree("rehearsal", runs[0]["values"], runs[1]["values"]) == 0.0
    values = runs[0]["values"]
    assert len(values["classwise"]) == classes and 0 <= int(values["tracker"]["step"]) < chip_smoke.TRACKER_EPOCHS
    assert values["multioutput"].shape == (4,) and bool(torch.isfinite(values["multioutput"]).all())
    assert values["tracker"]["all"].shape == (chip_smoke.TRACKER_EPOCHS,)


def test_hold_tree_reads_nested_outputs_and_names_the_leaf(chip_smoke):
    want = {"a": {"x": torch.tensor([1, 2], dtype=torch.int32)}, "b": (torch.tensor(0.5), torch.tensor(0.25))}
    assert list(chip_smoke.tree_leaves(want)) == ["a.x", "b.0", "b.1"]
    assert chip_smoke.hold_tree("t", {"a": {"x": torch.tensor([1, 2], dtype=torch.int32)},
                                      "b": (torch.tensor(0.5000005), torch.tensor(0.25))}, want) > 0.0
    with pytest.raises(AssertionError, match="a.x: counts differ"):
        chip_smoke.hold_tree("t", {"a": {"x": torch.tensor([1, 3], dtype=torch.int32)}, "b": want["b"]}, want)
    assert chip_smoke.clock_seconds([("start", 1.0), ("a", 3.0), ("b", 3.5)]) == {"a": 2.0, "b": 0.5}


@pytest.mark.parametrize("sampling, stacked", [("multinomial", True), ("poisson", False)])
def test_bootstrap_rehearsal_takes_its_path_and_holds_same_seeded_replicas(chip_smoke, sampling, stacked):
    data = _small_wrapper_data(chip_smoke)
    classes = data["imagenet"][0][0].shape[1]
    boots = [chip_smoke.bootstrapper("cpu", classes=classes, replicas=6, sampling=sampling) for _ in range(2)]
    assert all(b._use_stacked is stacked for b in boots)
    for boot in boots:
        for batch in data["imagenet"][:3]:
            boot.update(*batch)
    assert chip_smoke.hold_bootstrap("rehearsal", boots[0], boots[1]) == 0.0
    assert set(boots[0].compute()) == {"mean", "std", "quantile"}
    assert boots[0].compute()["quantile"].shape == (len(chip_smoke.BOOT_QUANTILES),)
    boots[1].update(*data["imagenet"][3])  # one update more: the replicas differ
    with pytest.raises(AssertionError, match="replica states"):
        chip_smoke.hold_bootstrap("rehearsal", boots[0], boots[1])


class _CountingWidth:
    """A toy extractor with a declared width, counting its calls."""

    num_features = 8

    def __init__(self) -> None:
        self.calls = 0

    def __call__(self, imgs, normalize=False):
        self.calls += 1
        return imgs.reshape(imgs.shape[0], -1)[:, :8].float() / 255


def test_feature_share_rehearsal_runs_the_extractor_once_per_shared_update(chip_smoke):
    """Host batches, as on the card: the shared members call the extractor once an
    update, the members alone once each, and both end with the same states."""
    gen = torch.Generator().manual_seed(0)
    batches = [(torch.randint(0, 256, (4, 3, 8, 8), generator=gen, dtype=torch.uint8).numpy(), i % 2 == 0)
               for i in range(chip_smoke.SHARE_UPDATES)]
    extractor = _CountingWidth()
    extractor.accepts_normalize = True
    run = chip_smoke.feature_share_run(extractor, batches, device="cpu")
    assert extractor.calls == 4 * chip_smoke.SHARE_UPDATES  # 1 shared + 3 alone an update
    assert run["shared_launches"] == run["alone_launches"] == 0  # the toy extractor launches no kernel
    assert len(run["shared"]) == 3
    for got, want in zip(run["shared"], run["alone"]):
        assert chip_smoke.states_equal(got, want)


def test_panoptic_maps_have_the_stated_shape_and_categories(chip_smoke):
    preds, target = chip_smoke.panoptic_maps(np.random.default_rng(0), 5, shape=(64, 96))
    assert preds.shape == target.shape == (5, 64, 96, 2) and preds.dtype == target.dtype == np.int32
    known = set(chip_smoke.PANOPTIC_THINGS) | set(chip_smoke.PANOPTIC_STUFFS)
    assert set(np.unique(target[..., 0])) <= known | {chip_smoke.PANOPTIC_VOID}
    assert set(np.unique(preds[..., 0])) <= known
    assert len(chip_smoke.PANOPTIC_THINGS) == 80 and len(chip_smoke.PANOPTIC_STUFFS) == 53
    stuff = np.isin(target[..., 0], chip_smoke.PANOPTIC_STUFFS)
    assert (target[..., 1][stuff] == 0).all()
    for image in target:
        colours = {tuple(c) for c in image.reshape(-1, 2)} - {(chip_smoke.PANOPTIC_VOID, 0)}
        assert 1 <= len(colours) <= chip_smoke.PANOPTIC_MAX_SEGMENTS


def test_panoptic_rehearsal_matches_and_keeps_its_states_on_the_metric_device(chip_smoke):
    rng = np.random.default_rng(1)
    batches = [tuple(torch.from_numpy(a) for a in chip_smoke.panoptic_maps(rng, 2, shape=(64, 96))) for _ in range(2)]
    runs = []
    for _ in range(2):
        metrics = chip_smoke.panoptic_metrics("cpu")
        run = chip_smoke.panoptic_run(metrics, batches)
        assert all(len(ms) == len(batches) for ms in run["host_ms"].values())  # one reading an update
        assert all("_host_batch_state" not in m.__dict__ for m in metrics.values())  # the clock is taken off
        runs.append(metrics)
    for name in runs[0]:
        assert chip_smoke.states_equal(runs[0][name]._state, runs[1][name]._state)
    assert int(runs[0]["pq"].true_positives.sum()) > 0
    values = chip_smoke.panoptic_values(runs[0])
    assert values["pq"].shape == (3,) and values["pq_per_class"].shape == (133, 3) and values["mpq"].shape == ()
    assert values["pq"].shape == runs[0]["pq"].compute().shape  # the per-class read left the flag as it was


def test_msmarco_inputs_have_the_stated_shape_ties_and_empty_queries(chip_smoke):
    data = chip_smoke.msmarco_inputs(queries=300, depth=200, update_queries=100, device="cpu")
    assert len(data["batches"]) == 3 and data["rows"] == 300 * 200
    preds, target, indexes = data["batches"][0]
    assert preds.dtype == torch.float32 and target.dtype == torch.int64 and indexes.dtype == torch.int64
    assert preds.shape == target.shape == indexes.shape == (100 * 200,)
    assert torch.equal(preds, preds.to(torch.bfloat16).float())  # bfloat16 logits held as float32
    assert indexes.unique().numel() == 100 and int(indexes.max()) < chip_smoke.MSMARCO_IDS
    assert 0.08 < data["empty_share"] < 0.22  # about 14% of the queries without a positive among the candidates
    assert 0.2 < data["tie_share"] < 1.0  # bfloat16 ties within a query
    assert bool((preds == 0).any()) and bool(torch.signbit(preds[preds == 0]).any())  # +0.0 and -0.0 scores
    positives = torch.cat([b[1] for b in data["batches"]]).reshape(300, 200).sum(-1)
    assert int(positives.max()) <= 3


def test_trec_inputs_are_graded_with_a_tenth_above_zero(chip_smoke):
    preds, gains, indexes = chip_smoke.trec_inputs(queries=43, depth=100, device="cpu")
    assert preds.shape == gains.shape == indexes.shape == (4300,)
    assert set(gains.unique().tolist()) == {0, 1, 2, 3} and 0.05 < float((gains > 0).double().mean()) < 0.15
    assert indexes.unique().numel() == 43


def test_retrieval_rehearsal_holds_the_cpu_port(chip_smoke):
    data = chip_smoke.msmarco_inputs(queries=40, depth=50, update_queries=20, device="cpu")
    runs = [chip_smoke.run_retrieval(chip_smoke.retrieval_metrics("cpu"), data["batches"], timed=False)
            for _ in range(2)]
    worst = chip_smoke.hold_retrieval("rehearsal", *runs)
    assert set(worst) == set(chip_smoke.retrieval_metrics("cpu")) and max(worst.values()) == 0.0
    assert runs[0]["pr_curve@100"]["value"][2].dtype == torch.int32
    runs[1]["map"]["states"]["preds"] = runs[1]["map"]["states"]["preds"].clone()
    runs[1]["map"]["states"]["preds"][0] = -runs[1]["map"]["states"]["preds"][0]
    with pytest.raises(AssertionError, match="states differ"):
        chip_smoke.hold_retrieval("rehearsal", *runs)
    edges = chip_smoke.retrieval_edge_results("cpu")
    assert len(edges) == 24 and max(chip_smoke.hold_retrieval("edges", edges, edges).values()) == 0.0


def test_retrieval_diff_is_relative_above_a_tenth_and_absolute_below(chip_smoke):
    diff = chip_smoke.value_diff
    assert diff(torch.tensor([0.5 + 2**-21]), torch.tensor([0.5])) == pytest.approx(2**-21 / 0.5e-6)
    low = torch.tensor([0.05])
    assert diff(low + 2**-27, low) == pytest.approx(2**-27 / 1e-7)
    assert diff(torch.tensor([float("nan")]), torch.tensor([float("nan")])) == 0.0
    assert diff(torch.tensor([float("nan")]), torch.tensor([0.0])) == math.inf
    assert diff(torch.tensor([3], dtype=torch.int32), torch.tensor([4], dtype=torch.int32)) == math.inf
    assert diff(torch.tensor([3], dtype=torch.int32), torch.tensor([3])) == math.inf  # dtypes must agree
    assert chip_smoke.same_bits(torch.tensor([float("nan"), -0.0]), torch.tensor([float("nan"), -0.0]))
    assert not chip_smoke.same_bits(torch.tensor([-0.0]), torch.tensor([0.0]))


def test_cityscapes_batch_has_void_regions_and_predictions_near_the_target(chip_smoke):
    gen = torch.Generator().manual_seed(0)
    pred, target = chip_smoke.cityscapes_batch(gen, 2, shape=(128, 256), device="cpu")
    assert pred.shape == target.shape == (2, 128, 256) and pred.dtype == target.dtype == torch.int64
    void = target == chip_smoke.CITYSCAPES_VOID
    assert 0.05 < float(void.double().mean()) < 0.15
    assert int(pred.max()) < chip_smoke.CITYSCAPES_CLASSES and int(target[~void].max()) < chip_smoke.CITYSCAPES_CLASSES
    agree = float((pred == target)[~void].double().mean())
    assert 0.6 < agree < 0.99
    assert len(chip_smoke.CITYSCAPES_SHARES) == chip_smoke.CITYSCAPES_CLASSES == 19


def test_segmentation_rehearsal_holds_the_cpu_port(chip_smoke):
    gen = torch.Generator().manual_seed(1)
    batches = [chip_smoke.cityscapes_batch(gen, 2, shape=(64, 128), device="cpu") for _ in range(2)]
    runs = [chip_smoke.segmentation_metrics("cpu") for _ in range(2)]
    for metrics in runs:
        for batch in batches:
            for m in metrics.values():
                m.update(*batch)
    worst = chip_smoke.hold_segmentation("rehearsal", *runs)
    assert worst == {"sums": 0.0, "values": 0.0}
    runs[1]["dice_macro"]._state["numerator"][0] = runs[1]["dice_macro"]._state["numerator"][0] + 1
    with pytest.raises(AssertionError, match="states differ"):
        chip_smoke.hold_segmentation("rehearsal", *runs)
    edges = chip_smoke.segmentation_edge_results("cpu")
    assert len(edges) == 16 and all(not v.is_floating_point() or v.dtype == torch.float32 for v in edges.values())


def test_brats_volume_nests_the_tumour_labels(chip_smoke):
    rng = np.random.default_rng(2)
    pred, target = chip_smoke.brats_volume(rng, shape=(64, 64, 40), device="cpu", wt_voxels=(2000, 6000))
    assert pred.shape == target.shape == (64, 64, 40) and pred.dtype == target.dtype == torch.int64
    assert set(target.unique().tolist()) == {0, 1, 2, 3}
    whole = target > 0
    assert 1500 < int(whole.sum()) < 8000  # the noise moves the surface a little

    def box(mask):
        idx = mask.nonzero()
        return idx.min(0).values, idx.max(0).values

    # necrotic core (1) within the core (1, 3) within the whole tumour (1, 2, 3)
    for inner, outer in ((target == 1, (target == 1) | (target == 3)), ((target == 1) | (target == 3), whole)):
        (lo_in, hi_in), (lo_out, hi_out) = box(inner), box(outer)
        assert bool((lo_in >= lo_out).all() and (hi_in <= hi_out).all())
    assert int(((pred > 0) != whole).sum()) > 0  # shifted, scaled and with strays


def test_edge_counts_and_brats_metrics_rehearsal(chip_smoke):
    rng = np.random.default_rng(3)
    pred, target = (t[None] for t in chip_smoke.brats_volume(rng, shape=(40, 40, 30), device="cpu",
                                                              wt_voxels=(800, 2000)))
    edges_pred, edges_target, pairs = chip_smoke.edge_counts(pred, target)
    assert edges_pred.shape == edges_target.shape == (1, 3)
    assert pairs == int((edges_pred * edges_target).sum()) > 0
    metrics = chip_smoke.brats_metrics("cpu")
    for m in metrics.values():
        m.update(pred, target)
    assert metrics["dice"].compute().shape == (3,) and float(metrics["hausdorff"].compute()) > 0
    assert metrics["hausdorff"].directed and metrics["hausdorff"].spacing == [1.0, 1.0, 1.0]


def test_value_diff_is_relative_above_a_tenth_absolute_below_and_passes_equal_infinities(chip_smoke):
    diff = chip_smoke.value_diff
    assert diff(torch.tensor(0.5 + 2**-21), torch.tensor(0.5)) == pytest.approx(2**-21 / 0.5e-6)
    assert diff(torch.tensor(0.05 + 2**-27), torch.tensor(0.05)) == pytest.approx(2**-27 / 1e-7)
    assert diff(torch.tensor(0.5 + 2**-21), torch.tensor(0.5), absolute=True) == pytest.approx(2**-21 / 1e-7)
    assert diff(torch.tensor(float("inf")), torch.tensor(float("inf"))) == 0.0
    assert diff(torch.tensor(float("nan")), torch.tensor(0.0)) == math.inf
    assert diff(torch.tensor(3, dtype=torch.int32), torch.tensor(3)) == math.inf


def test_pairwise_rehearsal_holds_the_cpu_port(chip_smoke, monkeypatch):
    monkeypatch.setattr(chip_smoke, "PAIRWISE_CPU_DIFF_ROWS", 8)
    queries, passages = chip_smoke.pairwise_inputs(rows=48, width=16, device="cpu")
    assert queries.shape == passages.shape == (48, 16) and queries.dtype == torch.float32
    for x, y, self_pairs in ((queries, passages, False), (queries[:24], queries[:24], True)):
        want, tolerances = chip_smoke.pairwise_reference(x, y, 16, self_pairs)
        assert set(want) == {f"{n}{s}" for n in chip_smoke.PAIRWISE_FUNCTIONS for s in ("", "_mean")}
        assert want["manhattan"].shape == (8, y.shape[0]) and want["cosine"].shape == (16, y.shape[0])
        # the card's rows, as the phase takes them from the full calls
        got = {}
        for name in chip_smoke.PAIRWISE_FUNCTIONS:
            rows = 16 if name in chip_smoke.PRODUCTS_13 else 8
            for reduction, suffix in ((None, ""), ("mean", "_mean")):
                out = chip_smoke.pairwise_call(name, x, None if self_pairs else y, reduction)
                got[f"{name}{suffix}"] = out[:rows]
        assert chip_smoke.hold_pairwise("rehearsal", got, want, tolerances) == 0.0
        if self_pairs:
            assert float(got["euclidean"].diagonal().abs().max()) == 0.0
    got["linear"] = got["linear"].clone()
    got["linear"][0, 1] += 1e-3
    with pytest.raises(AssertionError, match="tolerance units"):
        chip_smoke.hold_pairwise("rehearsal", got, want, tolerances)


def test_pose_inputs_rotate_scale_and_flatten_a_share(chip_smoke):
    pred, truth = chip_smoke.pose_inputs(n=300, device="cpu")
    assert pred.shape == truth.shape == (300, chip_smoke.POSE_JOINTS, 3)
    assert int((pred[:, :, 2] == 0).all(1).sum()) == 3 == int((truth[:, :, 2] == 0).all(1).sum())
    rotation = chip_smoke.quaternion_rotations(torch.randn(5, 4, dtype=torch.float64))
    assert torch.allclose(rotation @ rotation.transpose(1, 2), torch.eye(3, dtype=torch.float64).expand(5, 3, 3))
    assert torch.allclose(torch.linalg.det(rotation), torch.ones(5, dtype=torch.float64))
    gaps = chip_smoke.singular_gaps(pred, truth)
    assert bool((gaps[:3] < 1e-9).all()) and int((gaps > chip_smoke.SINGULAR_GAP).sum()) > 250


def test_procrustes_rehearsal_holds_the_cpu_port(chip_smoke):
    from torchmetrics_tpu_torch.functional import procrustes_disparity

    pred, truth = chip_smoke.pose_inputs(n=256, device="cpu")
    runs = [procrustes_disparity(pred, truth, return_all=True) for _ in range(2)]
    gaps = chip_smoke.singular_gaps(pred, truth)
    worst = chip_smoke.hold_procrustes("rehearsal", runs[0], runs[1], gaps, pred, truth)
    assert set(worst) == {"disparity", "scale", "rotation", "disparity_by_the_rotation"} and max(worst.values()) == 0
    metrics = chip_smoke.procrustes_metrics("cpu")
    for m in metrics.values():
        for batch in zip(pred.split(64), truth.split(64)):
            m.update(*batch)
    assert int(metrics["sum"].total) == 256 and float(metrics["sum"].compute()) > float(metrics["mean"].compute()) > 0
    planted = (runs[1][0], runs[1][1], runs[1][2].clone())
    row = int(torch.nonzero(gaps > chip_smoke.SINGULAR_GAP)[0])
    planted[2][row, 0, 0] += 1e-3
    with pytest.raises(AssertionError, match="tolerance units"):
        chip_smoke.hold_procrustes("rehearsal", planted, runs[1], gaps, pred, truth)


def test_procrustes_rehearsal_of_the_library_svd_and_the_wide_clouds(chip_smoke):
    """The pose updates through ``torch.linalg.svd`` hold the Jacobi path's values, and
    the wide clouds (D = 16, the library's SVD) hold themselves and fail on a plant."""
    from torchmetrics_tpu_torch.functional import procrustes_disparity
    from torchmetrics_tpu_torch.functional.shape import procrustes as procrustes_module

    pred, truth = chip_smoke.pose_inputs(n=256, device="cpu")
    jacobi, library = chip_smoke.procrustes_metrics("cpu"), chip_smoke.procrustes_metrics("cpu")
    with chip_smoke.procrustes_through_the_library():
        assert procrustes_module._JACOBI_MAX_D == 0
        for batch in zip(pred.split(64), truth.split(64)):
            library["mean"].update(*batch)
    assert procrustes_module._JACOBI_MAX_D == 3
    for batch in zip(pred.split(64), truth.split(64)):
        jacobi["mean"].update(*batch)
    assert chip_smoke.value_diff(library["mean"].compute(), jacobi["mean"].compute()) <= 1.0
    wide_pred, wide_truth = chip_smoke.wide_cloud_inputs(n=32, device="cpu")
    assert wide_pred.shape == wide_truth.shape == (32, *chip_smoke.WIDE_CLOUDS[1:])
    runs = [procrustes_disparity(wide_pred, wide_truth, return_all=True) for _ in range(2)]
    gaps = chip_smoke.singular_gaps(wide_pred, wide_truth)
    worst = chip_smoke.hold_procrustes("wide", runs[0], runs[1], gaps, wide_pred, wide_truth)
    assert worst["disparity"] == worst["scale"] == worst["rotation"] == 0
    # recomputed in float64 from the float32 rotation, so it is a rounding away from 0
    assert worst["disparity_by_the_rotation"] <= 1.0
    planted = (runs[1][0].clone(), runs[1][1], runs[1][2])
    planted[0][0] *= 1.001
    with pytest.raises(AssertionError, match="tolerance units"):
        chip_smoke.hold_procrustes("wide", planted, runs[1], gaps, wide_pred, wide_truth)


def test_argmax_rehearsal_is_numpys_and_sees_a_last_max_rule(chip_smoke):
    assert chip_smoke.argmax_mismatches("cpu") == 0

    def last_argmax(x, axis):
        return x.shape[axis] - 1 - x.flip(axis).argmax(axis)

    assert chip_smoke.argmax_mismatches("cpu", last_argmax) > 0


def test_adult_table_and_crowd_ratings_have_the_stated_shapes(chip_smoke):
    table = chip_smoke.adult_table(rows=5000, device="cpu")
    assert table.shape == (5000, 8) and table.dtype == torch.float32
    assert 0.005 < float(table.isnan().double().mean()) < 0.015
    for k, column in zip(chip_smoke.ADULT_CARDINALITIES, table.T):
        values = column[~column.isnan()]
        assert int(values.max()) < k and int(values.min()) >= 0
    probs, counts = chip_smoke.crowd_ratings((200, 5, 5), device="cpu")
    assert probs.shape == (200, 5, 5) and counts.shape == (200, 5) and bool((counts.sum(1) == 5).all())
    assert torch.allclose(probs.sum(1), torch.ones(200, 5))


def test_nominal_rehearsal_holds_the_cpu_port(chip_smoke):
    table = chip_smoke.adult_table(rows=3000, device="cpu")
    probs, counts = chip_smoke.crowd_ratings((300, 5, 5), device="cpu")
    batches = chip_smoke.nominal_batches(table, probs, counts)
    assert len(batches["pair"]) == chip_smoke.ADULT_UPDATES and len(batches["probs"]) == chip_smoke.CROWD_UPDATES
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runs = [chip_smoke.run_nominal(chip_smoke.nominal_classes("cpu"), batches, timed=False) for _ in range(2)]
        matrices = chip_smoke.nominal_matrices(table)
    assert chip_smoke.hold_nominal("rehearsal", *runs) == 0.0
    assert all(0.0 < float(e["value"]) < 1.0 for n, e in runs[0].items() if not n.startswith("fleiss"))
    assert len(chip_smoke.nominal_tables(table)) == 56 and len(matrices) == 8
    assert all(m.shape == (8, 8) for m, _ in matrices.values())
    runs[1]["theils_u"]["states"]["confmat"] = runs[1]["theils_u"]["states"]["confmat"] + 1
    with pytest.raises(AssertionError, match="states differ"):
        chip_smoke.hold_nominal("rehearsal", *runs)


def test_cluster_inputs_and_clustering_rehearsal(chip_smoke):
    preds, target, data = chip_smoke.cluster_inputs(samples=600, classes=20, clusters=20, width=8, device="cpu")
    assert preds.shape == target.shape == (600,) and data.shape == (600, 8) and data.dtype == torch.float32
    assert bool((torch.bincount(target) == 30).all()) and int(preds.max()) < 20
    batches = list(zip(preds.tensor_split(3), target.tensor_split(3), data.tensor_split(3)))
    runs = [chip_smoke.run_clustering(chip_smoke.cluster_metrics("cpu", classes=20), batches, timed=False)
            for _ in range(2)]
    assert len(runs[0]) == 13 and chip_smoke.hold_clustering("rehearsal", *runs) == 0.0
    chip_smoke.hold_contingency("rehearsal", preds, target, preds.clone(), target.clone())
    with pytest.raises(AssertionError, match="contingency"):
        chip_smoke.hold_contingency("rehearsal", preds, target, preds.flip(0), target)
    assert chip_smoke.expected_terms(preds, target) > 400
    runs[1]["RandScore"]["value"] = runs[1]["RandScore"]["value"] + 1e-3
    with pytest.raises(AssertionError, match="RandScore"):
        chip_smoke.hold_clustering("rehearsal", *runs)


def test_div2k_batch_and_image_rehearsal_holds_the_cpu_port(chip_smoke):
    gen = torch.Generator().manual_seed(0)
    preds, target = chip_smoke.div2k_batch(gen, 2, shape=(176, 184), device="cpu")  # MS-SSIM's five scales
    assert preds.shape == target.shape == (2, 3, 176, 184) and preds.dtype == torch.float32
    assert float(preds.min()) >= 0 and float(preds.max()) <= 1 and 0 < float((preds - target).abs().mean()) < 0.05
    assert chip_smoke.luma(preds).shape == (2, 1, 176, 184)
    metrics = chip_smoke.image_metrics("cpu")
    times = chip_smoke.run_image_updates(metrics, [(preds, target)] * 2, timed=False)
    assert set(times) == {*metrics, "image_gradients"}
    for name, metric in metrics.items():
        assert metric.update_count == 2 and bool(torch.isfinite(metric.compute()).all()), name
    assert 0.5 < float(metrics["ssim"].compute()) < 1.0
    got, want = chip_smoke.image_values(preds, target), chip_smoke.image_values(preds.clone(), target.clone())
    assert set(got) == {"psnr", "ssim", "ms_ssim", "uqi", "vif", "tv", "rmse_sw", "rase", "psnrb", "gradients"}
    worst = chip_smoke.hold_units("rehearsal", got, want, chip_smoke.IMAGE_UNITS)
    assert max(worst.values()) == 0.0
    got["ssim"] = got["ssim"] + 64 * chip_smoke.UNIT
    with pytest.raises(AssertionError, match="ssim"):
        chip_smoke.hold_units("rehearsal", got, want, chip_smoke.IMAGE_UNITS)
    got["ssim"] = want["ssim"]
    got["gradients"] = got["gradients"].clone()
    got["gradients"][0, 0, 0, 0, 0] += 2**-20
    with pytest.raises(AssertionError, match="gradients"):
        chip_smoke.hold_units("rehearsal", got, want, chip_smoke.IMAGE_UNITS)
    assert chip_smoke.units_diff(torch.tensor([2.0 + 2**-22]), torch.tensor([2.0])) == pytest.approx(2.0)
    assert chip_smoke.units_diff(torch.tensor([float("nan")]), torch.tensor([1.0])) == math.inf
    assert chip_smoke.central_crop(torch.zeros(1, 3, 10, 12), (4, 6)).shape == (1, 3, 4, 6)


def test_brats_mri_and_the_3d_window_forms(chip_smoke):
    rng = np.random.default_rng(0)
    preds, target = chip_smoke.brats_mri(rng, device="cpu", shape=(24, 24, 16), wt_voxels=(300, 600))
    assert preds.shape == target.shape == (1, 24, 24, 16) and target.dtype == torch.float32
    assert set(torch.unique(target / target.median()).round(decimals=0).tolist()) <= {0.0, 1.0, 2.0, 3.0}
    moments = chip_smoke.ssim_3d_moments(preds[None], target[None])
    assert moments.shape == (5, 1, 34, 34, 26)
    from torchmetrics_tpu_torch.functional.image.utils import _gaussian_kernel_3d, conv3d

    direct = conv3d(moments, _gaussian_kernel_3d(1, (11, 11, 11), (1.5, 1.5, 1.5)))
    separable = chip_smoke.separable_conv3d(moments)
    assert separable.shape == direct.shape == (5, 1, 24, 24, 16)
    assert float(((separable - direct).abs() / direct.abs().clamp(min=1e-30)).max()) < 1e-5


def test_pan_sets_and_pansharpening_rehearsal_holds_the_cpu_port(chip_smoke):
    gen = torch.Generator().manual_seed(0)
    reduced, full = chip_smoke.pan_set(gen, 2, 4, 64, device="cpu"), chip_smoke.pan_set(gen, 2, 4, 64, device="cpu")
    assert reduced["ms"].shape == (2, 4, 16, 16) and full["pan"].shape == (2, 4, 64, 64)
    assert torch.equal(full["pan"][:, 0], full["pan"][:, 3]) and full["pan_lr"].shape == (2, 4, 16, 16)
    metrics = chip_smoke.pan_metrics("cpu")
    for name, metric in metrics.items():
        metric.update(*chip_smoke.pan_args(name, reduced, full, slice(0, 2)))
        assert bool(torch.isfinite(metric.compute()).all()), name
    got, want = chip_smoke.pan_values(reduced, full), chip_smoke.pan_values(reduced, full)
    assert set(got) == set(chip_smoke.PAN_UNITS)
    assert max(chip_smoke.hold_units("rehearsal", got, want, chip_smoke.PAN_UNITS).values()) == 0.0
    assert torch.allclose(got["qnr"], metrics["qnr"].compute(), atol=1e-6)
    got["d_s"] = got["d_s"] + 1e-3
    with pytest.raises(AssertionError, match="d_s"):
        chip_smoke.hold_units("rehearsal", got, want, chip_smoke.PAN_UNITS)


def test_tf32_helper_runs_twice_and_restores_the_flags(chip_smoke):
    seen = []
    prior = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    results = chip_smoke.ieee_then_tf32(
        lambda: seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)) or len(seen))
    assert results == [1, 2] and seen == [(False, False), (True, True)]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == prior
    assert chip_smoke.hold_tf32_bits("rehearsal", lambda: {"x": torch.ones(3)}) == ["x"]


def test_ulps_diff_counts_float32_spacings_and_hold_all_names_every_key_beyond(chip_smoke):
    x = torch.tensor([7.0, -0.25, 1e-3])
    step = torch.nextafter(x, torch.full_like(x, math.inf))
    assert chip_smoke.ulps_diff(x, x) == 0.0
    assert chip_smoke.ulps_diff(step, x) == 1.0
    assert chip_smoke.ulps_diff(x[:2], x) == math.inf
    with pytest.raises(AssertionError, match="'a'.*'b'"):
        chip_smoke.hold_all("rehearsal", {"a": step, "b": step}, {"a": x, "b": x},
                            lambda name, got, want: chip_smoke.ulps_diff(got, want), 0)


def test_separation_rehearsal_holds_the_cpu_port_and_fails_planted_differences(chip_smoke, monkeypatch):
    monkeypatch.setattr(chip_smoke, "SDR_TAPS", 64)
    gen = torch.Generator().manual_seed(0)
    preds, target = chip_smoke.libri_mixture(gen, 3, samples=2000, device="cpu")
    spectra = (chip_smoke.stft_pairs(preds), chip_smoke.stft_pairs(target))
    assert spectra[0].shape == (3, 2, 257, 16, 2) and preds.shape == target.shape == (3, 2, 2000)
    got, want = (chip_smoke.separation_values(preds, target, spectra) for _ in range(2))
    assert set(chip_smoke.hold_separation("rehearsal", got, want).values()) == {0.0}
    assert not got["sdr_info"].any() and got["sdr_float64"].dtype == torch.float64
    def three_spacings_up(v):
        for _ in range(3):
            v = torch.nextafter(v, v + 1)
        return v

    for key, planted in (("si_snr", three_spacings_up), ("pit_perm", lambda v: v.flip(-1)),
                         ("sdr_float64", lambda v: v + 1e-5)):
        with pytest.raises(AssertionError, match=key):
            chip_smoke.hold_separation("rehearsal", {**got, key: planted(got[key])}, want)
    three = chip_smoke.libri_mixture(gen, 2, speakers=3, samples=1000, device="cpu")
    assert three[0].shape == (2, 3, 1000)


def test_speech_quality_rehearsal_holds_the_cpu_port(chip_smoke, tmp_path):
    from torchmetrics_tpu_torch import functional as fn
    from torchmetrics_tpu_torch.functional.audio import srmr

    gen = torch.Generator().manual_seed(0)
    reverb = chip_smoke.reverberant_speech(gen, (2, 8000), device="cpu")
    clips = chip_smoke.speech_like(gen, (2, 16000), 16000, device="cpu")
    path = str(tmp_path / "nisqa.tar")
    chip_smoke.nisqa_checkpoint(path)
    wave48 = chip_smoke.speech_like(gen, (2, 48000), 48000, device="cpu")
    values = {"srmr": fn.speech_reverberation_modulation_energy_ratio(reverb, 16000),
              "dnsmos": fn.deep_noise_suppression_mean_opinion_score(
                  clips, 16000, False, infer_fns=chip_smoke.DnsLinearModels(155, "cpu").fns()),
              "nisqa": fn.non_intrusive_speech_quality_assessment(wave48, 48000, checkpoint_path=path)}
    assert values["dnsmos"].shape == (2, 4) and values["nisqa"].shape == (2, 5)
    assert all(bool(torch.isfinite(v).all()) for v in values.values())
    worst = chip_smoke.hold_units("rehearsal", values, values, chip_smoke.SPEECH_UNITS)
    assert set(worst.values()) == {0.0}
    with pytest.raises(AssertionError, match="nisqa"):
        chip_smoke.hold_units("rehearsal", {**values, "nisqa": values["nisqa"] * (1 + 1e-4)}, values,
                              chip_smoke.SPEECH_UNITS)
    bands = torch.randn(2, 3, 1000, generator=gen, dtype=torch.float64)
    np.testing.assert_allclose(srmr._hilbert_envelope(bands).numpy(), chip_smoke.host_hilbert_envelope(bands.numpy()),
                               rtol=0, atol=1e-12)


def test_vmaf_rehearsal_holds_the_cpu_port_and_both_dwt_forms(chip_smoke, tmp_path):
    import json

    from torchmetrics_tpu_torch.functional.video import vmaf
    from torchmetrics_tpu_torch.video import VideoMultiMethodAssessmentFusion

    gen = torch.Generator().manual_seed(0)
    preds, target = chip_smoke.vmaf_video(gen, 1, shape=(3, 3, 40, 48), device="cpu")
    assert preds.shape == target.shape == (1, 3, 3, 40, 48) and 0 <= float(preds.min()) <= float(preds.max()) <= 1
    path = tmp_path / "vmaf_seeded.json"
    path.write_text(json.dumps(chip_smoke.vmaf_model_blob()))
    metric = VideoMultiMethodAssessmentFusion(features=True, model_path=str(path), device="cpu")
    metric.update(preds, target)
    scores = metric.compute()["vmaf"]
    assert scores.shape == (3,) and bool(((scores > 0) & (scores < 100)).all())  # inside the clip
    features = vmaf.vmaf_features(preds, target)
    assert set(chip_smoke.hold_units("rehearsal", features, features, chip_smoke.VMAF_UNITS).values()) == {0.0}
    with pytest.raises(AssertionError, match="integer_adm2"):
        chip_smoke.hold_units("rehearsal", {**features, "integer_adm2": features["integer_adm2"] + 1e-4}, features,
                              chip_smoke.VMAF_UNITS)
    luma = vmaf.calculate_luma(target).reshape(-1, 40, 48)
    scale = 2.8 * float(luma.abs().max())
    for a, b in zip(vmaf._dwt2_db2(luma), chip_smoke.dense_dwt_level(luma)):
        assert float((a - b).abs().max()) <= 8 * chip_smoke.UNIT * scale


# ------------------------------------------------------------------- slice 16: text

def test_zipf_vocabulary_is_seeded_distinct_and_alphabetic(chip_smoke):
    words = chip_smoke.zipf_vocabulary()
    assert len(words) == len(set(words)) == chip_smoke.ZIPF_WORDS
    assert words == chip_smoke.zipf_vocabulary.__wrapped__() and all(w.isalpha() and w.islower() for w in words)
    draw = chip_smoke.zipf_sampler(list(words))
    sample = draw(np.random.default_rng(0), 20000)
    counts = collections.Counter(sample)
    assert counts[words[0]] > counts[words[9]] > counts[words[99]]  # ranked frequencies


def test_mt_corpus_has_the_published_segment_count_and_length(chip_smoke):
    preds, target = chip_smoke.mt_corpus()
    assert len(preds) == len(target) == chip_smoke.WMT14_SEGMENTS == 3003
    assert all(len(t) == 1 for t in target)
    ref_tokens = np.mean([len(t[0].split()) for t in target])
    assert abs(ref_tokens - chip_smoke.WMT14_TOKENS) < 1.5, ref_tokens
    assert all(p.endswith(".") and (p[0].isupper() or p[0].isdigit()) for p in preds if p)
    assert sum(p != t[0] for p, t in zip(preds, target)) > 0.95 * len(preds)


def test_asr_corpus_has_librispeechs_shape_and_a_five_percent_error_rate(chip_smoke):
    from torchmetrics_tpu_torch.functional.text import word_error_rate

    preds, target = chip_smoke.asr_corpus()
    assert len(preds) == len(target) == chip_smoke.LIBRI_UTTERANCES == 2620
    assert abs(np.mean([len(t.split()) for t in target]) - chip_smoke.LIBRI_WORDS) < 1.0
    assert all(t == t.lower() and "," not in t for t in target)
    assert 0.04 < float(word_error_rate(preds, target, device="cpu")) < 0.07


def test_squad_and_summary_corpora_have_the_published_shapes(chip_smoke):
    preds, target = chip_smoke.squad_corpus()
    assert len(preds) == len(target) == chip_smoke.SQUAD_QUESTIONS == 10570
    assert {len(t["answers"]["text"]) for t in target} == {1, 2, 3}
    assert [p["id"] for p in preds] == [t["id"] for t in target]
    preds, target = chip_smoke.summary_corpus(500)
    assert len(preds) == len(target) == 500
    assert abs(np.mean([len(t.split()) for t in target]) - chip_smoke.CNNDM_WORDS) < 4
    assert {t.count(". ") + 1 for t in target} <= {3, 4} and all(p for p in preds)


def test_wordpiece_vocabulary_has_bert_base_uncaseds_layout_and_every_corpus_word(chip_smoke, tmp_path):
    from transformers import BertTokenizer

    words = list(chip_smoke.zipf_vocabulary())
    path = tmp_path / "vocab.txt"
    entries = chip_smoke.wordpiece_vocabulary(str(path), words)
    assert len(entries) == len(set(entries)) == 30522 == len(path.read_text().splitlines())
    assert [entries.index(t) for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")] == [0, 100, 101, 102, 103]
    assert set(words) <= set(entries)
    tokenizer = BertTokenizer(vocab_file=str(path))
    sentence = chip_smoke.mt_corpus(1)[1][0][0]
    pieces = tokenizer.tokenize(sentence)
    assert "[UNK]" not in pieces and sum(not p.startswith("##") for p in pieces) >= len(sentence.split())
    with pytest.raises(ValueError, match="do not fit"):
        chip_smoke.wordpiece_vocabulary(str(tmp_path / "small.txt"), words, size=1000)
    from transformers import AutoTokenizer

    chip_smoke.write_wordpiece_tokenizer(str(tmp_path), entries)
    loaded = AutoTokenizer.from_pretrained(str(tmp_path), local_files_only=True)
    assert loaded.tokenize(sentence) == pieces and loaded.mask_token_id == 103
    assert chip_smoke.check_tokenizer(loaded, [sentence]) == len(pieces) + 2
    with pytest.raises(AssertionError, match=r"\[UNK\]"):
        chip_smoke.check_tokenizer(loaded, ["жж"])


def test_text_rehearsal_holds_the_cpu_port_and_fails_a_planted_difference(chip_smoke):
    for phase in ("text_mt", "text_asr", "text_qa_sum"):
        batches = chip_smoke.text_phase_batches(phase, segments=chip_smoke.TEXT_BATCH + 8)
        assert all(len(v) == 2 for v in batches.values())
        metrics = chip_smoke.text_metrics(phase, device="cpu")
        run = chip_smoke.run_text(metrics, batches, prefix=1, timed=False)
        assert set(run["snapshots"]) == set(metrics)
        replay = chip_smoke.text_metrics(phase, device="cpu")
        chip_smoke.run_text(replay, {k: v[:1] for k, v in batches.items()}, prefix=1, timed=False)
        assert set(chip_smoke.hold_text(phase, run["snapshots"], replay).values()) == {0.0}
        with pytest.raises(AssertionError, match="differs from the CPU port's"):
            chip_smoke.hold_text(phase, metrics, replay)  # two updates against one
        values = chip_smoke.text_values(metrics)
        assert all(math.isfinite(v) for leaves in values.values() for v in leaves.values() if isinstance(v, float))


def test_perplexity_inputs_are_language_model_logits(chip_smoke):
    gen = torch.Generator().manual_seed(0)
    logits, target = chip_smoke.ppl_window(gen, windows=2, context=64, vocab=500, device="cpu")
    assert logits.shape == (2, 64, 500) and logits.dtype == torch.float32 and target.dtype == torch.int64
    metrics = chip_smoke.ppl_metrics(device="cpu")
    for name, metric in metrics.items():
        metric.update(*chip_smoke.ppl_inputs(name, logits, target))
    assert float(metrics["ignore_index"].count) == 2 * 64 * 7 / 8 and float(metrics["float32"].count) == 128
    assert 1.0 < float(metrics["float32"].compute()) < 50.0  # a language model's, not the vocabulary's 500
    bf16 = chip_smoke.ppl_inputs("bfloat16", logits, target)[0]
    assert bf16.dtype == torch.bfloat16
    assert chip_smoke.PPL_UPDATES * chip_smoke.PPL_WINDOWS * chip_smoke.GPT2_CONTEXT >= \
        chip_smoke.WIKITEXT103_TEST_TOKENS > (chip_smoke.PPL_UPDATES - 1) * chip_smoke.PPL_WINDOWS * chip_smoke.GPT2_CONTEXT


def test_bert_rehearsal_writes_a_loadable_model_and_times_both_parts(chip_smoke, tmp_path):
    from torchmetrics_tpu_torch.text import BERTScore, InfoLM

    small = {**chip_smoke.BERT_BASE, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
             "intermediate_size": 64, "max_position_embeddings": 128}
    preds, target = chip_smoke.mt_corpus(12, seed=1607)
    target = [t[0] for t in target]
    words = list(chip_smoke.zipf_vocabulary())
    bert = chip_smoke.write_bert(str(tmp_path / "bert"), words, masked_lm=False, seed=1, config=small)
    metric = BERTScore(bert, num_layers=1, idf=True, batch_size=5, device="cpu")
    metric.update(preds, target)
    value = metric.compute()
    assert value["f1"].shape == (12,) and bool(torch.isfinite(value["f1"]).all())
    parts, embeddings = chip_smoke.bert_score_parts(metric)
    assert parts["embedder_tokens_per_s"] > 0 and parts["matching_ms"] > 0 and len(embeddings) == 4
    assert chip_smoke.attended_tokens(metric) == int(sum(int(m.sum()) for m in metric._state["preds_attention_mask"]
                                                         + metric._state["target_attention_mask"]))
    mlm = chip_smoke.write_bert(str(tmp_path / "mlm"), words, masked_lm=True, seed=1, config=small)
    infolm = InfoLM(mlm, return_sentence_level_score=True, device="cpu")
    infolm.update(preds[:3], target[:3])
    assert infolm.compute()[1].shape == (3,)


def test_vocaset_sequences_and_the_lip_map(chip_smoke):
    from torchmetrics_tpu_torch.multimodal import LipVertexError

    gen = torch.Generator().manual_seed(0)
    pred, truth = chip_smoke.vocaset_sequence(gen, frames=12, vertices=300, device="cpu")
    assert pred.shape == truth.shape == (12, 300, 3)
    mouth = chip_smoke.lip_map(vertices=300, count=40)
    assert len(set(mouth)) == 40 and mouth == sorted(mouth) and max(mouth) < 300
    assert len(chip_smoke.lip_map()) == chip_smoke.LIP_VERTICES and max(chip_smoke.lip_map()) < 5023
    metric = LipVertexError(mouth_map=mouth, device="cpu")
    metric.update(pred, truth)
    assert 0 < float(metric.compute()) < 1e-3 and metric.total.dtype == torch.int32


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_weights_are_written_in_the_published_layouts_and_load(chip_smoke, tmp_path, net):
    from torchmetrics_tpu_torch.functional.image.lpips import _NETS, LPIPSNetwork

    spec = _NETS[net][0]
    sd = chip_smoke.he_features(spec, torch.Generator().manual_seed(0))
    convs = [i for i, layer in enumerate(spec) if layer[0] == "conv"]
    assert all(f"{i}.weight" in sd and f"{i}.bias" in sd for i in convs)
    network = LPIPSNetwork(net, weights_path=chip_smoke.write_lpips_weights(str(tmp_path), net, 1))
    a, b = chip_smoke.image_pairs(torch.Generator().manual_seed(1), 2, 64, device="cpu")
    assert a.shape == (2, 3, 64, 64) and float(a.min()) >= -1 and float(b.max()) <= 1
    values = network(a, b)
    assert values.shape == (2,) and bool(((values > 0) & (values < 1)).all())


def test_lpips_backward_rehearsal_swaps_the_conv_and_restores_it(chip_smoke, tmp_path):
    """On the CPU TF32 does not exist, so the plain convs give conv2d_full's gradient and
    the float64 backward gives it within float32's rounding of the backward's sums; the
    swap and the flags are undone after the block, and a planted difference reads."""
    from torchmetrics_tpu_torch.functional.image import lpips as module

    network = module.LPIPSNetwork("alex", weights_path=chip_smoke.write_lpips_weights(str(tmp_path), "alex", 1))
    a, b = chip_smoke.image_pairs(torch.Generator().manual_seed(3), 2, 64, device="cpu")

    def grad():
        leaf = a.clone().requires_grad_(True)
        network(leaf, b).sum().backward()
        return leaf.grad

    sound = grad()
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    for kind in chip_smoke.LPIPS_CONVS:
        with chip_smoke.lpips_conv(kind):
            assert module.conv2d_full.__name__ == "conv"
            swapped = grad()
        assert module.conv2d_full.__name__ == "conv2d_full"
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
        reading = chip_smoke.grad_distance(swapped, sound)
        assert reading["rel_l2"] < (1e-5 if kind == "float64_backward" else 1e-6), (kind, reading)
        assert reading["cosine"] > 1 - 1e-9
    with pytest.raises(ValueError):
        with chip_smoke.lpips_conv("tf32"):
            pass
    planted = sound.clone()
    planted[1] *= 1.5
    reading = chip_smoke.grad_distance(planted, sound)
    assert reading["worst_image_rel_l2"] == pytest.approx(0.5) and 0 < reading["rel_l2"] < 0.5


def test_arniqa_checkpoints_load_through_the_hub_cache(chip_smoke, tmp_path, monkeypatch):
    from torchmetrics_tpu_torch.functional.image import arniqa

    chip_smoke.arniqa_checkpoints(str(tmp_path), 0)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    img = chip_smoke.image_pairs(torch.Generator().manual_seed(2), 1, (48, 64), low=0.0, device="cpu")[0]
    scores = arniqa(img, reduction="none")
    assert scores.shape == (1,) and bool(torch.isfinite(scores).all())


def test_stylegan_stand_in_is_seeded_and_in_range(chip_smoke):
    generator = chip_smoke.ToyGenerator(0).requires_grad_(False)
    z = generator.sample(2)
    assert z.shape == (2, chip_smoke.TOY_Z)
    generator.reset()
    assert torch.equal(generator.sample(2), z)
    images = generator(z)
    assert images.shape == (2, 3, chip_smoke.TOY_RES, chip_smoke.TOY_RES)
    assert float(images.min()) >= 0 and float(images.max()) <= 255 and float(images.std()) > 1


def test_clip_rehearsal_writes_a_loadable_model_whose_tokenizer_knows_every_caption(chip_smoke, tmp_path):
    from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment, CLIPScore

    small = {"text_config": {**chip_smoke.CLIP_L14["text_config"], "hidden_size": 32, "intermediate_size": 64,
                             "num_hidden_layers": 1, "num_attention_heads": 2, "projection_dim": 16},
             "vision_config": {**chip_smoke.CLIP_L14["vision_config"], "hidden_size": 32, "intermediate_size": 64,
                               "num_hidden_layers": 1, "num_attention_heads": 2, "image_size": 224,
                               "patch_size": 32, "projection_dim": 16},
             "projection_dim": 16}
    model_dir = chip_smoke.write_clip(str(tmp_path), 0, config=small, device="cpu")
    assert (tmp_path / "tokenizer.json").is_file()
    captions = chip_smoke.coco_captions(40, 1742)
    assert set("".join(captions).lower()) - {" "} <= {k[0] for k in chip_smoke.clip_vocabulary() if len(k) <= 5}
    metric = CLIPScore(model_dir, device="cpu")
    assert chip_smoke.check_clip_tokens(metric, captions) > 0
    images = chip_smoke.host_images(torch.Generator().manual_seed(3), 2, (48, 64), device="cpu")
    assert images.dtype == torch.uint8 and images.shape == (2, 3, 48, 64)
    metric.update(list(images), captions[:2])
    assert int(metric.n_samples) == 2 and bool(torch.isfinite(metric.compute()))
    iqa = CLIPImageQualityAssessment(model_dir, data_range=255.0, prompts=chip_smoke.CLIP_IQA_PROMPTS, device="cpu")
    iqa.update(images)
    assert list(iqa.compute()) == ["quality", "brightness", "sharpness", "user_defined_0"]


# ------------------------------------------------------------ the reliability phase


class _TinyFeatures:
    """A 16-wide projection of 3x8x8 images: FID's update without a trunk. A batch of
    another channel count cannot be multiplied, as the trunk's first conv cannot take it."""

    num_features = 16

    def __init__(self):
        self.weight = torch.from_numpy(np.random.default_rng(3).normal(size=(3 * 8 * 8, 16)).astype(np.float32))

    def __call__(self, imgs):
        return imgs.float().reshape(imgs.shape[0], 3 * 8 * 8) @ self.weight


def _tiny_batches(n=4, seed=18):
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand((6, 3, 8, 8), generator=gen) for _ in range(n)]


def test_reliability_rehearsal_recovers_rolls_back_and_attempts_once(chip_smoke):
    extractor, batches = _TinyFeatures(), _tiny_batches()
    runs = []
    for _ in range(2):
        plain = chip_smoke.reliability_fid(extractor, device="cpu")
        chip_smoke.fid_updates(plain, batches)
        runs.append(chip_smoke.tensor_states(plain))
    spread = chip_smoke.state_spread(runs[1], runs[0])
    assert set(spread.values()) == {0.0}
    retried = chip_smoke.reliability_fid(extractor, chip_smoke.retry_config(), device="cpu")
    assert chip_smoke.retried_fid_run(retried, batches) == {"faults": 1, "attempts": 5}
    assert chip_smoke.within_spread(chip_smoke.tensor_states(retried), runs[0], spread)
    assert chip_smoke.states_equal(chip_smoke.tensor_states(retried), runs[0])
    exhausted = chip_smoke.exhausted_budget(chip_smoke.reliability_fid(extractor, chip_smoke.retry_config(),
                                                                       device="cpu"), batches)
    assert exhausted == {"attempts": 3, "rolled_back": True, "update_count_after_failure": 2,
                         "update_count_after_next": 3}
    deterministic = chip_smoke.deterministic_attempts(
        chip_smoke.reliability_fid(extractor, chip_smoke.retry_config(), device="cpu"), torch.rand((6, 4, 8, 8)))
    assert deterministic == {"error": "RuntimeError", "verdict": "deterministic", "attempts": 1}


def test_reliability_rehearsal_fails_without_a_policy_and_on_a_planted_difference(chip_smoke):
    from torchmetrics_tpu_torch.utilities.exceptions import TransientRuntimeError

    extractor, batches = _TinyFeatures(), _tiny_batches()
    with pytest.raises(TransientRuntimeError):
        chip_smoke.retried_fid_run(chip_smoke.reliability_fid(extractor, device="cpu"), batches)
    plain = chip_smoke.reliability_fid(extractor, device="cpu")
    chip_smoke.fid_updates(plain, batches)
    states = chip_smoke.tensor_states(plain)
    planted = dict(states, real_features_sum=states["real_features_sum"] + 1e-3)
    zero = {k: 0.0 for k in states}
    assert not chip_smoke.within_spread(planted, states, zero)
    assert chip_smoke.within_spread(planted, states, dict(zero, real_features_sum=2e-3))


def test_kernel_errors_classify_deterministic(chip_smoke):
    verdicts = chip_smoke.kernel_error_verdicts(PTXAS_LOG)
    assert set(verdicts) == {"launch_error_1", "launch_error_2", "launch_error_700", "launch_error_719",
                             "build_error"}
    assert set(verdicts.values()) == {"deterministic"}


def test_retried_sync_rehearsal_recovers_and_keeps_local_states(chip_smoke):
    extractor, batches = _TinyFeatures(), _tiny_batches()
    source = chip_smoke.reliability_fid(extractor, device="cpu")
    chip_smoke.fid_updates(source, batches)
    gen = torch.Generator().manual_seed(5)
    preds, target = torch.randn((64, 5), generator=gen), torch.randint(0, 5, (64,), generator=gen)
    out = chip_smoke.retried_sync(lambda gather: chip_smoke.sync_collection(source, preds, target, gather, "cpu"),
                                  distributed_available=lambda: True)
    assert out["gather_failures"] == 1 and out["recovered_bitwise"] and out["local_states_kept"]
    # the failure, then two syncs (the retried one and the poisoned one) of three
    # collectives each: the metadata and the float32 and int32 buckets
    assert out["gather_calls"] == 1 + 3 + 3


def test_plot_value_rehearsal_and_the_jax_packages_error_text(chip_smoke):
    from torchmetrics_tpu.utilities.plot import _error_msg
    from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix

    assert chip_smoke.PLOT_ERROR_TEXT == _error_msg
    extractor, batches = _TinyFeatures(), _tiny_batches()
    fid = chip_smoke.reliability_fid(extractor, device="cpu")
    chip_smoke.fid_updates(fid, batches)
    confmat = MulticlassConfusionMatrix(5, normalize="true", device="cpu")
    confmat.update(torch.randn(32, 5), torch.randint(0, 5, (32,)))
    out = chip_smoke.plot_value_checks({"fid": (fid, fid.compute()), "confusion_matrix": (confmat, confmat.compute())})
    assert out["values"] == {"fid": [], "confusion_matrix": [5, 5]}


# ------------------------------------------------------------------ observability phase


def test_fid_update_flops_are_what_flop_counter_mode_counts_on_the_trunk(chip_smoke):
    """The analytic count of one FID update (the trunk's convs from their shapes and the
    covariance product) equals ``FlopCounterMode``'s on the CPU, where sepconv7's
    reference runs as einsums the mode sees: the card's harvest adds the kernel's own
    ``2·B·C·O·H·W·7`` for the same work."""
    from torch.utils.flop_counter import FlopCounterMode

    from torchmetrics_tpu_torch.image import FrechetInceptionDistance, InceptionV3Features

    trunk = InceptionV3Features(seed=0, device="cpu")
    fid = FrechetInceptionDistance(feature=trunk, normalize=True, device="cpu")
    imgs = torch.rand((1, 3, 299, 299), generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        fid.update(imgs, real=True)
    assert counter.get_total_flops() == chip_smoke.fid_update_flops(trunk, 1)
    sep = sum(2 * c * o * 17 * 17 * 7 for c, o, _ in chip_smoke.trunk_sepconv_shapes())
    assert chip_smoke.trunk_flops(trunk, 2) == 2 * chip_smoke.trunk_flops(trunk, 1) > 2 * sep


def _event(name, device, start, end, eid):
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, device_type=getattr(DeviceType, device), id=eid,
                           time_range=SimpleNamespace(start=start, end=end))


def test_launches_inside_spans_matches_kernels_to_their_launch_and_range(chip_smoke):
    span = chip_smoke.FID_UPDATE_SPAN
    events = [
        _event(span, "CPU", 0, 100, -1), _event(span, "CPU", 200, 300, -2),
        _event("cudaLaunchKernel", "CPU", 10, 12, 1), _event("sepconv7_bf16_kernel", "CUDA", 20, 40, 1),
        _event("cuLaunchKernel", "CPU", 210, 212, 2), _event("sepconv7_bf16_kernel", "CUDA", 220, 240, 2),
        _event("cudaLaunchKernel", "CPU", 150, 152, 3), _event("sepconv7_bf16_kernel", "CUDA", 160, 170, 3),
        _event("cudaLaunchKernel", "CPU", 20, 22, 4), _event("other_kernel", "CUDA", 30, 35, 4),
        _event(span, "CUDA", 0, 100, -3),  # the range's device copy is no host range
    ]
    got = chip_smoke.launches_inside_spans(events, span, "sepconv7")
    assert got == {"kernels": 3, "inside": 2, "spans": 2, "per_span": [1, 1]}


def test_the_synced_metadata_row_is_the_cpu_encoders(chip_smoke):
    """The phase's comparison on the CPU: the row a coalesced sync in a session hands to
    its transport equals the encoder's row from CPU copies of the states and the
    session's vectors, tails included."""
    from torchmetrics_tpu_torch import observability as obs

    coll = chip_smoke.obs_collection("cpu")
    gen = torch.Generator().manual_seed(3)
    preds, target = torch.randn((64, 5), generator=gen), torch.randint(0, 5, (64,), generator=gen)
    with obs.telemetry_session() as rec:
        coll.update(preds, target)
        coll.update(preds, target)
        states, reductions = chip_smoke.distinct_states(coll)
        vectors = (rec.counters.counts_vector(), rec.histograms.fleet_vector())
        rows = chip_smoke.captured_metadata_rows(lambda: coll.sync(distributed_available=lambda: True))
        coll.unsync()
    want = chip_smoke.cpu_metadata_row(states, reductions, *vectors)
    assert len(rows) == 1 and np.array_equal(rows[0], want)
    # 3 members dispatch the first update, the 2 group leaders the second: 5 ride the tail
    assert vectors[0][0] == 5 and want[3] == len(vectors[0])
    assert not np.array_equal(want, chip_smoke.cpu_metadata_row(states, reductions, None, None))


def test_observability_rehearsal_counts_costs_and_keeps_the_states(chip_smoke, tmp_path):
    """The phase's FID checks on the CPU through a projection extractor: 4 dispatches, 1
    compile, 3 hits and no readback under a blocking session; the cost record's flops are
    the projection's and the covariance product's; the states equal a run without a
    session bit for bit; ``trace_report`` reads the session's JSONL trace."""
    from torchmetrics_tpu_torch import observability as obs

    extractor, batches = _TinyFeatures(), _tiny_batches()
    plain = chip_smoke.reliability_fid(extractor, device="cpu")
    chip_smoke.fid_updates(plain, batches)
    fid = chip_smoke.reliability_fid(extractor, device="cpu")
    trace = tmp_path / "trace.jsonl"
    config = obs.TelemetryConfig(sinks=(obs.JSONLSink(str(trace)), obs.RingBufferSink()), block_until_ready=True,
                                 history_clock=lambda: 0.0)
    with obs.telemetry_session(config) as rec:
        chip_smoke.fid_updates(fid, batches)
        snap, costs = rec.counters.snapshot(), rec.cost_snapshot()
    assert [snap[k] for k in ("dispatches", "jit_compiles", "jit_cache_hits", "d2h_readbacks")] == [4, 1, 3, 0]
    ((key, sigs),) = costs.items()
    assert key == "FrechetInceptionDistance#0.update" and list(sigs) == ["float32(6, 3, 8, 8)|bool()"]
    assert sigs["float32(6, 3, 8, 8)|bool()"]["flops"] == 2 * 6 * 192 * 16 + 2 * 6 * 16 * 16
    assert all(torch.equal(v, plain._state[k]) for k, v in chip_smoke.tensor_states(fid).items())
    report = chip_smoke.trace_report(str(trace))
    assert [(r["metric"], r["phase"], r["events"], r["compiles"], r["cache_hits"]) for r in report["rows"]] == [
        ("FrechetInceptionDistance#0", "update", 4, 1, 3)]


# ------------------------------------------------------------------------ aot phase


def test_aot_child_arguments_parse(chip_smoke):
    flag = chip_smoke.AOT_CHILD_FLAG
    assert flag == "--aot-child"
    for mode in ("warm", "cold", "corrupt"):
        assert chip_smoke.parse_aot_child(["chip_smoke.py", flag, "/tmp/cache", mode]) == ("/tmp/cache", mode)
    assert chip_smoke.parse_aot_child(["chip_smoke.py"]) is None
    assert chip_smoke.parse_aot_child(["chip_smoke.py", chip_smoke.SYNC_CHILD_FLAG, "0", "2", "x", "sync"]) is None
    for bad in (["chip_smoke.py", flag, "/tmp/cache"], ["chip_smoke.py", flag, "/tmp/cache", "hot"]):
        with pytest.raises(SystemExit):
            chip_smoke.parse_aot_child(bad)


def test_aot_phase_expects_every_member_both_codecs_and_104_launches(chip_smoke):
    from torchmetrics_tpu_torch.aot import codecs

    assert sorted(chip_smoke.AOT_MEMBERS) == sorted(chip_smoke.obs_collection("cpu").keys())
    assert chip_smoke.AOT_TAGS == ("update", "forward")
    assert chip_smoke.AOT_CODECS == [codecs.CODEC_EXEC, codecs.CODEC_HLO] == ["aoti", "torch_export"]
    assert chip_smoke.AOT_CORRUPT_MEMBER in chip_smoke.AOT_MEMBERS
    assert chip_smoke.SEPCONV_PER_FORWARD * chip_smoke.OBS_UPDATES == 104
    rows = chip_smoke.aot_rows(updates=2, batch=64, device="cpu")
    assert [tuple(t.shape) for t in rows[0]] == [(64, 5), (64,)]
    assert all(torch.equal(a, b) for r, s in zip(rows, chip_smoke.aot_rows(updates=2, batch=64, device="cpu"))
               for a, b in zip(r, s))


def test_aot_rehearsal_boots_warm_from_the_cache_bit_for_bit(chip_smoke, tmp_path, monkeypatch):
    """The phase's warm-boot checks on the CPU through the portable codec, in-process:
    every member written, the first update of each served by a load, the counters
    reconciled, the states equal to the eager ones; a flipped byte misses that member."""
    from torchmetrics_tpu_torch import aot
    from torchmetrics_tpu_torch import observability as obs
    from torchmetrics_tpu_torch.aot import codecs

    def refuse(exported):
        raise codecs.CodecError("AOTInductor packaging left out of this test")

    monkeypatch.setattr(codecs, "encode_executable", refuse)
    rows = chip_smoke.aot_rows(updates=3, batch=64, device="cpu")
    eager = chip_smoke.obs_collection("cpu")
    for preds, target in rows:
        eager.update(preds, target)
    want = chip_smoke.aot_states(eager)
    cache = str(tmp_path / "cache")

    def boot():
        coll = chip_smoke.obs_collection("cpu")
        with aot.aot_session(cache) as plane, obs.telemetry_session() as rec:
            for preds, target in rows:
                coll.update(preds, target)
            counters = rec.counters.snapshot()
        return counters, plane, chip_smoke.aot_states(coll)

    with aot.aot_session(cache):
        report = chip_smoke.obs_collection("cpu").precompile(*rows[0], tags=chip_smoke.AOT_TAGS)
    assert all(report[m][t]["status"] == "written" for m in chip_smoke.AOT_MEMBERS for t in chip_smoke.AOT_TAGS)
    counters, plane, states = boot()
    members = len(chip_smoke.AOT_MEMBERS)
    assert counters["aot_cache_hits"] == members and counters["jit_compiles"] == 0
    assert chip_smoke.reconciled(counters) and chip_smoke.state_differences(states, want) == {}
    chip_smoke.flip_byte(str(tmp_path / "cache" / (report[chip_smoke.AOT_CORRUPT_MEMBER]["update"]["entry"] + ".aot")))
    counters, plane, states = boot()
    assert counters["aot_cache_misses"] == 1 and plane.stats["corrupt"] == 1 and counters["jit_compiles"] == 1
    assert counters["aot_cache_hits"] == members - 1 and chip_smoke.reconciled(counters) and states == want
    planted = {name: dict(values) for name, values in want.items()}
    planted["confmat"]["confmat"] = [[0]]
    assert list(chip_smoke.state_differences(planted, want)) == ["confmat.confmat"]


def test_streaming_phase_geometry_and_counts(chip_smoke):
    """The streaming phase's cells: a two-stack window of 1,000 is 16 panes of 63, FID's
    windowed path launches sepconv7 260 times, the window boot is a child mode, and the
    phase's batches are seeded."""
    from torchmetrics_tpu_torch.metric import window_stack_geometry

    updates, _, window = chip_smoke.STREAM_LATENCY
    assert window_stack_geometry(window) == (63, 16) and updates > 2 * window
    assert chip_smoke.SEPCONV_PER_FORWARD * chip_smoke.STREAM_FID_UPDATES == 260
    assert chip_smoke.STREAM_FID_UPDATES >= 2 * chip_smoke.STREAM_FID_WINDOW  # two rotations
    assert chip_smoke.parse_aot_child(["chip_smoke.py", chip_smoke.AOT_CHILD_FLAG, "/tmp/c", "window"]) \
        == ("/tmp/c", "window")
    a, b = (chip_smoke.stream_rows(2, batch=32, device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for r, s in zip(a, b) for x, y in zip(r, s))
    assert chip_smoke.STREAM_FID_SPAN == "FrechetInceptionDistance.wdual"


def test_streaming_window_oracle_rehearsal(chip_smoke, monkeypatch):
    """``hold_window`` on the CPU: a dual window of the main path's accuracy passes the
    oracle, and a window whose state was tampered with fails it."""
    from torchmetrics_tpu_torch.streaming import SlidingWindow

    monkeypatch.setattr(chip_smoke, "stream_members", lambda device=None: {
        name: m for name, m in chip_smoke.obs_collection(device="cpu").items(keep_base=True)})
    rows = chip_smoke.stream_rows(9, batch=64, device="cpu")
    window = SlidingWindow(chip_smoke.stream_members()["acc"], 4)
    for preds, target in rows:
        window.update(preds, target)
    held = chip_smoke.hold_window("acc", window, lambda: chip_smoke.stream_members()["acc"], rows)
    assert held["covered"] == 5 and held["value_max_diff"] <= chip_smoke.STREAM_RATIO_ATOL
    window._wstate["tp"] = window._wstate["tp"] + 1
    with pytest.raises(AssertionError, match="window state tp"):
        chip_smoke.hold_window("acc", window, lambda: chip_smoke.stream_members()["acc"], rows)


def test_serving_phase_cells_and_child_modes(chip_smoke):
    """The serving phase's cells: the demo's spill churn (8,000 tenants over 2,048 slots,
    megabatches of 512, 32 events of 10 classes), FID tenants at 128 images a dispatch
    over more tenants than slots, windowed tenants past two rotations; the warm boot is
    an AOT child mode and the quantized phase a sync child mode; the traffic is seeded."""
    assert (chip_smoke.SERVE_TENANTS, chip_smoke.SERVE_CAPACITY, chip_smoke.SERVE_MEGABATCH) == (8000, 2048, 512)
    assert (chip_smoke.SERVE_ROUNDS, chip_smoke.SERVE_ROWS, chip_smoke.SERVE_CLASSES) == (4, 32, 10)
    assert chip_smoke.SERVE_PROBE_MEGABATCHES == (64, 512)
    assert chip_smoke.SERVE_FID_CAPACITY * chip_smoke.SERVE_FID_IMAGES == 128
    assert chip_smoke.SERVE_FID_TENANTS > chip_smoke.SERVE_FID_CAPACITY
    assert chip_smoke.SERVE_WINDOW_UPDATES >= 2 * chip_smoke.SERVE_WINDOW
    assert chip_smoke.parse_aot_child(["chip_smoke.py", chip_smoke.AOT_CHILD_FLAG, "/tmp/c", "serve"]) \
        == ("/tmp/c", "serve")
    a, b = (chip_smoke.serve_traffic(tenants=6, rounds=2) for _ in range(2))
    assert a[0].shape == (2, 6, 32, 10) and a[0].dtype == np.float32 and a[1].dtype == np.int32
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert chip_smoke.QUANT_CODECS == ("bf16", "int8") and chip_smoke.QUANT_FEEDBACK_SYNCS == 8


def test_serving_rehearsal_holds_the_cpu_port(chip_smoke):
    """The churn's checks on the CPU at a small size: spilled and resident tenants equal
    standalone metrics bit for bit, and a planted difference fails."""
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    logits, labels = chip_smoke.serve_traffic(tenants=12, rounds=3)
    engine = ServingEngine(chip_smoke.serve_accuracy(device="cpu"), ServingConfig(capacity=4, megabatch_size=4))
    chip_smoke.serve_feed(engine, logits, labels)
    make = lambda: chip_smoke.serve_accuracy(device="cpu")  # noqa: E731
    assert chip_smoke.serve_hold("accuracy", engine, make, logits, labels, range(12)) > 0
    probe = chip_smoke.serve_probe_engine(make, 4, logits, labels)
    assert probe.stats["dispatches"] == 0 and probe.flush() == 4 and probe.stats["dispatches"] == 1
    slot = engine._tenants[0].slot
    if slot is None:
        engine._tenants[0].spilled["state"]["tp"] = engine._tenants[0].spilled["state"]["tp"] + 1
    else:
        next(iter(engine._classes.values())).stacked["tp"][slot] += 1
    with pytest.raises(AssertionError, match="tenant 0's tp"):
        chip_smoke.serve_hold("accuracy", engine, make, logits, labels, [0])


def test_serving_window_quarantine_and_durability_rehearsals(chip_smoke):
    """The windowed, quarantine and durability parts on the CPU at small sizes."""
    logits, labels = chip_smoke.serve_traffic(tenants=40, rounds=3)
    window = chip_smoke.serve_window_part(logits, labels, device="cpu", updates=10, window=4)
    assert window["tier"] == "dual" and window["rotations"] > 0 and window["vcompute_used"]
    quarantine = chip_smoke.serve_quarantine_part(logits, labels, device="cpu", megabatch=16)
    assert quarantine["quarantined"] == [chip_smoke.SERVE_QUARANTINE_TENANT] and quarantine["peers_bitwise"] == 15
    durability = chip_smoke.serve_durability_part(logits, labels, device="cpu", tenants=24, rounds=3)
    assert durability["replayed"] == 48 and durability["journal_records"] == 72 and durability["snapshot_bytes"] > 0


def test_spill_bound_checker_holds_int8_spills(chip_smoke):
    """The FID part's spill check on float states: every int8 spill of a calibration
    tenant within ``range/510``."""
    from torchmetrics_tpu_torch.classification import MulticlassCalibrationError
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    engine = ServingEngine(MulticlassCalibrationError(5, n_bins=64, validate_args=False, device="cpu"),
                           ServingConfig(capacity=2, megabatch_size=2, spill_codec="int8"))
    ratios = chip_smoke.spill_bound_checker(engine)
    rng = np.random.default_rng(3)
    for t in range(5):
        engine.update(t, rng.normal(size=(64, 5)).astype(np.float32), rng.integers(0, 5, 64).astype(np.int32))
    engine.flush()
    assert ratios and max(ratios) <= 1.0


def test_fid_tenant_hold_tells_a_tenant_from_its_peers(chip_smoke):
    """The FID part's hold on the CPU, on standalone FIDs of seeded uniform-noise images
    (as the phase feeds its tenants) behind a small fixed projection: states a rounding
    off their own pass, states handed to the wrong tenant fail, and tenants too alike for
    the limit to tell apart fail."""
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    gen = torch.Generator().manual_seed(0)
    features = chip_smoke.ProjectionFeatures(torch.randn((3 * 8 * 8, 64), generator=gen) / 8.0)
    features.num_features = 64
    refs = []
    for _ in range(4):
        fid = FrechetInceptionDistance(feature=features, device="cpu")
        fid.update(torch.randint(0, 256, (8, 3, 8, 8), generator=gen, dtype=torch.uint8).float() / 255, real=True)
        fid.update(torch.randint(0, 256, (8, 3, 8, 8), generator=gen, dtype=torch.uint8).float() / 255, real=False)
        refs.append(fid._state)
    rounded = [{k: v * (1 + 1e-4) if v.is_floating_point() else v for k, v in ref.items()} for ref in refs]
    held = chip_smoke.fid_tenant_hold(rounded, refs)
    assert not held["states_bitwise"] and max(held["rel_l2"].values()) < chip_smoke.SERVE_FID_RTOL
    assert min(held["cross_tenant_rel_l2"].values()) > chip_smoke.SERVE_FID_RTOL
    assert chip_smoke.fid_tenant_hold(refs, refs)["states_bitwise"]
    with pytest.raises(AssertionError, match="relative L2"):
        chip_smoke.fid_tenant_hold(refs[1:] + refs[:1], refs)
    with pytest.raises(AssertionError, match="relative L2"):
        chip_smoke.fid_tenant_hold([refs[0]] * 4, [refs[0]] * 4)


def test_quantized_sync_rehearsal_over_a_replayed_world(chip_smoke):
    """The quantized phase's sync helper over two replayed ranks on the CPU: the exact
    and quantized syncs launch as many collectives, the quant event reports its bytes,
    integer states stay bit for bit and float sums within the per-rank bounds."""
    import math as _math

    from test_torch_quantized_sync import QuantWorld

    from torchmetrics_tpu_torch.parallel import SyncConfig

    gen = torch.Generator().manual_seed(5)
    inputs = {"preds": torch.randn((256, 5), generator=gen), "target": torch.randint(0, 5, (256,), generator=gen),
              "real": torch.rand((64, 3, 32, 32), generator=gen), "fake": torch.rand((64, 3, 32, 32), generator=gen),
              "weight": torch.randn((3 * 32 * 32, 2048), generator=gen) / _math.sqrt(3 * 32 * 32),
              "values": torch.randn((128,), generator=gen)}
    colls = [chip_smoke.quant_collection(inputs, device="cpu") for _ in range(2)]
    for rank, coll in enumerate(colls):  # update_quant's shares, at this size
        rows = slice(rank * 128, (rank + 1) * 128)
        for name in ("acc", "f1", "confmat"):
            coll[name].update(inputs["preds"][rows], inputs["target"][rows])
        coll["fid"].update(inputs["real"][rank * 32:(rank + 1) * 32], real=True)
        coll["fid"].update(inputs["fake"][rank * 32:(rank + 1) * 32], real=False)
        coll["mean"].update(inputs["values"][rank * 64:(rank + 1) * 64])
    states = [[dict(m._state) for m in coll.values()] for coll in colls]
    reds = [dict(m._reductions) for m in colls[0].values()]
    exact, exact_stats = chip_smoke.quant_sync_once(states[0], reds, gather=QuantWorld(states, reds))
    for codec in chip_smoke.QUANT_CODECS:
        configs = [SyncConfig(codec=codec) for _ in range(2)]
        synced, stats = chip_smoke.quant_sync_once(states[0], reds, configs[0], gather=QuantWorld(states, reds, configs))
        assert stats["collectives"] == exact_stats["collectives"] and stats["quant"]["shipped_bytes"] > 0
        for i, (got, want) in enumerate(zip(synced, exact)):
            for key, value in want.items():
                if not value.is_floating_point():
                    assert torch.equal(got[key], value)
                    continue
                bound = sum(chip_smoke.quant_bound(codec, s[i][key]) for s in states) + chip_smoke.QUANT_STATE_EPS
                assert float((got[key].double() - value.double()).abs().max()) <= bound


def test_chaos_and_fleet_phase_geometry_and_published_configs(chip_smoke, tmp_path):
    """The phases' configs as they build them: ``bench.py``'s three published soaks
    field for field, the scale soak on the serving phase's geometry, the fleet's schedule
    on it, and the CPU child's mode."""
    c = chip_smoke.soak_config("production_soak")
    assert (c.traffic.seed, c.traffic.tenants, c.traffic.steps, c.capacity, c.megabatch_size, c.spill_codec,
            c.sync_codec, c.max_tenants_per_sec, c.faults) == (23, 24, 120, 8, 4, "int8", "bf16", 40.0, None)
    d = chip_smoke.soak_config("durable_failover", str(tmp_path))
    assert (d.traffic.seed, d.spill_codec, d.snapshot_every, d.failover_at, d.journal_fsync_every,
            d.durability_dir) == (31, "none", 30, 70, 1, str(tmp_path))
    f = chip_smoke.soak_config("fleet_failover", str(tmp_path))
    assert (f.traffic.seed, f.fleet_hosts, f.capacity, f.megabatch_size, f.snapshot_every, f.journal_fsync_every,
            f.spill_codec) == (37, 3, 12, 4, 20, 1, "none")
    assert [(s.step, s.kind, s.target) for s in f.faults] == [(40, "host_loss", "host-1"), (80, "host_join", None)]
    s = chip_smoke.soak_config("scale")
    assert (s.traffic.tenants, s.traffic.shape_classes, s.traffic.num_classes, s.capacity, s.megabatch_size) == (
        chip_smoke.SERVE_TENANTS, (chip_smoke.SERVE_ROWS,), chip_smoke.SERVE_CLASSES, chip_smoke.SERVE_CAPACITY,
        chip_smoke.SERVE_MEGABATCH)
    assert (s.traffic.seed, s.traffic.steps, s.traffic.base_rate, s.traffic.churn_every, s.traffic.churn_count,
            s.spill_codec, s.sync_codec, s.max_tenants_per_sec) == (23, 120, 64.0, 30, 256, "int8", "bf16", 320.0)
    fs = chip_smoke.soak_config("fleet_scale", str(tmp_path))
    assert fs.traffic == s.traffic and fs.faults.specs == f.faults.specs
    assert (fs.fleet_hosts, fs.capacity, fs.megabatch_size, fs.snapshot_every) == (3, 2048, 512, 20)
    assert chip_smoke.CHAOS_PUBLISHED == ("production_soak", "durable_failover", "fleet_failover")
    assert (chip_smoke.FLEET_FID_TENANTS, chip_smoke.FLEET_FID_MIGRATED) == (9, 2)
    assert chip_smoke.CHAOS_PHASE_LIMIT_S == 90 and chip_smoke.FLEET_PHASE_LIMIT_S == 120
    with pytest.raises(ValueError, match="no soak config"):
        chip_smoke.soak_config("nope")


def test_the_soak_children_are_modes_of_the_script(chip_smoke, monkeypatch):
    """``--chaos-child`` (the CPU's reference) runs where there is no card;
    ``--soak-child`` is the phases' card work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag, name in ((chip_smoke.CHAOS_CHILD_FLAG, "chaos_child"), (chip_smoke.SOAK_CHILD_FLAG, "soak_child")):
        monkeypatch.setattr(chip_smoke.sys, "argv", ["chip_smoke.py", flag])
        monkeypatch.setattr(chip_smoke, name, lambda: 7)
        assert chip_smoke.main() == 7


def _small_soaks(chip_smoke, monkeypatch):
    """The published configs at a third of their traffic (the schedules unchanged)."""
    import dataclasses

    full = chip_smoke.soak_config
    monkeypatch.setattr(chip_smoke, "soak_config", lambda name, root=None: dataclasses.replace(
        full(name, root), traffic=dataclasses.replace(full(name, root).traffic, base_rate=1.5, tenants=12)))


def test_chaos_rehearsal_holds_its_gates_and_a_batch_folded_twice_fails(chip_smoke, monkeypatch, tmp_path):
    """The chaos phase's soaks on the CPU at a small size pass their gates; a run in which
    one admitted batch folds twice differs from the clean run's blocks and fails."""
    from torchmetrics_tpu_torch.serving import ServingEngine

    _small_soaks(chip_smoke, monkeypatch)
    published = chip_smoke.chaos_published(str(tmp_path), device="cpu")
    assert published["summary"]["production_soak"]["unrecovered_faults"] == 0
    assert published["summary"]["durable_failover"]["failover_state_parity"] == 1.0
    traffic = dict(chip_smoke.CHAOS_SCALE_TRAFFIC, tenants=64, steps=40, base_rate=6.0, churn_count=8)
    soak = dict(chip_smoke.CHAOS_SCALE_SOAK, capacity=16, megabatch_size=8, max_tenants_per_sec=24.0)
    scale = chip_smoke.chaos_scale(device="cpu", traffic=traffic, soak=soak)
    assert scale["unrecovered_faults"] == 0 and scale["spills"] > 0 and 0 < scale["shed_rate"] < 1
    clean = chip_smoke.soak_blocks(published["production_soak"])
    update, folded = ServingEngine.update, []

    def twice(self, tenant_id, *args, **kwargs):
        ok = update(self, tenant_id, *args, **kwargs)
        if ok and not folded:
            folded.append(tenant_id)
            update(self, tenant_id, *args, **kwargs)
        return ok

    monkeypatch.setattr(ServingEngine, "update", twice)
    planted = chip_smoke.run_soak_quietly(chip_smoke.soak_config("production_soak"), device="cpu")
    with pytest.raises(AssertionError, match="counters differs"):
        chip_smoke.hold_soak_blocks("chaos", chip_smoke.soak_blocks(planted), clean)


def test_fleet_rehearsal_holds_its_gates_and_a_flipped_migrated_leaf_fails(chip_smoke, monkeypatch, tmp_path):
    """The fleet phase's soaks and its FID fleet on the CPU at a small size (a fixed
    projection for the trunk) pass their gates; a migrated tenant whose leaf flips on its
    new host fails the part."""
    from torchmetrics_tpu_torch.fleet import FleetController

    _small_soaks(chip_smoke, monkeypatch)
    report, line = chip_smoke.fleet_soak(chip_smoke.soak_config("fleet_failover", str(tmp_path / "f")), "fleet",
                                         device="cpu")
    assert line["fleet_failover_parity"] == 1.0 and line["host_failovers"] == 1
    assert line["rto_ms"] == report.timing["failover_rto_ms"] > 0  # the soak times its failover itself
    gen = torch.Generator().manual_seed(0)
    features = chip_smoke.ProjectionFeatures(torch.randn((3 * 8 * 8, 64), generator=gen) / 8.0)
    features.num_features = 64
    images = torch.randint(0, 256, (3, chip_smoke.FLEET_FID_TENANTS, 8, 3, 8, 8), generator=gen, dtype=torch.uint8)
    make = lambda: chip_smoke.reliability_fid(features, device="cpu")  # noqa: E731
    fid, launches = chip_smoke.fleet_fid_part(make, images, str(tmp_path / "fid"))
    assert launches == 0 and fid["stats"]["failovers"] == 1 and fid["stats"]["migrated_tenants"] == 2
    assert fid["killed_tenants"] and set(fid["migrated"]) <= set(fid["killed_tenants"])
    assert max(fid["rel_l2"].values()) <= chip_smoke.SERVE_FID_RTOL
    migrate = FleetController.migrate

    def flipped(self, tenants, dst, _stage_hook=None):
        out = migrate(self, tenants, dst, _stage_hook)
        t = self._hosts[dst].engine._tenants[tenants[0]]
        name = sorted(t.spilled["state"])[0]
        t.spilled["state"][name] = t.spilled["state"][name] + 1
        return out

    monkeypatch.setattr(FleetController, "migrate", flipped)
    with pytest.raises(AssertionError, match="changed their digests"):
        chip_smoke.fleet_fid_part(make, images, str(tmp_path / "planted"))
