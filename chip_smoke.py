"""On-card smoke run of the PyTorch/CUDA port, ``torchmetrics_tpu_torch``, on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each, in order:

1. build: compile the port's CUDA kernel (``sepconv7``) from ``torchmetrics_tpu_torch/csrc/``
   with nvcc for ``sm_90a``, and report the seconds, ptxas's registers, shared memory and
   spills for each instantiation (bf16 and f32, both on the tensor cores), the dynamic
   shared memory of each, and the wgmma (``HGMMA``) instructions in the built SASS by
   opcode form; the SASS must hold both the BF16 and the TF32 forms and no kernel that
   the report does not name.
2. kernel: hold ``sepconv7`` against its plain PyTorch version at the shapes the
   InceptionV3 trunk gives it (B=512 in bf16 and f32, B=64 in f32; 17x17; both axes);
   time the kernel, the plain version and ``F.conv2d`` (the library yardstick). Then
   edge cases that reach every tail of the kernels, in both dtypes and on both axes:
   C not a multiple of 8, O not a multiple of the O-tile, B=1 and B=3, non-square
   planes, and a plane whose lines do not fit one tile.
3. fid: ``FrechetInceptionDistance(feature=InceptionV3Features(...), normalize=True)`` on
   299x299 images, bf16 trunk at batch 512 and f32 trunk at batch 64: images/s, exactly 26
   kernel launches per trunk forward, a finite ``compute()``, and the card's features
   held against the CPU's on a small input.
4. classification: the fused step ``MetricCollection({acc, f1, confmat}).as_pure().apply``
   with 5 classes at batch 65536, held against the same step on the CPU.
5. binary_segmentation: binary-mask evaluation on float32 logits of 32x512x512 with
   ``ignore_index=255`` on about 5% of the pixels: ``BinaryStatScores(multidim_average=
   "samplewise")`` and the fused ``{BinaryAccuracy, BinaryF1Score, BinaryConfusionMatrix}``
   step.
6. multilabel: the fused ``{MultilabelAccuracy, MultilabelF1Score(average="macro"),
   MultilabelConfusionMatrix}`` step at batch 65536 over 80 labels (COCO's label count),
   on probabilities and on logits, so both branches of the batch-wide sigmoid run.
7. topk_ties: ``MulticlassStatScores(num_classes=5, top_k=2, average="none")`` at batch
   65536 on scores in quarters, where ties are common: top-k ties must go to the lower
   index, as in the JAX package.
8. sync_nccl: an NCCL process group of one process on the card. The main path's states
   at full width (the ``{acc, f1, confmat}`` collection after an update at batch 65536,
   the FID metric of phase 3's f32 trunk with its two 2048x2048 covariance sums, a
   ``CatMetric``, a ``MeanMetric`` and a ``MaxMetric``) go through
   ``MetricCollection.sync`` (coalesced), ``unsync`` and ``PureCollection.reduce``. At a
   world of one every synced and reduced value must equal the local one bit for bit,
   and ``unsync`` must restore the states. It prints ``sync_ms`` and ``reduce_ms``
   (median of 20, host clock around synchronised calls), the metadata round trip, the
   bytes shipped and the collectives ``collective_counts`` predicts; one more sync under
   ``torch.profiler`` must show exactly the predicted coalesced collectives.
9. sync_two_ranks: two processes on the one card over gloo (NCCL puts no two ranks on
   one device), with the metrics on the card. Each rank updates its half of the data:
   the classification collection at batch 65536, FID states at 2048 features from a
   fixed random projection (no trunk), a ``CatMetric`` whose rank 1 takes 7 rows fewer,
   a ``MeanMetric`` and a ``MaxMetric``. Each rank's ``compute()`` must equal the same
   metrics over the whole batch in this process: counts, max and cat values bit for bit,
   ratios within 1e-6, FID within ``FID_RTOL`` relative. It prints ``sync_ms`` per rank.

10. detection_accumulate: COCO val2017 at scale, made from a seed (5000 images, 80 classes,
   100 detections and 1-14 ground truths per image): ``PaddedDetectionAccumulator(5000,
   100, 100)`` on the card (26.0 MB) fed 32 images per update, 157 updates, with
   ``torch.cuda.set_sync_debug_mode("error")`` around every update (no host sync); the
   unpacked rows must give back the inputs, and a clamped overflow must equal the CPU's
   state bit for bit.
11. map_host: ``MeanAveragePrecision()`` on the 5000 images, matcher on the card,
   ``compute()`` once, its seconds split into numpy (rows, IoU, accumulation) and the
   matcher; the matcher's outputs on the first 500 images must equal the CPU's bit for bit.
12. map_device: ``DeviceMeanAveragePrecision(capacity=524288, num_classes=80,
   gt_group_cap=32)`` (31.5 MB of state) on the same images: update ms, ``compute()`` ms
   and its device time; every summary value within 1e-4 of map_host's.
13. flagship: the flagship step (``Flagship``, the port's ``_flagship_step_fn``) at full
   width in an NCCL group of one process: per step 65,536 classification rows over 5
   classes, 32 detection images and 32 real and 32 fake 299x299 images through the bf16
   trunk, 157 steps to fill the COCO-size accumulator; step ms, the sync's ms and
   collectives (traced against ``collective_counts``), the finalize seconds. ``map`` must
   equal map_host's, acc and f1 the CPU port's, FID finite.
14. flagship_two_ranks: the flagship over two gloo processes on the card, each with half
   of 500 images, 65,536 rows and the FID images of phase 9 (a projection extractor);
   each rank's finalized acc, f1 and map must equal a world of one's, FID within 1e-3.
15. generative: ``KernelInceptionDistance(subsets=100, subset_size=1000, seed=0)``,
   ``MemorizationInformedFrechetInceptionDistance()`` and ``InceptionScore(splits=10,
   seed=0)`` (the trunk followed by a seeded 2048 -> 1008 linear head) behind one bf16
   trunk (seeded weights at He's scale, so the features are not degenerate), on 2048 real and 2048 fake uint8 299x299 images (fake = real plus seeded
   noise) in batches of 512 (users evaluate 10k-50k images; cut to keep the CPU
   reference short): update images/s and ``compute()`` seconds for each, every value
   finite and within 1e-6 relative of the port on the CPU on the same states (the
   float64 difference reported too), 26 sepconv7 launches per trunk forward, KID's
   ``compute()`` under ``torch.profiler`` beside its FP64 bound, and KID's update with a
   projection extractor under ``torch.cuda.set_sync_debug_mode("error")``.
16. collection_groups: the stateful ``MetricCollection({acc, precision, recall, f1,
   confmat})`` at batch 65536 over 5 classes, 20 updates, with compute groups and
   without: update ms (median, host clock around synchronised calls) and, under
   ``torch.profiler``, launches and device ms per update. The groups must be
   ``{acc, f1, precision, recall}`` and ``{confmat}``; both builds' counts equal bit for
   bit and the CPU port's; ``forward`` gives the batch's values; a ``state_dict`` round
   trip computes the same values and a truncated one raises ``StateCorruptionError``;
   ``(acc + f1) / 2`` is the mean of the two; a clone stays independent; in an NCCL
   group of one, the grouped sync ships each distinct state dict once (its traced
   collectives equal the prediction from the distinct dicts) and the members alias
   through ``sync`` and ``unsync``.
17. classification_tower: ``MulticlassJaccardIndex`` (macro, ``ignore_index=0``),
   ``MulticlassMatthewsCorrCoef`` and ``MulticlassCohenKappa(weights="quadratic")`` at batch
   65536 over 5 classes, ``MulticlassExactMatch`` on (4096, 16) multidim labels, and
   ``MultilabelJaccardIndex``, ``MultilabelMatthewsCorrCoef`` and ``MultilabelExactMatch``
   at 65536 x 80: update and compute ms (median of 10, host clock around synchronised
   calls); states equal to the CPU port's bit for bit, values within 1e-6; a second run
   with ``torch.backends.cuda.matmul.allow_tf32 = True`` (restored after) equal bit for
   bit.
18. curves: CTR-style binary scores (4,194,304 in 16 updates, about 3% positive, rounded
   to thousandths) through ``BinaryAUROC``, ``BinaryAveragePrecision``, ``BinaryROC`` and
   ``BinaryPrecisionRecallCurve``, exact and at 200 thresholds, and ``BinaryAUROC(max_fpr=
   0.1)``; ImageNet validation-size softmax rows (50,000 x 1,000 in 50 updates) through
   ``MulticlassAUROC`` and ``MulticlassAveragePrecision``, exact and at 100 thresholds, and
   the binned ``MulticlassROC(average="macro")``. Per metric: update ms (median and mean),
   compute ms (first and second call), state bytes. Every state equals the CPU port's bit
   for bit, exact thresholds too, values within 1e-6; one binned ImageNet update must take
   less than 100 MB beyond its inputs, and the exact ImageNet AUROC ``compute()`` (profiled)
   fewer than 200 launch calls. Edge cases on the card against the CPU: scores with NaN and
   zeros of both signs, an unsorted list of thresholds with a repeat, a class and a label
   without positives, NaN in the same places.
19. tower_tail: on the curves phase's data, ``BinaryCalibrationError(n_bins=15)`` (norms
   l1, l2 and max) on the CTR probabilities in 16 updates, ``MulticlassCalibrationError``
   on the ImageNet softmax rows in 50, ``BinaryHingeLoss`` on the CTR logits and
   ``MulticlassHingeLoss`` (crammer-singer and one-vs-all) on the ImageNet logits;
   ``MultilabelCoverageError``, ``MultilabelRankingAveragePrecision`` and
   ``MultilabelRankingLoss`` on the classification_tower phase's 65,536 x 80 multilabel
   scores in one update; ``BinaryFairness`` and ``BinaryGroupStatRates`` (threshold 0.05)
   on the CTR probabilities with 8 seeded groups of weights 1, 1/2, ..., 1/8. Per metric:
   update ms (median) and compute ms (first and second call). States equal to the CPU
   port's bit for bit, but the float sums (calibration's confidence and accuracy sums,
   hinge and ranking measures) within 1e-6 relative; values within 1e-6 relative; each
   ranking update under 1 GB beyond its inputs (``torch.cuda.max_memory_allocated``); a
   rerun of the ranking and multiclass hinge metrics with TF32 matmuls allowed equal bit
   for bit. A profile line for five of the updates.
20. curve_points: ``BinaryEER``, ``BinaryLogAUC`` (default range and (0.01, 0.5)) and the
   four binary operating points on the CTR states of phase 18, exact and at 200
   thresholds; their multiclass counterparts on the ImageNet states, exact and at 100
   thresholds, EER and LogAUC per class and macro (the exact macro EER left out: see
   ``MACRO_EER_NOTE``). The states are taken from phase 18's metrics, on the card and
   on the CPU, so no update runs again. Every chosen threshold equals the CPU port's bit
   for bit and every value is within 1e-6; the exact ImageNet EER, LogAUC and
   ``recall_at_fixed_precision`` computes are profiled, each under 200 launch calls.
   Edge rows from ``curve_edge_inputs`` (scores and scores in quarters, exact and with an
   unsorted list of thresholds holding 1.0): ties on the objective, NaN precision, a
   class without positives, whose operating points fall back to (0, NaN) and (0, 1e6).
21. regression: an M5-shaped demand forecast (30,490 item-store series x 28 days in 28
   updates, 68% zero sales, the rest 1 + a gamma count, positive forecasts) through MSE,
   RMSE, MAE, MAPE (the zeros hit its 1.17e-6 clip), SMAPE, WMAPE, MSLE, log-cosh,
   Minkowski (p=3), Tweedie (power 1.5), R2, RSE, explained variance, NRMSE in its four
   normalizations, Pearson and Spearman (853,720 points, a 68% tie run); a WeatherBench-2-
   shaped verification (z500, t850, t2m and u10 on the 1.5-degree grid, 29,040 points, as
   ``num_outputs=4``, 64 initialisations) through Pearson, concordance, R2 (raw values,
   variance weighted), explained variance and NRMSE (std, range); CRPS of a 50-member
   ensemble on the 0.25-degree grid (1,038,240 points, 2 updates); CSI at 1, 4 and 8 mm/h
   on 16 x 18 x 256 x 256 radar nowcasts in 4 updates, summed and per lead time. Every
   state is float32 and held against the CPU port over the same batches: bit for bit, but
   the float sums and values of the metrics in ``TRANSCENDENTAL`` within 1e-6 relative
   (absolute below magnitude 1); Spearman's ranks bit for bit; values within 1e-6
   relative, R2's and explained variance's within 1e-6 times their cancellation
   ``kappa``. A CRPS update under 1 GB beyond its inputs; R2 and RSE unchanged bit for bit
   with TF32 matmuls allowed; profile lines for the M5 sum-state update, one CRPS update,
   one weather Pearson update and the Spearman compute.
22. correlation: Kendall (b with the t-test, and c) on 32,768 (metric score, human score)
   pairs with tied human scores in 8 updates; ``CosineSimilarity`` (mean, none) on
   65,536 x 768 embedding pairs in 16 updates; KL and Jensen-Shannon divergence (mean,
   none; probabilities and log-probabilities) on 50,000 x 1,000 teacher and student
   softmax rows in 50 updates. Held as in phase 21; Kendall's pair counts equal the CPU's
   bit for bit, also on 1,000 pairs with NaN and infinities; the Kendall compute under
   1 GB beyond its inputs and, profiled, under 500 launch calls; Kendall and cosine
   similarity unchanged bit for bit with TF32.
23. moments_two_ranks: two gloo ranks on the card (``--sync-child ... moments``) update
   Pearson, concordance, NRMSE (std) and R2 over uneven shares (40 and 24) of phase 21's
   weather initialisations; each rank's synced ``compute()`` (the stacked moments folded
   in rank order) within 1e-6 relative of the whole data's in this process.
24. wrappers: ``BootStrapper(MulticlassAccuracy(num_classes=1000), num_bootstraps=100,
   sampling_strategy="multinomial", quantile=[0.025, 0.975])`` on 50,000 x 1,000 ImageNet
   logits in 50 updates of 1,000 rows, which must take the stacked path (one gather of
   100 x 1,000 x 1,000 float32 an update), and 20 Poisson replicas on the list path: the
   replica states equal the CPU port's bit for bit after its first 5 updates, and the
   mean, std and quantiles within 1e-6; update ms, and under ``torch.profiler`` one
   update's launch calls and idle share, and its peak extra bytes.
   ``FeatureShare([FID, KID, MiFID])`` on one bf16 ``InceptionV3Features`` trunk,
   ``normalize=False``, uint8 299x299 batches of 128 that start on the host: exactly 26
   sepconv7 launches a shared update, each member's states equal to the same metric's
   fed alone through the trunk, bit for bit, and images/s shared against the three
   alone. ``ClasswiseWrapper`` (1,000 keys), ``MetricTracker`` over 3 epochs
   (``best_metric`` must give a value and a step), ``MinMaxMetric`` and
   ``Running(window=5)`` on the ImageNet logits, ``MultioutputWrapper(PearsonCorrCoef(),
   num_outputs=4)`` on the weather fields with 1% of the rows NaN,
   ``MultitaskWrapper({"cls": BinaryAccuracy, "reg": MeanSquaredError})`` and
   ``BinaryTargetTransformer`` on the CTR scores: every value equal to the CPU port's,
   counts bit for bit, ratios within 1e-6.
25. panoptic: ``PanopticQuality`` (with sq and rq) and ``ModifiedPanopticQuality`` on
   COCO-panoptic-shaped segment maps from a seed (133 categories: 80 things, 53 stuff;
   480x640; 1-30 segments an image; 5% void), a prefix of 64 of val2017's 5,000 images
   in updates of 16: the states on the card, equal to the CPU port's bit for bit, and
   the values (PQ's per class too) equal; update ms and the host's share of it (the
   statistics are host numpy).
26. retrieval: an MS MARCO passage dev-small re-ranking run from a seed: 6,980 sparse
   query ids (int64 on the host, int32 states) x 1,000 BM25 candidates in 70 updates of
   100 queries, 1-3 judged passages a query (about 14% of the queries without one among
   the candidates), cross-encoder logits in bfloat16 (a tie share within a query is
   reported; a few queries carry exact +0.0 and -0.0). MRR@10, MAP, MAP (median, skip),
   NDCG@10, precision@10, recall@100, hit rate@10, fall-out@10, R-precision, AUROC, the
   PR curve at k <= 100 and recall at precision 0.05: the states and the padded layout
   equal to the CPU port's bit for bit, values within 1e-6 relative (1e-7 absolute below
   0.1), ``ks`` and ``best_k`` equal; a TREC DL 2019-shaped set (43 x 1,000, graded
   gains) through NDCG at 10 and at full depth; ``RetrievalAUROC(max_fpr=0.1)`` on the
   first 256 queries (ms a query); edge queries (+-0.0, NaN, +-inf scores, one document,
   all positive, all negative under each empty-target action, ignored targets, top-k
   beyond a query, ``adaptive_k``, the median of an even count) on the card and the CPU.
   Update and compute ms, a compute's peak extra bytes, state bytes; the NDCG@10 and MAP
   computes profiled.
27. segmentation: Cityscapes val from a seed (500 frames of 1024 x 2048, 19 classes,
   index input, batches of 8, void 255 on about 10% of the target): ``MeanIoU`` (mean
   and per class), ``DiceScore(average="macro")`` and ``GeneralizedDiceScore``; the
   states after the first two updates held against the CPU port (counts bit for bit,
   float sums within 1e-6), values within 1e-6, the mIoU in [0.6, 0.8]; small edge
   inputs (an absent class, logits with argmax ties, multi-hot one-hots, the background
   in and out, anisotropic 3-D spacing, the three distances) on the card and the CPU.
   Update ms and frames/s, a profiled update, each metric's peak extra bytes, the bytes
   an update reads.
28. segmentation_3d: BraTS 2021-shaped volumes from a seed (16 of 240 x 240 x 155 at
   1 mm, updates of 2; nested noisy ellipsoids; predictions shifted, scaled and with
   stray blobs): ``DiceScore(4, include_background=False, average="none")`` and the
   directed euclidean ``HausdorffDistance`` over the gathered edge voxels; the first
   update's states equal to the CPU port's bit for bit. Hausdorff ms an update, edge
   voxels per (volume, class), distances evaluated, host reads an update (counted by
   ``torch.cuda.set_sync_debug_mode``), a profiled update.
29. pairwise: dense-retrieval query and passage embeddings from a seed (8,192 x 768
   against 8,192 x 768, float32): cosine, linear and euclidean (float64 products rounded
   once, in row blocks), manhattan and minkowski (p = 3; float64 differences in row
   blocks under 256 MiB), each with ``reduction=None`` and ``"mean"``, and each on the
   first 4,096 queries against themselves (``y=None``, the diagonal zeroed). Every result
   finite; the products rerun with TF32 matmuls allowed equal bit for bit; the first
   256 rows (64 for manhattan and minkowski) within 4 float32 rounding units of the
   terms of the CPU port's; each call under 1 GB beyond its output. Call ms; the cosine
   and the self manhattan calls profiled.
30. procrustes: PA-MPJPE-style evaluation of 65,536 seeded 17-joint 3-D poses (Human3.6M's
   layout; rotated, scaled, shifted and noisy predictions; 1% planar, whose rotation is
   not unique) through ``ProcrustesDisparity("mean")`` and ``("sum")`` in 16 updates of
   4,096, and ``procrustes_disparity(..., return_all=True)`` over all of them: states and
   values within 1e-6 relative (1e-7 absolute below 0.1) of the CPU port's; the rotation
   within 1e-6 over the singular gap where the singular values are 1e-3 apart, and
   elsewhere giving the CPU's disparity; a second run of the updates under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host read) with equal states. The same
   updates with the SVD taken by ``torch.linalg.svd`` (the states within the value
   tolerance, update ms, host reads, both SVDs alone on one batch, a profiled update);
   4,096 clouds of 64 points 16 wide (an embedding-space alignment, whose SVD is
   ``torch.linalg.svd``'s) held against the CPU port as the poses are. Update and compute
   ms, host reads, an update's peak extra bytes, a profiled update.
31. nominal: a UCI Adult-shaped table (48,842 rows x 8 categorical columns of 9, 16, 7,
   15, 6, 5, 2 and 42 categories, skewed, 1% NaN) through the four ``_matrix`` forms
   under ``nan_strategy`` "replace" and "drop" (every column pair's table bit for bit,
   the matrices within the value tolerance of the CPU port's); ``CramersV``,
   ``PearsonsContingencyCoefficient``, ``TheilsU`` and ``TschuprowsT`` on education
   against occupation in 8 updates; ``FleissKappa`` on a crowd-labelling set (10,000
   items x 5 categories x 5 raters) in "probs" and "counts" modes in 10 updates: states
   bit for bit, values within tolerance; ``torch.argmax`` on the card equal to numpy's on
   ties and NaNs (the updates' collapse of probabilities). Update, compute and matrix ms,
   host reads of an update, a profiled update and matrix run.
32. clustering: k-means evaluation of ImageNet-val-shaped embeddings from a seed (50,000
   samples, 1,000 classes of 50 against 1,000 clusters of uneven size, 768-wide float32
   embeddings around the cluster centres) in 50 updates of 1,000, through all 13
   clustering classes (``ClusterAccuracy(1000)`` with them): the contingency's nonzero
   cells, margins and pair sums bit for bit against the CPU port's, values within the
   value tolerance (AMI absolutely), each compute under 1 GB beyond its states. Update
   and compute ms, the expected mutual information's term count, the AMI and
   Davies-Bouldin computes profiled.

Phases 5-7 hold every result against the same port on the CPU on the same tensors:
counts (tp/fp/tn/fn, confusion matrices) equal bit for bit, ratios within 1e-6. Their
lines carry ``step_ms`` (host clock around synchronised steps) and the card.

After each FID trunk, after the classification, binary and multilabel steps, after
the NCCL sync, after KID's compute, after the collection's update and sync and after an
exact AUROC compute of each curves workload, a profile line: one more step under
``torch.profiler``, with device time by kernel and the device's idle share (for the sync
also the collectives the trace names, and the device time of NCCL's spans and of the
copies).

Then the card's name and power limit (nvidia-smi), the kernels line and the result line.
Any failed check raises, so the script exits non-zero and prints no result line. Without
CUDA it exits with code 2.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (dense), by the type the tensor cores run: bf16, and TF32 for
# float32, which takes three TF32 products (hi and lo split operands) per product.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
PRODUCTS = {torch.bfloat16: 1, torch.float32: 3}
PEAK_BYTES_PER_S = 3.35e12
# bf16 outputs are rounded once from f32 sums: half a bf16 ulp is 0.0156 for |y| < 8,
# the bound docs/pallas_conv_experiment.md:15 states for the TPU kernel.
ERR_LIMIT = {torch.bfloat16: 0.016, torch.float32: 1e-4}
# the bf16 trunk's features against the f32 trunk's on the CPU, relative L2
# (tests/test_torch_inception.py's bound)
TRUNK_BF16_L2 = 2e-2
SEPCONV_PER_FORWARD = 26
SPATIAL = 17
# profile_step: the launches that open each trace, the host pause after them, and the
# name of the step's range
PROFILE_LEAD_LAUNCHES = 64
PROFILE_MARGIN_S = 0.05
PROFILE_RANGE = "chip_smoke.profile_step"
# (B, C, O, H, W): C=12 is not a multiple of 8 and O=24 not one of the O-tile; 17x13 and
# 5x30 are not square; a 64x64 plane's lines do not fit one tile along either axis, and 12
# such images make 156 tiles, so on 132 SMs the last wave runs as half tiles
EDGE_CASES = ((3, 12, 24, 17, 17), (1, 160, 192, 17, 13), (2, 40, 24, 5, 30), (12, 64, 64, 64, 64))
# the kernels of csrc/sepconv7.cu by dtype path, for the ptxas report
INSTANTIATIONS = {"sepconv7_bf16_kernel": "bf16 (wgmma)", "pack_weights_bf16_kernel": "bf16 (weight pack)",
                  "sepconv7_tf32_kernel": "f32 (wgmma, 3xTF32)",
                  "pack_weights_tf32_kernel": "f32 (weight pack, TF32 hi and lo)"}


@functools.lru_cache(maxsize=1)
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def emit(obj) -> None:
    """One JSON line; a phase's line carries the card's name and power limit."""
    if "phase" in obj and "card" not in obj:
        obj = {**obj, "card": card_line()}
    print(json.dumps(obj), flush=True)


def trunk_sepconv_shapes():
    """(C, O, axis) of the trunk's 26 separable convs, in forward order: three 1x7 and
    three 7x1 in each of Mixed_6b-6e (c7 = 128, 160, 160, 192), one of each in Mixed_7a."""
    shapes = []
    for c7 in (128, 160, 160, 192):
        shapes += [(c7, c7, "W"), (c7, 192, "H"), (c7, c7, "H"), (c7, c7, "W"), (c7, c7, "H"), (c7, 192, "W")]
    return shapes + [(192, 192, "W"), (192, 192, "H")]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_step(label: str, step, tries: int = 4, extra=None) -> list:
    """Run ``step`` once under ``torch.profiler``: device time by kernel name, the
    sepconv7 launches' share of it, and the device's idle share of the step's wall time
    (the wall time less the union of the spans in which a kernel, copy or set ran).

    A trace can lose the device events of its first launches: late in a long run, the
    first 1 to 12 launches of each trace, within about a millisecond, and once all 35 of
    a 3 ms step in three traces. So each trace opens with ``PROFILE_LEAD_LAUNCHES`` tiny
    launches and a host pause of ``PROFILE_MARGIN_S``, and only the step's own events
    count: the host events inside its ``record_function`` range and the device events
    that start after the pause began. A trace with fewer kernels than the step's
    kernel-launch calls is taken again, up to ``tries`` times; the line reports the
    fullest trace, both its counts, the attempts and the launches it lost (the op that
    made each, and when, in ms after the step's first launch). Where no trace holds a
    device event of the step, the device time comes from CUDA events around one more
    call, and the busy time and idle share are null. Returns the step's events of the
    reported trace; ``extra(events)`` adds keys to the line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    lead = torch.zeros(1, device="cuda")
    best = None
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD_LAUNCHES):
                lead.add_(1)
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
            start = time.perf_counter()
            with record_function(PROFILE_RANGE):
                step()
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - start) * 1e6
        events = step_events(prof.events())
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                       if e.device_type == DeviceType.CUDA)
        launches = [e for e in events if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name]
        kernel_events = sum(1 for _, _, name in spans if not name.startswith(("Memcpy", "Memset")))
        if best is None or kernel_events > best[0]:
            best = (kernel_events, launches, wall_us, spans, events)
        if kernel_events >= len(launches):
            break
    kernel_events, launches, wall_us, spans, events = best
    if not launches and not spans:
        raise AssertionError(f"profile {label}: the profiler recorded no event of the step in {tries} traces")
    line = {"phase": "profile", "step": label, "wall_ms": wall_us / 1e3, "kernel_events": kernel_events,
            "launch_calls": len(launches), "attempts": attempt, "lost": lost_launches(events, launches)}
    if not spans:
        line.update(device_busy_ms=None, idle_share=None, device_ms=None, sepconv7_ms=None, top=[],
                    device_ms_by_events=cuda_ms(step, iters=1, warmup=0),
                    trace=f"no device event of the step in {tries} traces")
        emit({**line, **(extra(events) if extra else {})})
        return events
    busy_us, reach, by_name = 0.0, -math.inf, {}
    for begin, end, name in spans:
        busy_us += max(0.0, end - max(begin, reach))
        reach = max(reach, end)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - begin, count + 1)
    top = sorted(by_name.items(), key=lambda item: -item[1][0])[:12]
    emit({**line, "device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / wall_us,
          "device_ms": sum(total for total, _ in by_name.values()) / 1e3,
          "sepconv7_ms": sum(total for name, (total, _) in by_name.items() if "sepconv7" in name) / 1e3,
          "top": [[name[:100], total / 1e3, count] for name, (total, count) in top],
          **(extra(events) if extra else {})})
    return events


def step_events(events) -> list:
    """The events of a ``profile_step`` trace that belong to the step: the host events
    inside the ``PROFILE_RANGE`` range, and the device events that start after the
    middle of the pause before it (the lead launches finished before the pause), less
    the device copies of host ranges (``record_function``'s, c10d's), which are spans
    of no device work."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name == PROFILE_RANGE and e.device_type == DeviceType.CPU]
    if len(marks) != 1:
        raise AssertionError(f"profile: {len(marks)} host ranges named {PROFILE_RANGE} in one trace")
    begin, end = marks[0].time_range.start, marks[0].time_range.end
    after = begin - PROFILE_MARGIN_S * 1e6 / 2
    return [e for e in events if e is not marks[0] and (
        (e.device_type == DeviceType.CPU and begin <= e.time_range.start and e.time_range.end <= end)
        or (e.device_type == DeviceType.CUDA and e.time_range.start >= after
            and not getattr(e, "is_user_annotation", False) and e.name != PROFILE_RANGE))]


def lost_launches(events, launches, shown: int = 8) -> dict:
    """The kernel launches of a trace that have no device event (matched by correlation
    id): how many, and for the first ``shown`` the op that made the launch and its time in
    ms after the trace's first launch."""
    from torch.autograd import DeviceType

    traced = {e.id for e in events if e.device_type == DeviceType.CUDA}
    lost = [e for e in launches if e.id not in traced]
    first = min((e.time_range.start for e in launches), default=0.0)
    return {"count": len(lost), "first": [[e.cpu_parent.name if e.cpu_parent else e.name,
                                           (e.time_range.start - first) / 1e3] for e in lost[:shown]]}


def sepconv_bound_ms(batch: int, c: int, o: int, dtype: torch.dtype):
    """Least time for one launch: the larger of its operations (times the tensor-core
    products each takes in its dtype) over the peak rate for that type and its bytes (x and
    w read once, out written once) over memory bandwidth. Returns it with the operations."""
    plane = SPATIAL * SPATIAL
    flops = 2 * batch * plane * o * c * 7
    nbytes = (batch * c * plane + o * c * 7 + batch * o * plane) * dtype.itemsize
    return 1e3 * max(PRODUCTS[dtype] * flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S), flops


def ptxas_report(log: str) -> dict:
    """ptxas's registers, shared memory and spills for each kernel of the build, keyed by
    its dtype path, and any performance warning it gave."""
    report, current = {"warnings": []}, None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)$", line.strip())
        if found:
            current = next((label for name, label in INSTANTIATIONS.items() if name in found.group(1)), None)
        elif "Performance Loss" in line:
            report["warnings"].append(line.strip())
        elif current and ("spill" in line or "registers" in line):
            report.setdefault(current, []).append(line.strip().removeprefix("ptxas info    : "))
    return report


def sass_report(library):
    """The library's SASS (cuobjdump): ``HGMMA`` instructions by opcode form (such as
    ``HGMMA.64x64x8.F32.TF32``) and the kernels by dtype path; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "--dump-sass", str(library)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    forms = {}
    for form in re.findall(r"\b(HGMMA\.[\w.]+)", sass):
        forms[form] = forms.get(form, 0) + 1
    kernels = [next((label for name, label in INSTANTIATIONS.items() if name in fn), fn)
               for fn in re.findall(r"Function : (\S+)", sass)]
    return {"hgmma": forms, "kernels": kernels}


def build_phase(kernel) -> None:
    library = kernel.build()
    sass = sass_report(library)
    if sass is not None:
        for dtype in ("BF16", "TF32"):
            if not any(f".{dtype}" in form for form in sass["hgmma"]):
                raise AssertionError(f"no {dtype} HGMMA in the SASS: {sass['hgmma']}")
        if sorted(sass["kernels"]) != sorted(INSTANTIATIONS.values()):
            raise AssertionError(f"the SASS's kernels are not the instantiations: {sass['kernels']}")
    emit({"phase": "build", "kernel": "sepconv7", "seconds": kernel.build_seconds,
          "ptxas": ptxas_report(kernel.build_log), "sass": sass,
          "dynamic_smem_bytes": {"bf16": kernel.symbol("sepconv7_smem_bytes")(1),
                                 "f32": kernel.symbol("sepconv7_smem_bytes")(0)},
          "torch": torch.__version__, "cuda": torch.version.cuda})


def kernel_phase(gen: torch.Generator) -> dict:
    """Every distinct (C, O, axis) of the trunk, in each (dtype, batch) the main path or
    the kernel's contract uses: bf16 at B=512 (the FID phase) and at B=32 (the flagship's
    trunk, whose grids run as one partial wave), f32 at B=512 and B=64; returns the
    per-case results keyed by (dtype, B, C, O, axis)."""
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7, sepconv7_reference

    def plain(x, w, axis):
        """The plain version with TF32 matmuls off: its einsum is a matmul, which TF32 would round."""
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return sepconv7_reference(x, w, axis)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow

    results = {}
    for dtype, batch in ((torch.bfloat16, 512), (torch.bfloat16, FLAGSHIP_FID_IMAGES), (torch.float32, 512),
                         (torch.float32, 64)):
        for c, o, axis in sorted(set(trunk_sepconv_shapes())):
            x = torch.randn((batch, c, SPATIAL, SPATIAL), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((o, c, 7), generator=gen, device="cuda") / math.sqrt(7 * c)).to(dtype)
            out = sepconv7(x, w, axis)
            torch.cuda.synchronize()
            # the plain version on the same values in f32: the kernel's only extra step is
            # the final rounding to x's dtype
            err = float((out.float() - plain(x.float(), w.float(), axis)).abs().max())
            if not err <= ERR_LIMIT[dtype]:
                raise AssertionError(f"sepconv7 {dtype} B={batch} C={c} O={o} axis={axis}: max_abs_err {err}")
            w4 = w[:, :, None, :] if axis == "W" else w[:, :, :, None]
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):  # the same f32 function
                library_ms = cuda_ms(lambda: F.conv2d(x, w4, padding="same"), iters=20)
            bound_ms, flops = sepconv_bound_ms(batch, c, o, dtype)
            case = {
                "dtype": str(dtype).replace("torch.", ""), "B": batch, "C": c, "O": o, "axis": axis,
                "max_abs_err": err, "limit": ERR_LIMIT[dtype],
                "ms": cuda_ms(lambda: sepconv7(x, w, axis), iters=20),
                "plain_ms": cuda_ms(lambda: plain(x, w, axis), iters=5),
                "library_ms": library_ms, "bound_ms": bound_ms,
            }
            case["tflops"] = flops / case["ms"] / 1e9
            emit({"phase": "kernel", **case})
            results[(dtype, batch, c, o, axis)] = case
    for dtype in (torch.bfloat16, torch.float32):
        for batch, c, o, height, width in EDGE_CASES:
            for axis in ("W", "H"):
                x = torch.randn((batch, c, height, width), generator=gen, device="cuda").to(dtype)
                w = (torch.randn((o, c, 7), generator=gen, device="cuda") / math.sqrt(7 * c)).to(dtype)
                out = sepconv7(x, w, axis)
                torch.cuda.synchronize()
                err = float((out.float() - plain(x.float(), w.float(), axis)).abs().max())
                if not err <= ERR_LIMIT[dtype]:
                    raise AssertionError(f"sepconv7 {dtype} B={batch} C={c} O={o} {height}x{width} axis={axis}: "
                                         f"max_abs_err {err}")
                emit({"phase": "kernel_edge", "dtype": str(dtype).replace("torch.", ""), "B": batch, "C": c,
                      "O": o, "H": height, "W": width, "axis": axis, "max_abs_err": err, "limit": ERR_LIMIT[dtype]})
    return results


def fid_phase(gen: torch.Generator, cases: dict):
    """FID through the InceptionV3 trunk on the card; returns the kernel launches counted
    over the measured updates, by trunk dtype, and the metrics by trunk dtype. ``cases``
    (the kernel phase's timings) give the share of an update that the trunk's 26 sepconv7
    launches take."""
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance, InceptionV3Features
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7

    launches, metrics = {}, {}
    for trunk, batch, iters in (("bfloat16", 512, 4), ("float32", 64, 6)):
        fid = FrechetInceptionDistance(feature=InceptionV3Features(compute_dtype=trunk, seed=0), normalize=True)
        imgs = torch.rand((batch, 3, 299, 299), generator=gen, device="cuda")
        fid.update(imgs, real=True)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        sepconv7.launches = 0
        start = time.perf_counter()
        for i in range(iters):
            fid.update(imgs, real=i % 2 == 1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counted = sepconv7.launches
        if counted != SEPCONV_PER_FORWARD * iters:
            raise AssertionError(f"{trunk} trunk: {counted} sepconv7 launches over {iters} forwards")
        launches[trunk] = counted
        value = float(fid.compute())
        if not math.isfinite(value):
            raise AssertionError(f"{trunk} FID is not finite: {value}")
        dtype = torch.bfloat16 if trunk == "bfloat16" else torch.float32
        sepconv_ms = sum(cases[(dtype, batch, c, o, axis)]["ms"] for c, o, axis in trunk_sepconv_shapes())
        emit({"phase": "fid", "trunk": trunk, "batch": batch, "updates": iters,
              "images_per_s": iters * batch / seconds, "update_ms": seconds / iters * 1e3,
              "sepconv7_ms_per_forward": sepconv_ms, "sepconv7_launches": counted,
              "launches_per_forward": counted / iters, "fid": value,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
        profile_step(f"fid_update_{trunk}_B{batch}", lambda: fid.update(imgs, real=False))
        metrics[trunk] = fid
    return launches, metrics


def trunk_reference_phase(gen: torch.Generator) -> None:
    """The card's trunk features against the same trunk on the CPU (plain versions of
    every kernel) on a small input: f32 within 1e-4 of the largest feature, bf16 within
    ``TRUNK_BF16_L2`` relative L2 (the bounds of tests/test_torch_inception.py)."""
    from torchmetrics_tpu_torch.image import InceptionV3Features

    imgs = torch.rand((2, 3, 299, 299), generator=gen, device="cuda")
    want = InceptionV3Features(seed=0, device="cpu")(imgs.cpu())
    for trunk in ("float32", "bfloat16"):
        got = InceptionV3Features(seed=0, compute_dtype=trunk)(imgs).cpu()
        if got.shape != (2, 2048) or not torch.isfinite(got).all():
            raise AssertionError(f"{trunk} trunk features: shape {tuple(got.shape)} or non-finite values")
        max_rel = float((got - want).abs().max() / want.abs().max())
        l2_rel = float((got - want).norm() / want.norm())
        limit_ok = max_rel <= 1e-4 if trunk == "float32" else l2_rel <= TRUNK_BF16_L2
        if not limit_ok:
            raise AssertionError(f"{trunk} trunk on the card vs the CPU: max_rel {max_rel}, l2_rel {l2_rel}")
        emit({"phase": "trunk_vs_cpu", "trunk": trunk, "max_rel_err": max_rel, "l2_rel_err": l2_rel})


def step_ms(step, iters: int = 20) -> float:
    """Host-clock mean of ``iters`` steps after one warm-up step, synchronised at both ends."""
    step()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / iters * 1e3


RATIO_ATOL = 1e-6


def hold_against_cpu(label: str, got: dict, want: dict) -> float:
    """Card values ``got`` against the CPU's ``want``, key by key: integer tensors and
    confusion matrices equal bit for bit and in dtype, float ratios within
    ``RATIO_ATOL``. Returns the largest ratio difference."""
    worst = 0.0
    for key, want_value in want.items():
        value = got[key].cpu()
        if value.dtype != want_value.dtype or value.shape != want_value.shape:
            raise AssertionError(f"{label} {key}: {value.dtype}{tuple(value.shape)} on the card, "
                                 f"{want_value.dtype}{tuple(want_value.shape)} on the CPU")
        if not value.is_floating_point() or "confmat" in key:
            if not torch.equal(value, want_value):
                raise AssertionError(f"{label} {key}: counts differ from the CPU's")
        else:
            diff = float((value - want_value).abs().max()) if value.numel() else 0.0
            if not diff <= RATIO_ATOL:
                raise AssertionError(f"{label} {key}: differs from the CPU's by {diff}")
            worst = max(worst, diff)
    return worst


# float32 bit patterns in IEEE total order: -NaN, -inf, -1, -0, +0, 0.5, 1, +inf, +NaN
# (bfloat16's are their upper 16 bits)
TOTAL_ORDER_F32 = (0xFFC00000 - 2**32, 0xFF800000 - 2**32, 0xBF800000 - 2**32, 0x80000000 - 2**32, 0x00000000,
                   0x3F000000, 0x3F800000, 0x7F800000, 0x7FC00000)


def lower_index_topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """int32 mask of the top ``k`` of each row of ``scores`` (N, C), ties to the lower
    index, by ranks: the entries above a value plus the equal ones before it."""
    index = torch.arange(scores.shape[1], device=scores.device)
    above = scores[:, None, :] > scores[:, :, None]
    tied_before = (scores[:, None, :] == scores[:, :, None]) & (index[None, :] < index[:, None])
    return ((above | tied_before).sum(-1) < k).to(torch.int32)


def classification_phase(gen: torch.Generator) -> None:
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
    )

    def pure_step(device):
        return MetricCollection({
            "acc": MulticlassAccuracy(5, average="micro", validate_args=False, device=device),
            "f1": MulticlassF1Score(5, average="macro", validate_args=False, device=device),
            "confmat": MulticlassConfusionMatrix(5, validate_args=False, device=device),
        }, device=device).as_pure()

    batch = 65536
    preds = torch.randn((batch, 5), generator=gen, device="cuda")
    target = torch.randint(0, 5, (batch,), generator=gen, device="cuda")
    pure, cpu = pure_step(None), pure_step("cpu")
    _, values = pure.apply(pure.init(), preds, target)
    _, cpu_values = cpu.apply(cpu.init(), preds.cpu(), target.cpu())
    hold_against_cpu("classification step", values, cpu_values)
    acc, f1, confmat = float(values["acc"]), float(values["f1"]), values["confmat"].cpu()
    if int(confmat.sum()) != batch or not (0.0 <= acc <= 1.0 and 0.0 <= f1 <= 1.0):
        raise AssertionError(f"classification step: confmat sum {int(confmat.sum())}, acc {acc}, f1 {f1}")
    emit({"phase": "classification", "batch": batch,
          "step_ms": step_ms(lambda: pure.apply(pure.init(), preds, target)), "acc": acc, "f1": f1,
          "confmat_sum": int(confmat.sum())})
    profile_step(f"classification_step_B{batch}", lambda: pure.apply(pure.init(), preds, target))


def binary_segmentation_phase(gen: torch.Generator, card: str) -> None:
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        BinaryAccuracy,
        BinaryConfusionMatrix,
        BinaryF1Score,
        BinaryStatScores,
    )

    def pure_step(device):
        kwargs = {"ignore_index": 255, "validate_args": False, "device": device}
        return MetricCollection({"acc": BinaryAccuracy(**kwargs), "f1": BinaryF1Score(**kwargs),
                                 "confmat": BinaryConfusionMatrix(**kwargs)}, device=device).as_pure()

    shape = (32, 512, 512)
    logits = torch.randn(shape, generator=gen, device="cuda")
    target = torch.randint(0, 2, shape, generator=gen, device="cuda")
    target = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.05, 255, target)
    per_image = {}
    for device, (p, t) in (("cuda", (logits, target)), ("cpu", (logits.cpu(), target.cpu()))):
        metric = BinaryStatScores(multidim_average="samplewise", ignore_index=255, device=device)
        metric.update(p, t)
        per_image[device] = {"stat_scores": metric.compute()}
    hold_against_cpu("binary_segmentation samplewise", per_image["cuda"], per_image["cpu"])
    pure, cpu = pure_step(None), pure_step("cpu")
    _, values = pure.apply(pure.init(), logits, target)
    _, cpu_values = cpu.apply(cpu.init(), logits.cpu(), target.cpu())
    err = hold_against_cpu("binary_segmentation step", values, cpu_values)
    counted = int(per_image["cpu"]["stat_scores"][:, :4].sum())
    if per_image["cpu"]["stat_scores"].shape != (32, 5) or counted != int((target != 255).sum()):
        raise AssertionError(f"binary_segmentation: {counted} pixels counted")
    emit({"phase": "binary_segmentation", "shape": list(shape), "ignored_share": 1 - counted / target.numel(),
          "step_ms": step_ms(lambda: pure.apply(pure.init(), logits, target)), "acc": float(values["acc"]),
          "f1": float(values["f1"]), "max_ratio_diff": err, "card": card})
    profile_step("binary_segmentation_step_32x512x512", lambda: pure.apply(pure.init(), logits, target))


def multilabel_phase(gen: torch.Generator, card: str) -> None:
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        MultilabelAccuracy,
        MultilabelConfusionMatrix,
        MultilabelF1Score,
    )

    def pure_step(device):
        kwargs = {"num_labels": labels, "validate_args": False, "device": device}
        return MetricCollection({"acc": MultilabelAccuracy(**kwargs), "f1": MultilabelF1Score(average="macro", **kwargs),
                                 "confmat": MultilabelConfusionMatrix(**kwargs)}, device=device).as_pure()

    batch, labels = 65536, 80
    target = torch.randint(0, 2, (batch, labels), generator=gen, device="cuda")
    inputs = {"probs": torch.rand((batch, labels), generator=gen, device="cuda"),
              "logits": 2 * torch.randn((batch, labels), generator=gen, device="cuda")}
    pure, cpu = pure_step(None), pure_step("cpu")
    line = {"phase": "multilabel", "batch": batch, "labels": labels}
    for kind, preds in inputs.items():
        _, values = pure.apply(pure.init(), preds, target)
        _, cpu_values = cpu.apply(cpu.init(), preds.cpu(), target.cpu())
        err = hold_against_cpu(f"multilabel {kind}", values, cpu_values)
        if int(values["confmat"].sum()) != batch * labels:
            raise AssertionError(f"multilabel {kind}: confmat sum {int(values['confmat'].sum())}")
        line[kind] = {"step_ms": step_ms(lambda: pure.apply(pure.init(), preds, target)), "acc": float(values["acc"]),
                      "f1": float(values["f1"]), "max_ratio_diff": err}
    line["step_ms"] = line["logits"]["step_ms"]
    emit({**line, "card": card})
    profile_step(f"multilabel_step_B{batch}_L{labels}", lambda: pure.apply(pure.init(), inputs["logits"], target))


def topk_ties_phase(gen: torch.Generator, card: str) -> None:
    from torchmetrics_tpu_torch.classification import MulticlassStatScores
    from torchmetrics_tpu_torch.utilities.data import select_topk

    batch, classes, k = 65536, 5, 2
    scores = torch.randint(0, 5, (batch, classes), generator=gen, device="cuda") / 4
    target = torch.randint(0, classes, (batch,), generator=gen, device="cuda")
    if not torch.equal(select_topk(scores, k), lower_index_topk_mask(scores, k)):
        raise AssertionError("topk_ties: select_topk does not keep the lower index among ties on the card")
    ordered = scores.sort(dim=1, descending=True).values
    results = {}
    for device in ("cuda", "cpu"):
        metric = MulticlassStatScores(num_classes=classes, top_k=k, average="none", device=device)
        metric.update(scores.to(device), target.to(device))
        results[device] = {"stat_scores": metric.compute()}
    hold_against_cpu("topk_ties", results["cuda"], results["cpu"])
    metric = MulticlassStatScores(num_classes=classes, top_k=k, average="none", validate_args=False)
    # signed zeros, infinities and NaNs of both signs from their bit patterns (the
    # card's arithmetic makes only +NaN), in float32 and bfloat16: select_topk must rank
    # them in IEEE total order, as jax.lax.top_k does. The rule here is independent of
    # the float's bits: each value's place in TOTAL_ORDER_F32, ties to the lower index.
    place = torch.randint(0, len(TOTAL_ORDER_F32), (batch, classes), generator=gen, device="cuda")
    table = torch.tensor(TOTAL_ORDER_F32, dtype=torch.int64, device="cuda")
    bits = table[place].to(torch.int32)
    values = {"float32": bits.view(torch.float32), "bfloat16": (bits >> 16).to(torch.int16).view(torch.bfloat16)}
    for name, value in values.items():
        for kk in (2, 3):
            want = lower_index_topk_mask(place.float(), kk)
            if not torch.equal(select_topk(value, kk), want) or not torch.equal(select_topk(value.cpu(), kk), want.cpu()):
                raise AssertionError(f"topk_ties: select_topk leaves IEEE total order on {name} bit patterns, k={kk}")
    emit({"phase": "topk_ties", "batch": batch, "classes": classes, "top_k": k,
          "rows_tied_at_k": float((ordered[:, k - 1] == ordered[:, k]).float().mean()),
          "total_order_batches": {name: [batch, classes] for name in values},
          "step_ms": step_ms(lambda: metric.update(scores, target)), "card": card})


COLLECTIVE_PREFIXES = ("nccl:", "gloo:")


def count_collective_ops(names) -> dict:
    """The collectives a trace holds, by the names c10d's process groups give their work
    (``nccl:all_gather``, ``gloo:all_reduce``...): a count per name and the total. Host
    events, not device kernels: at a world of one NCCL may run a copy instead of a kernel."""
    by_name = {}
    for name in names:
        if name.startswith(COLLECTIVE_PREFIXES):
            by_name[name] = by_name.get(name, 0) + 1
    return {"total": sum(by_name.values()), "by_name": by_name}


def expected_collectives(states, reductions) -> dict:
    """What ``collective_counts`` predicts for a sync of ``states``: the coalesced plane
    ships one metadata all-gather and one all-gather per dtype bucket, the per-leaf plane
    two per leaf; ``reduce_many`` one collective per (reduction class x dtype) bucket and
    the per-leaf reduction one per leaf that has a reduction."""
    from torchmetrics_tpu_torch.parallel import collective_counts

    counts = collective_counts(states, reductions)
    return {"sync_coalesced": counts["process_coalesced"], "sync_per_leaf": counts["process_per_leaf"],
            "reduce_coalesced": counts["in_graph_coalesced"], "reduce_per_leaf": counts["in_graph_per_leaf"],
            "leaves": counts["leaves"]}


def shipped_bytes(states, reductions) -> int:
    """Bytes one rank ships in a coalesced sync at a world of one: the int32 metadata row
    and every leaf's payload (no padding when there are no peers)."""
    from torchmetrics_tpu_torch.parallel import coalesce

    meta = coalesce.build_local_metadata(states, reductions)
    leaves = coalesce._prepare_leaves(states, reductions)
    return meta.nbytes + sum(leaf.array.numel() * leaf.array.element_size() for leaf in leaves if leaf.array is not None)


def states_equal(got: dict, want: dict) -> bool:
    """Two state dicts, bit for bit: the same keys, dtypes, shapes and values; a list state
    by its concatenation."""
    if set(got) != set(want):
        return False
    for key, value in want.items():
        a = torch.cat([t.reshape(-1) for t in got[key]]) if isinstance(got[key], list) else got[key]
        b = torch.cat([t.reshape(-1) for t in value]) if isinstance(value, list) else value
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            return False
    return True


def median_ms(call, iters: int = 20, after=None) -> float:
    """Median over ``iters`` runs of ``call`` (which ends synchronised), host clock, after
    one untimed run; ``after`` runs untimed after each."""
    times = []
    for i in range(iters + 1):
        start = time.perf_counter()
        call()
        if i:
            times.append((time.perf_counter() - start) * 1e3)
        if after is not None:
            after()
    return sorted(times)[len(times) // 2]


def sync_nccl_phase(gen: torch.Generator, card: str, fid) -> None:
    import datetime
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType

    from torchmetrics_tpu_torch import CatMetric, MaxMetric, MeanMetric, MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score
    from torchmetrics_tpu_torch.parallel import coalesce

    batch = 65536
    preds = torch.randn((batch, 5), generator=gen, device="cuda")
    target = torch.randint(0, 5, (batch,), generator=gen, device="cuda")
    values = torch.randn((batch,), generator=gen, device="cuda")
    members = {"acc": MulticlassAccuracy(5, average="micro", validate_args=False),
               "f1": MulticlassF1Score(5, average="macro", validate_args=False),
               "confmat": MulticlassConfusionMatrix(5, validate_args=False), "fid": fid,
               "cat": CatMetric(), "mean": MeanMetric(), "max": MaxMetric()}
    for name in ("acc", "f1", "confmat"):
        members[name].update(preds, target)
    for name in ("cat", "mean", "max"):
        members[name].update(values)
    coll = MetricCollection(members)
    local = {name: dict(m._state) for name, m in coll.items(keep_base=True)}
    states, reductions = distinct_states(coll)  # the members' own dicts: the collection never updated, so no groups
    expected = expected_collectives(states, reductions)
    tensor_names = [name for name, m in coll.items(keep_base=True) if not m._list_state_names]
    pure = MetricCollection({name: members[name] for name in tensor_names}).as_pure()
    pure_states = {name: local[name] for name in tensor_names}
    expected_reduce = expected_collectives(list(pure_states.values()), [members[n]._reductions for n in tensor_names])
    expected.update(reduce_coalesced=expected_reduce["reduce_coalesced"], reduce_per_leaf=expected_reduce["reduce_per_leaf"])

    def sync_once():
        coll.sync(distributed_available=lambda: True)
        torch.cuda.synchronize()

    def reduce_once():
        out = pure.reduce(pure_states)
        torch.cuda.synchronize()
        return out

    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # a world of one on one host: no network
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        sync_once()
        for name, m in coll.items(keep_base=True):
            if not states_equal(m._state, local[name]):
                raise AssertionError(f"sync_nccl: {name}'s synced states differ from its local ones at a world of one")
        coll.unsync()
        for name, m in coll.items(keep_base=True):
            if not states_equal(m._state, local[name]) or m._is_synced:
                raise AssertionError(f"sync_nccl: unsync did not restore {name}'s states")
        reduced = reduce_once()
        for name in tensor_names:
            if not states_equal(reduced[name], local[name]):
                raise AssertionError(f"sync_nccl: PureCollection.reduce changed {name}'s states at a world of one")

        def sync_unsync():
            sync_once()
            coll.unsync()

        sync_ms = median_ms(sync_once, after=coll.unsync)
        reduce_ms = median_ms(reduce_once)
        meta = coalesce.build_local_metadata(states, reductions)
        metadata_ms = median_ms(lambda: coalesce._gather_metadata(
            lambda v: coalesce.process_rows(v, None), meta, None, real=True))

        def trace_keys(events):
            ops = count_collective_ops(e.name for e in events if e.device_type == DeviceType.CPU)
            device = [e for e in events if e.device_type == DeviceType.CUDA]
            return {"collective_ops": ops, "expected_collectives": expected["sync_coalesced"],
                    "nccl_device_ms": sum(e.time_range.elapsed_us() for e in device if "nccl" in e.name.lower()) / 1e3,
                    "copy_device_ms": {kind: sum(e.time_range.elapsed_us() for e in device if kind in e.name) / 1e3
                                       for kind in ("DtoD", "DtoH", "HtoD")}}

        events = profile_step("sync_nccl_collection", sync_unsync, extra=trace_keys)
        ops = trace_keys(events)["collective_ops"]
        if ops["total"] != expected["sync_coalesced"]:
            names = sorted({e.name for e in events if "nccl" in e.name.lower() or "c10d" in e.name.lower()})
            raise AssertionError(f"sync_nccl: the trace holds {ops} collectives, {expected['sync_coalesced']} "
                                 f"predicted; names seen: {names[:40]}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    emit({"phase": "sync_nccl", "world": 1, "backend": "nccl", "members": list(local), "sync_ms": sync_ms,
          "reduce_ms": reduce_ms, "metadata_round_trip_ms": metadata_ms, "bytes_shipped": shipped_bytes(states, reductions),
          "metadata_bytes": int(meta.nbytes), "collectives": expected, "card": card})


SYNC_CHILD_FLAG = "--sync-child"
TWO_RANK_BATCH = 65536
TWO_RANK_IMAGES = 8192  # per side: four times the features, so both covariances are well conditioned
TWO_RANK_CAT = 4096
CAT_SHORTFALL = 7  # rank 1 takes 7 rows fewer: cat lengths differ by rank
FID_RTOL = 1e-3


class ProjectionFeatures:
    """A fixed random projection of 3x32x32 images to 2048 features: FID's full feature
    width without a trunk."""

    num_features = 2048

    def __init__(self, weight: torch.Tensor) -> None:
        self.weight = weight

    def __call__(self, imgs: torch.Tensor) -> torch.Tensor:
        return imgs.reshape(imgs.shape[0], -1) @ self.weight


def two_rank_inputs() -> dict:
    """The whole batch of the two-rank phase, from a seed on the card: the same values in
    every process."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    return {"preds": torch.randn((TWO_RANK_BATCH, 5), generator=gen, device="cuda"),
            "target": torch.randint(0, 5, (TWO_RANK_BATCH,), generator=gen, device="cuda"),
            "real": torch.rand((TWO_RANK_IMAGES, 3, 32, 32), generator=gen, device="cuda"),
            "fake": torch.rand((TWO_RANK_IMAGES, 3, 32, 32), generator=gen, device="cuda") ** 2,
            "weight": torch.randn((3 * 32 * 32, 2048), generator=gen, device="cuda") / math.sqrt(3 * 32 * 32),
            "values": torch.randn((TWO_RANK_CAT,), generator=gen, device="cuda")}


def rank_slices(n: int, rank: int, world: int, shortfall: int = 0) -> slice:
    """Rank ``rank``'s contiguous share of ``n`` rows; ranks after the first take
    ``shortfall`` rows fewer."""
    share = n // world
    return slice(rank * share, (rank + 1) * share - (shortfall if rank > 0 else 0))


def two_rank_collection(inputs: dict):
    from torchmetrics_tpu_torch import CatMetric, MaxMetric, MeanMetric, MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    return MetricCollection({
        "acc": MulticlassAccuracy(5, average="micro", validate_args=False),
        "f1": MulticlassF1Score(5, average="macro", validate_args=False),
        "confmat": MulticlassConfusionMatrix(5, validate_args=False),
        "fid": FrechetInceptionDistance(feature=ProjectionFeatures(inputs["weight"])),
        "cat": CatMetric(), "mean": MeanMetric(), "max": MaxMetric()})


def update_two_rank(coll, inputs: dict, rank: int, world: int) -> None:
    """Rank ``rank``'s share of every input (all of it at ``world=1``)."""
    rows = rank_slices(TWO_RANK_BATCH, rank, world)
    for name in ("acc", "f1", "confmat"):
        coll[name].update(inputs["preds"][rows], inputs["target"][rows])
    images = rank_slices(TWO_RANK_IMAGES, rank, world)
    coll["fid"].update(inputs["real"][images], real=True)
    coll["fid"].update(inputs["fake"][images], real=False)
    if world == 1:
        coll["cat"].update(torch.cat([inputs["values"][rank_slices(TWO_RANK_CAT, r, 2, CAT_SHORTFALL)] for r in (0, 1)]))
    else:
        coll["cat"].update(inputs["values"][rank_slices(TWO_RANK_CAT, rank, world, CAT_SHORTFALL)])
    for name in ("mean", "max"):
        coll[name].update(inputs["values"][rank_slices(TWO_RANK_CAT, rank, world)])


def sync_child(rank: int, world: int, init_method: str, mode: str) -> int:
    """One rank of a two-rank phase: a gloo group on the one card, its half of the data,
    then the values through the real sync (``mode`` "sync": the collection's
    ``compute()``; "flagship": the flagship's sync and finalize; "moments": the moment
    metrics' ``compute()``). Prints its values as a RESULT line."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        if mode == "flagship":
            values, sync_ms = flagship_values(rank, world)
        elif mode == "moments":
            values, sync_ms = moment_values(rank, world)
        else:
            inputs = two_rank_inputs()
            coll = two_rank_collection(inputs)
            update_two_rank(coll, inputs, rank, world)
            torch.cuda.synchronize()

            def sync_once():
                coll.sync()
                torch.cuda.synchronize()

            sync_ms = median_ms(sync_once, iters=10, after=coll.unsync)
            values = coll.compute()  # one coalesced pre-sync over gloo
    finally:
        dist.destroy_process_group()
    print("RESULT" + json.dumps({"rank": rank, "sync_ms": sync_ms,
                                 "values": {k: [str(v.dtype), v.cpu().tolist()] for k, v in values.items()}}), flush=True)
    return 0


def run_children(mode: str, world: int = 2, wall_s: int = 300) -> list:
    """Start this script ``world`` times with ``--sync-child`` in ``mode`` (a gloo group
    on the one card, ``GLOO_SOCKET_IFNAME=lo``, a file rendezvous) and return each
    rank's RESULT; a child that fails or outlives ``wall_s`` fails the phase."""
    import tempfile

    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), SYNC_CHILD_FLAG, str(rank), str(world),
                               f"file://{rendezvous}/store", mode], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for rank in range(world)]
    results = []
    try:
        for proc in procs:
            text, _ = proc.communicate(timeout=wall_s)
            lines = [line for line in text.splitlines() if line.startswith("RESULT")]
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"{mode} children: a child failed (exit {proc.returncode}): {text[-3000:]}")
            results.append(json.loads(lines[-1][len("RESULT"):]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
        shutil.rmtree(rendezvous, ignore_errors=True)
    return results


def sync_two_ranks_phase(card: str, world: int = 2) -> None:
    results = run_children("sync", world)
    inputs = two_rank_inputs()
    whole = two_rank_collection(inputs)
    update_two_rank(whole, inputs, 0, 1)
    want = {k: v.cpu() for k, v in whole.compute().items()}
    worst = {}
    for result in results:
        for key, want_value in want.items():
            dtype, got = result["values"][key]
            got = torch.tensor(got, dtype=want_value.dtype)
            label = f"sync_two_ranks rank {result['rank']} {key}"
            if dtype != str(want_value.dtype) or got.shape != want_value.shape:
                raise AssertionError(f"{label}: {dtype}{tuple(got.shape)}, want {want_value.dtype}{tuple(want_value.shape)}")
            if key in ("confmat", "cat", "max"):
                if not torch.equal(got, want_value):
                    raise AssertionError(f"{label}: differs from the whole batch's value")
                continue
            diff = float((got - want_value).abs().max())  # ratios and the mean: absolute
            if key == "fid":
                diff /= abs(float(want_value))
            limit = FID_RTOL if key == "fid" else RATIO_ATOL
            if not diff <= limit:
                raise AssertionError(f"{label}: differs from the whole batch's value by {diff} (limit {limit})")
            worst[key] = max(worst.get(key, 0.0), diff)
    emit({"phase": "sync_two_ranks", "world": world, "backend": "gloo", "tensors": "cuda",
          "sync_ms": {f"rank{r['rank']}": r["sync_ms"] for r in results}, "fid": float(want["fid"]),
          "fid_rtol": FID_RTOL, "worst_diff": worst, "cat_rows": [TWO_RANK_CAT // world, TWO_RANK_CAT // world - CAT_SHORTFALL],
          "card": card})


# ---------------------------------------------------------------------------
# detection (slice 6): COCO val2017 scale, made from a seed
# ---------------------------------------------------------------------------

COCO_IMAGES = 5000  # COCO val2017
COCO_CLASSES = 80
COCO_DETS = 100  # detections per image, COCO's maxDets
COCO_MAX_GT = 100  # the accumulator's ground-truth rows per image
IMAGES_PER_STEP = 32
MATCHER_CHECK_IMAGES = 500
MAP_ATOL = 1e-4  # the device evaluator resolves thresholds in float32 (tests/test_map_device.py's bound)
DEVICE_MAP_CAPACITY = 524288
GT_GROUP_CAP = 32
FLAGSHIP_ROWS = 65536
FLAGSHIP_FID_IMAGES = 32
TWO_RANK_DET_IMAGES = 500


def coco_scale_dataset(rng, n_imgs: int, n_cls: int = COCO_CLASSES, n_det: int = COCO_DETS):
    """Label-correlated detections at COCO val2017's scale, as numpy list-of-dicts:
    1-14 ground truths per image (mean 7.5; val2017 has 36,781 over 5000 images), each
    detection a jittered copy of a ground truth (80%, its label kept 90% of the time) or
    a random false positive; scores in hundredths, so ties are common; about 1% crowds
    and 30% user areas."""
    preds, target = [], []
    for _ in range(n_imgs):
        ng = int(rng.integers(1, 15))
        gt = np.concatenate([rng.uniform(0, 400, (ng, 2)), np.zeros((ng, 2))], -1).astype(np.float32)
        gt[:, 2:] = gt[:, :2] + rng.uniform(4, 250, (ng, 2))
        gt_labels = rng.integers(0, n_cls, ng).astype(np.int32)
        copy = rng.random(n_det) < 0.8
        src = rng.integers(0, ng, n_det)
        boxes = gt[src] + rng.uniform(-15, 15, (n_det, 4)).astype(np.float32)
        fp = np.concatenate([rng.uniform(0, 400, (n_det, 2)), np.zeros((n_det, 2))], -1).astype(np.float32)
        fp[:, 2:] = fp[:, :2] + rng.uniform(4, 250, (n_det, 2))
        boxes = np.where(copy[:, None], boxes, fp).round(2).astype(np.float32)
        keep_label = copy & (rng.random(n_det) < 0.9)
        labels = np.where(keep_label, gt_labels[src], rng.integers(0, n_cls, n_det)).astype(np.int32)
        preds.append({"boxes": boxes, "scores": (rng.integers(1, 100, n_det) / 100).astype(np.float32),
                      "labels": labels})
        target.append({"boxes": gt.round(2), "labels": gt_labels,
                       "iscrowd": (rng.random(ng) < 0.01).astype(np.int32),
                       "area": np.where(rng.random(ng) < 0.3, rng.uniform(10, 20000, ng), 0).astype(np.float32)})
    return preds, target


def batches_of(items, size: int):
    return [items[i : i + size] for i in range(0, len(items), size)]


def state_bytes(state: dict) -> int:
    return sum(v.numel() * v.element_size() for v in state.values())


def lists_equal(got, want) -> bool:
    """Two list-of-dicts inputs, key by key and bit for bit (as float32 / int32)."""
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        for key in b:
            x, y = np.asarray(a[key]), np.asarray(b[key]).astype(np.asarray(a[key]).dtype)
            if x.shape != y.shape or not np.array_equal(x, y):
                return False
    return True


def detection_accumulate_phase(card: str, preds, target) -> None:
    from torchmetrics_tpu_torch.detection import PaddedDetectionAccumulator, pack_detection_batch

    acc = PaddedDetectionAccumulator(COCO_IMAGES, COCO_DETS, COCO_MAX_GT)
    pack_ms, packed = [], []
    for p, t in zip(batches_of(preds, IMAGES_PER_STEP), batches_of(target, IMAGES_PER_STEP)):
        start = time.perf_counter()
        packed.append(pack_detection_batch(p, t, COCO_DETS, COCO_MAX_GT))
        torch.cuda.synchronize()
        pack_ms.append((time.perf_counter() - start) * 1e3)
    state = acc.init()
    update_ms = []
    torch.cuda.set_sync_debug_mode("error")  # any host sync inside update raises
    try:
        for batch in packed:
            torch.cuda.synchronize()
            start = time.perf_counter()
            state = acc.update(state, *batch)
            torch.cuda.synchronize()
            update_ms.append((time.perf_counter() - start) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if int(state["n_images"]) != COCO_IMAGES or int(state["det_counts"].sum()) != COCO_IMAGES * COCO_DETS:
        raise AssertionError(f"detection_accumulate: {int(state['n_images'])} images, "
                             f"{int(state['det_counts'].sum())} detections")
    got_preds, got_target = acc.to_lists(state)
    if not (lists_equal(got_preds, preds) and lists_equal(got_target, target)):
        raise AssertionError("detection_accumulate: to_lists does not give back the inputs")
    # past the capacity the start clamps and the last rows are overwritten, as XLA's
    # dynamic_update_slice does: the card's state equals the CPU's bit for bit
    small = {dev: PaddedDetectionAccumulator(40, COCO_DETS, COCO_MAX_GT, device=dev) for dev in ("cuda", "cpu")}
    overflow = {}
    for dev, a in small.items():
        s = a.init()
        for i in range(3):
            lo = i * IMAGES_PER_STEP
            s = a.update(s, *pack_detection_batch(preds[lo : lo + IMAGES_PER_STEP], target[lo : lo + IMAGES_PER_STEP],
                                                  COCO_DETS, COCO_MAX_GT, device=dev))
        overflow[dev] = s
    if not states_equal({k: v.cpu() for k, v in overflow["cuda"].items()}, overflow["cpu"]):
        raise AssertionError("detection_accumulate: the clamped overflow differs from the CPU's")
    profile_step("detection_accumulate_update_32", lambda: acc.update(state, *packed[0]))
    emit({"phase": "detection_accumulate", "images": COCO_IMAGES, "per_update": IMAGES_PER_STEP,
          "updates": len(packed), "state_mb": state_bytes(state) / 1e6, "update_ms": median(update_ms),
          "pack_ms": median(pack_ms), "sync_debug_mode_in_update": "error", "overflow_images": int(overflow["cpu"]["n_images"]),
          "card": card})


def median(values) -> float:
    return sorted(values)[len(values) // 2]


def map_host_phase(card: str, preds, target) -> dict:
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    from torchmetrics_tpu_torch.functional.detection._map_eval import match_rows

    metric = MeanAveragePrecision()
    start = time.perf_counter()
    for p, t in zip(batches_of(preds, IMAGES_PER_STEP), batches_of(target, IMAGES_PER_STEP)):
        metric.update(p, t)
    update_s = time.perf_counter() - start
    start = time.perf_counter()
    result = metric.compute()
    compute_s = time.perf_counter() - start
    parts = dict(metric.last_compute_seconds)
    values = {k: float(v) for k, v in result.items() if v.ndim == 0}
    if not 0.0 < values["map"] < 1.0:
        raise AssertionError(f"map_host: map {values['map']}")
    # the matcher on the card against the matcher on the CPU, on the first 500 images
    subset = MeanAveragePrecision(device="cpu")
    subset.update(preds[:MATCHER_CHECK_IMAGES], target[:MATCHER_CHECK_IMAGES])
    inputs = subset._inputs_from_state(subset._concat_state())
    outs = {dev: match_rows(inputs, "bbox", metric.iou_thresholds, metric.max_detection_thresholds[-1],
                            torch.device(dev)) for dev in ("cuda", "cpu")}
    for i, name in ((1, "det_match"), (2, "det_ignore"), (3, "gt_ignore")):
        if not np.array_equal(outs["cuda"][i], outs["cpu"][i]):
            raise AssertionError(f"map_host: the card's {name} differs from the CPU's on {MATCHER_CHECK_IMAGES} images")
    rows = outs["cpu"][0]
    emit({"phase": "map_host", "images": len(preds), "detections": len(preds) * COCO_DETS,
          "groundtruths": int(sum(t["labels"].size for t in target)), "update_s": update_s, "compute_s": compute_s,
          "compute_parts_s": parts, "numpy_s": parts["rows"] + parts["iou"] + parts["accumulate"],
          "matcher_s": parts["matcher"], "matcher_device": "cuda",
          "matcher_check": {"images": MATCHER_CHECK_IMAGES, "rows": rows.num_rows, "dmax": rows.dmax,
                            "gmax": rows.gmax, "equal": True},
          **{k: values[k] for k in ("map", "map_50", "map_75", "mar_100")}, "card": card})
    return values


def map_device_phase(card: str, preds, target, host_values: dict) -> None:
    from torchmetrics_tpu_torch.detection import DeviceMeanAveragePrecision

    metric = DeviceMeanAveragePrecision(capacity=DEVICE_MAP_CAPACITY, num_classes=COCO_CLASSES,
                                        gt_group_cap=GT_GROUP_CAP)
    update_ms = []
    for p, t in zip(batches_of(preds, IMAGES_PER_STEP), batches_of(target, IMAGES_PER_STEP)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        metric.update(p, t)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - start) * 1e3)

    def compute_once():
        metric._computed = None
        out = metric.compute()
        torch.cuda.synchronize()
        return out

    result = compute_once()
    compute_ms = median_ms(compute_once, iters=3)
    worst = 0.0
    for key, want in host_values.items():
        got = float(result[key])
        if not abs(got - want) <= MAP_ATOL:
            raise AssertionError(f"map_device: {key} {got}, the host evaluator's {want} (limit {MAP_ATOL})")
        worst = max(worst, abs(got - want))
    from torch.autograd import DeviceType

    events = profile_step("map_device_compute", compute_once)
    device_ms = sum(e.time_range.elapsed_us() for e in events if e.device_type == DeviceType.CUDA) / 1e3
    emit({"phase": "map_device", "images": len(preds), "capacity": DEVICE_MAP_CAPACITY,
          "state_mb": state_bytes(metric._state) / 1e6, "update_ms": median(update_ms), "compute_ms": compute_ms,
          "compute_device_ms": device_ms, "worst_diff_vs_host": worst, "limit": MAP_ATOL,
          "map": float(result["map"]), "card": card})


def flagship_classification(num_classes: int = 5, device=None):
    """The flagship's ``{acc, f1}`` pure collection."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score

    return MetricCollection({
        "acc": MulticlassAccuracy(num_classes, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(num_classes, average="macro", validate_args=False, device=device),
    }, device=device).as_pure()


class Flagship:
    """The port's flagship eval step, mirroring ``__graft_entry__._flagship_step_fn``:
    the ``{acc, f1}`` pure collection, the padded detection accumulator and FID behind
    the ``extractor`` the caller passes in. ``update`` folds one batch into the states;
    ``sync`` reduces them over the process group (``PureCollection.reduce``, then
    ``PaddedDetectionAccumulator.gather``, then FID's reduction; without a group, a
    world of one, only the gather's process axis is added); ``finalize`` computes the
    values, mAP by ``MeanAveragePrecision`` on the gathered rows."""

    def __init__(self, extractor, capacity_images: int, max_det: int, max_gt: int, num_classes: int = 5,
                 device=None) -> None:
        from torchmetrics_tpu_torch.detection import PaddedDetectionAccumulator
        from torchmetrics_tpu_torch.image import FrechetInceptionDistance

        self.device = device
        self.cls_pure = flagship_classification(num_classes, device)
        self.det_acc = PaddedDetectionAccumulator(capacity_images, max_det, max_gt, device=device)
        self.fid = FrechetInceptionDistance(feature=extractor, normalize=True, device=device)

    def init(self) -> dict:
        return {"cls": self.cls_pure.init(), "det": self.det_acc.init(), "fid": self.fid.init_state()}

    def update(self, states: dict, preds, target, det_batch, imgs_real, imgs_fake) -> dict:
        fid = self.fid.update_state(states["fid"], imgs_real, True)
        return {"cls": self.cls_pure.update(states["cls"], preds, target),
                "det": self.det_acc.update(states["det"], *det_batch),
                "fid": self.fid.update_state(fid, imgs_fake, False)}

    def sync(self, states: dict, group=None) -> dict:
        import torch.distributed as dist

        if not dist.is_initialized():
            return {"cls": states["cls"], "det": self.det_acc.gather(states["det"]), "fid": states["fid"]}
        return {"cls": self.cls_pure.reduce(states["cls"], group), "det": self.det_acc.gather(states["det"], group),
                "fid": self.fid.reduce_state(states["fid"], group)}

    def expected_collectives(self, states: dict) -> int:
        """The collectives ``sync`` runs, by ``collective_counts``: one per (reduction
        class x dtype) bucket of each of its three reductions."""
        from torchmetrics_tpu_torch.detection.sharded import _stacked
        from torchmetrics_tpu_torch.parallel import collective_counts

        cls_states = list(states["cls"].values())
        cls_reds = [m._reductions for m in self.cls_pure._metrics.values()]
        det = {k: _stacked for k in states["det"]}
        return sum(collective_counts(s, r)["in_graph_coalesced"] for s, r in (
            (cls_states, cls_reds), ([states["det"]], [det]), ([states["fid"]], [self.fid._reductions])))

    def finalize(self, synced: dict) -> dict:
        from torchmetrics_tpu_torch.detection import MeanAveragePrecision

        values = dict(self.cls_pure.compute(synced["cls"]))
        # the rows are already gathered: the metric must not sync them again
        map_metric = MeanAveragePrecision(class_metrics=False, device=self.device, sync_on_compute=False)
        map_metric.update(*self.det_acc.to_lists(synced["det"]))
        values["map"] = map_metric.compute()["map"]
        values["fid"] = self.fid.compute_state(synced["fid"])
        return values


def fid_state_diff(label: str, got: dict, want: dict) -> dict:
    """A FID state against a reference one: the sample counts equal, the feature sums and
    cross-product sums within ``TRUNK_BF16_L2`` relative L2. Returns the sums' differences."""
    diffs = {}
    for key, value in want.items():
        have = got[key].cpu()
        if key.endswith("num_samples"):
            if not torch.equal(have, value):
                raise AssertionError(f"{label}: FID's {key} is {have.tolist()}, the reference's {value.tolist()}")
            continue
        diffs[key] = float((have.double() - value.double()).norm() / value.double().norm())
        if not diffs[key] <= TRUNK_BF16_L2:
            raise AssertionError(f"{label}: FID's {key} is {diffs[key]} off the reference's, relative L2")
    return diffs


def flagship_phase(card: str, preds, target, host_map: float) -> int:
    """The flagship at full width in an NCCL group of one process; returns its sepconv7
    launches."""
    import datetime
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType

    from torchmetrics_tpu_torch.detection import MeanAveragePrecision, pack_detection_batch
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance, InceptionV3Features
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7

    flagship = Flagship(InceptionV3Features(compute_dtype="bfloat16", seed=0), COCO_IMAGES, COCO_DETS, COCO_MAX_GT)
    cpu = flagship_classification(device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(6)
    det = [pack_detection_batch(p, t, COCO_DETS, COCO_MAX_GT)
           for p, t in zip(batches_of(preds, IMAGES_PER_STEP), batches_of(target, IMAGES_PER_STEP))]
    states, cpu_cls = flagship.init(), cpu.init()
    step_times, first = [], None
    sepconv7.launches = 0
    for batch in det:
        rows = torch.randn((FLAGSHIP_ROWS, 5), generator=gen, device="cuda")
        labels = torch.randint(0, 5, (FLAGSHIP_ROWS,), generator=gen, device="cuda")
        real = torch.rand((FLAGSHIP_FID_IMAGES, 3, 299, 299), generator=gen, device="cuda")
        fake = torch.rand((FLAGSHIP_FID_IMAGES, 3, 299, 299), generator=gen, device="cuda") ** 2
        torch.cuda.synchronize()
        start = time.perf_counter()
        states = flagship.update(states, rows, labels, batch, real, fake)
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - start) * 1e3)
        cpu_cls = cpu.update(cpu_cls, rows.cpu(), labels.cpu())
        if first is None:
            first = ({k: v.clone() for k, v in states["fid"].items()}, real, fake)
    launches = sepconv7.launches
    if launches != 2 * SEPCONV_PER_FORWARD * len(det):
        raise AssertionError(f"flagship: {launches} sepconv7 launches over {len(det)} steps")
    # the first step's FID state against the f32 trunk and FID's update on the CPU
    cpu_fid = FrechetInceptionDistance(feature=InceptionV3Features(seed=0, device="cpu"), normalize=True,
                                       device="cpu")
    state, real, fake = first
    fid_diff = fid_state_diff("flagship", state, cpu_fid.update_state(
        cpu_fid.update_state(cpu_fid.init_state(), real.cpu(), True), fake.cpu(), False))

    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_flagship_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        def sync_once():
            out = flagship.sync(states)
            torch.cuda.synchronize()
            return out

        synced = sync_once()
        if not states_equal(synced["fid"], states["fid"]):
            raise AssertionError("flagship: FID's reduction changed its states at a world of one")
        sync_ms = median_ms(sync_once, iters=10)
        expected = flagship.expected_collectives(states)
        events = profile_step("flagship_sync", sync_once, extra=lambda ev: {
            "collective_ops": count_collective_ops(e.name for e in ev if e.device_type == DeviceType.CPU),
            "expected_collectives": expected})
        traced = count_collective_ops(e.name for e in events if e.device_type == DeviceType.CPU)
        if traced["total"] != expected:
            raise AssertionError(f"flagship: the sync traced {traced}, {expected} collectives predicted")
        # the host evaluator's own sync: its list states go to the card for NCCL and
        # come back to the host unchanged
        own = MeanAveragePrecision()
        own.update(preds[:IMAGES_PER_STEP], target[:IMAGES_PER_STEP])
        local = {k: list(v) for k, v in own._state.items()}
        own.sync(distributed_available=lambda: True)  # a world of one syncs only when told
        if not own._is_synced or not states_equal(own._state, local) or any(t.device.type != "cpu" for v in own._state.values() for t in v):
            raise AssertionError("flagship: MeanAveragePrecision's NCCL sync changed its host list states")
        own.unsync()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    start = time.perf_counter()
    values = flagship.finalize(synced)
    finalize_s = time.perf_counter() - start
    cpu_values = cpu.compute(cpu_cls)
    for name in ("acc", "f1"):
        for leaf, want in cpu_cls[name].items():
            if not torch.equal(synced["cls"][name][leaf].cpu(), want):
                raise AssertionError(f"flagship: {name}'s {leaf} differs from the CPU's")
    cls_diff = hold_against_cpu("flagship", {k: values[k] for k in ("acc", "f1")}, cpu_values)
    if float(values["map"]) != host_map:
        raise AssertionError(f"flagship: map {float(values['map'])}, phase map_host's {host_map}")
    if not math.isfinite(float(values["fid"])):
        raise AssertionError(f"flagship: fid {float(values['fid'])}")
    emit({"phase": "flagship", "steps": len(det), "per_step": {"classification_rows": FLAGSHIP_ROWS,
          "detection_images": IMAGES_PER_STEP, "fid_images": [FLAGSHIP_FID_IMAGES, FLAGSHIP_FID_IMAGES]},
          "step_ms": median(step_times), "sync_ms": sync_ms, "collectives": {"traced": traced, "predicted": expected},
          "finalize_s": finalize_s, "sepconv7_launches": launches, "first_step_fid_state_vs_cpu": fid_diff,
          **{k: float(values[k]) for k in ("acc", "f1", "map", "fid")}, "cls_max_ratio_diff": cls_diff,
          "card": card})
    return launches


def flagship_two_rank_inputs() -> dict:
    """The flagship's whole input for the two-rank phase, the same in every process: the
    two-rank sync phase's classification rows and FID images, and 500 COCO-scale images."""
    inputs = two_rank_inputs()
    inputs["preds_det"], inputs["target_det"] = coco_scale_dataset(np.random.default_rng(7), TWO_RANK_DET_IMAGES)
    return inputs


def flagship_values(rank: int, world: int):
    """Rank ``rank``'s flagship over its share of ``flagship_two_rank_inputs()`` (all of
    it at ``world=1``), synced over the current group and finalized: the values and the
    sync's median ms."""
    from torchmetrics_tpu_torch.detection import pack_detection_batch

    inputs = flagship_two_rank_inputs()
    images = TWO_RANK_DET_IMAGES // world
    flagship = Flagship(ProjectionFeatures(inputs["weight"]), images, COCO_DETS, COCO_MAX_GT)
    lo, hi = rank * images, (rank + 1) * images
    rows, side = rank_slices(TWO_RANK_BATCH, rank, world), rank_slices(TWO_RANK_IMAGES, rank, world)
    det = pack_detection_batch(inputs["preds_det"][lo:hi], inputs["target_det"][lo:hi], COCO_DETS, COCO_MAX_GT)
    states = flagship.update(flagship.init(), inputs["preds"][rows], inputs["target"][rows], det,
                             inputs["real"][side], inputs["fake"][side])
    import torch.distributed as dist

    def sync_once():
        out = flagship.sync(states)
        torch.cuda.synchronize()
        return out

    torch.cuda.synchronize()
    if dist.is_initialized():
        dist.barrier()  # time the sync, not the ranks' skew in reaching it
    synced = sync_once()
    return flagship.finalize(synced), median_ms(sync_once, iters=5)


def flagship_two_ranks_phase(card: str, world: int = 2) -> None:
    results = run_children("flagship", world)
    want = {k: v.cpu() for k, v in flagship_values(0, 1)[0].items()}  # no group here: a world of one
    worst_fid = 0.0
    for result in results:
        for key, want_value in want.items():
            dtype, got = result["values"][key]
            got = torch.tensor(got, dtype=want_value.dtype)
            label = f"flagship_two_ranks rank {result['rank']} {key}"
            if key == "fid":
                diff = abs(float(got) - float(want_value)) / abs(float(want_value))
                if not diff <= FID_RTOL:
                    raise AssertionError(f"{label}: {float(got)}, a world of one's {float(want_value)}")
                worst_fid = max(worst_fid, diff)
            elif dtype != str(want_value.dtype) or not torch.equal(got, want_value):
                raise AssertionError(f"{label}: {got.tolist()}, a world of one's {want_value.tolist()}")
    emit({"phase": "flagship_two_ranks", "world": world, "backend": "gloo", "tensors": "cuda",
          "detection_images": TWO_RANK_DET_IMAGES, "classification_rows": TWO_RANK_BATCH,
          "fid_images_per_side": TWO_RANK_IMAGES, "sync_ms": {f"rank{r['rank']}": r["sync_ms"] for r in results},
          **{k: float(want[k]) for k in ("acc", "f1", "map", "fid")}, "fid_rel_diff": worst_fid, "fid_rtol": FID_RTOL,
          "card": card})


# ---------------------------------------------------------------------------
# generative (slice 7): KID, MiFID and InceptionScore over the bf16 trunk
# ---------------------------------------------------------------------------

GEN_IMAGES = 2048  # per side; users evaluate 10k-50k, cut to keep the CPU reference short
GEN_BATCH = 512
GEN_NOISE = 16  # fake = real plus seeded integer noise in [-16, 16], clamped to uint8
KID_SUBSETS, KID_SUBSET_SIZE = 100, 1000  # KID's published defaults
IS_CLASSES = 1008  # InceptionV3's logits head
IS_SPLITS = 10
GEN_RTOL = 1e-6
# H100 SXM FP64 peak on the tensor cores (dense); the products of KID's subsets run there
PEAK_FP64_FLOPS = 67e12


def kid_bound_ms(subsets: int, subset_size: int, features: int, n_real: int, n_fake: int) -> dict:
    """Least time for KID's float64 algebra: the three (m x F) @ (F x m) products of each
    subset at the FP64 peak, against reading both float32 feature states once and
    writing the two results; the larger bounds it."""
    flops = subsets * 3 * 2 * subset_size * features * subset_size
    nbytes = (n_real + n_fake) * features * 4 + 2 * 4
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP64_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops}


def he_scaled(params: dict) -> dict:
    """The trunk's seeded parameters with every conv weight scaled by sqrt(2), to He's
    variance for ReLU layers: the features keep unit scale (mean 0.25) through the
    trunk. The default init shrinks them to about 1.6e-4, where every kernel entry of
    KID is 1 to within 1e-8 and KID (3.2e-12) sits at float64's cancellation floor."""
    if "w" in params:
        return {**params, "w": params["w"] * np.float32(math.sqrt(2.0))}
    return {k: he_scaled(v) for k, v in params.items()}


class LogitsHead:
    """The trunk followed by a seeded 2048 -> 1008 linear head: class logits for
    InceptionScore without pretrained weights."""

    def __init__(self, trunk, weight: torch.Tensor) -> None:
        self.trunk, self.weight, self.num_features = trunk, weight, weight.shape[1]

    def __call__(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.trunk(imgs).float() @ self.weight


class Width:
    """A stand-in extractor for a metric that only computes (the CPU reference): its
    width, never called."""

    def __init__(self, num_features: int) -> None:
        self.num_features = num_features

    def __call__(self, imgs):
        raise AssertionError("the CPU reference computes on the card's states and extracts nothing")


def float64_values(metric, state) -> list:
    """A generative metric's values in float64, before ``_compute`` rounds them: KID's
    and InceptionScore's mean and population std over their scores, MiFID's value."""
    if hasattr(metric, "_value"):
        return [metric._value(state)]
    scores = metric._scores(state)
    return [float(scores.mean()), float(scores.std(correction=0))]


def cpu_twin(metric, build):
    """``build()`` (a metric on the CPU) holding ``metric``'s states moved to the CPU."""
    twin = build()
    twin._state = {k: [t.cpu() for t in v] if isinstance(v, list) else v.cpu() for k, v in metric._state.items()}
    twin._update_count = metric._update_count
    return twin


def relative_diff(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else abs(got)


def generative_phase(card: str) -> int:
    """KID, MiFID and InceptionScore behind one bf16 trunk at full width; returns the
    sepconv7 launches of their updates."""
    from torchmetrics_tpu_torch.image import (
        InceptionScore,
        InceptionV3Features,
        KernelInceptionDistance,
        MemorizationInformedFrechetInceptionDistance,
    )
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7

    gen = torch.Generator(device="cuda").manual_seed(7)
    trunk = InceptionV3Features.from_numpy_params(he_scaled(InceptionV3Features._random_params(0)),
                                                  compute_dtype="bfloat16")
    real = torch.randint(0, 256, (GEN_IMAGES, 3, 299, 299), generator=gen, device="cuda", dtype=torch.uint8)
    noise = torch.randint(-GEN_NOISE, GEN_NOISE + 1, real.shape, generator=gen, device="cuda", dtype=torch.int16)
    fake = (real.to(torch.int16) + noise).clamp(0, 255).to(torch.uint8)
    del noise
    head = LogitsHead(trunk, torch.randn((2048, IS_CLASSES), generator=gen, device="cuda") / math.sqrt(2048))
    kid_args = {"subsets": KID_SUBSETS, "subset_size": KID_SUBSET_SIZE, "seed": 0, "compute_with_cache": False}
    is_args = {"splits": IS_SPLITS, "seed": 0, "compute_with_cache": False}
    metrics = {"kid": KernelInceptionDistance(feature=trunk, **kid_args),
               "mifid": MemorizationInformedFrechetInceptionDistance(feature=trunk, compute_with_cache=False),
               "is": InceptionScore(feature=head, **is_args)}
    batches = list(zip(real.split(GEN_BATCH), fake.split(GEN_BATCH)))
    head(real[:GEN_BATCH])  # warm-up: cuDNN plans, the head's GEMM, the allocator
    torch.cuda.synchronize()
    sepconv7.launches = 0
    images_per_s, forwards = {}, 0
    for name, metric in metrics.items():
        torch.cuda.synchronize()
        start = time.perf_counter()
        for r, f in batches:
            if name == "is":
                metric.update(f)
                forwards += 1
            else:
                metric.update(r, real=True)
                metric.update(f, real=False)
                forwards += 2
        torch.cuda.synchronize()
        images_per_s[name] = (GEN_IMAGES if name == "is" else 2 * GEN_IMAGES) / (time.perf_counter() - start)
    launches = sepconv7.launches
    if launches != SEPCONV_PER_FORWARD * forwards:
        raise AssertionError(f"generative: {launches} sepconv7 launches over {forwards} trunk forwards")

    compute_s, values, diffs = {}, {}, {}
    cpu_builds = {
        "kid": lambda: KernelInceptionDistance(feature=Width(2048), device="cpu", **kid_args),
        "mifid": lambda: MemorizationInformedFrechetInceptionDistance(feature=Width(2048), device="cpu"),
        "is": lambda: InceptionScore(feature=Width(IS_CLASSES), device="cpu", **is_args),
    }
    for name, metric in metrics.items():
        torch.cuda.synchronize()
        start = time.perf_counter()
        value = metric.compute()
        torch.cuda.synchronize()
        compute_s[name] = time.perf_counter() - start
        value = [float(v) for v in value] if isinstance(value, tuple) else [float(value)]
        if not all(math.isfinite(v) for v in value):
            raise AssertionError(f"generative {name}: values {value}")
        # the float64 values before their float32 rounding, on the card and on the CPU
        # (the CPU's float32 values are those, rounded as _compute rounds them)
        twin = cpu_twin(metric, cpu_builds[name])
        got64, want64 = (float64_values(m, m._concat_state()) for m in (metric, twin))
        want = [float(torch.tensor(v, dtype=torch.float32)) for v in want64]
        worst = max(relative_diff(g, w) for g, w in zip(value, want))
        if not worst <= GEN_RTOL:
            raise AssertionError(f"generative {name}: {value} on the card, {want} on the CPU (relative {worst})")
        values[name] = value
        diffs[name] = {"float32_rel": worst, "float64_rel": max(relative_diff(g, w) for g, w in zip(got64, want64))}

    # the features of KID's update stay on the card: a projection extractor, no host sync
    projection = ProjectionFeatures(torch.randn((3 * 32 * 32, 2048), generator=gen, device="cuda") / 55.4)
    small = KernelInceptionDistance(feature=projection, subset_size=16)
    imgs = torch.rand((64, 3, 32, 32), generator=gen, device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for real_side in (True, False):
            small.update(imgs, real=real_side)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if any(t.device.type != "cuda" for v in small._state.values() for t in v):
        raise AssertionError("generative: KID's feature states left the card in update")

    bound = kid_bound_ms(KID_SUBSETS, KID_SUBSET_SIZE, 2048, GEN_IMAGES, GEN_IMAGES)

    def kid_compute():
        metrics["kid"].compute()
        torch.cuda.synchronize()

    compute_s["kid_steady"] = median_ms(kid_compute, iters=5) / 1e3  # the first call also sets up cuBLAS's FP64 path
    # the subsets' float64 algebra alone by CUDA events, the subsets drawn beforehand: its
    # launches queue far ahead of the card, so the stream's span is its device time,
    # which holds where a trace loses events
    kid = metrics["kid"]
    rows = [kid._concat_state()[k].to(torch.float64) for k in ("real_features", "fake_features")]
    subsets = kid.subset_indices(GEN_IMAGES, GEN_IMAGES)
    scores_ms = cuda_ms(lambda: kid.subset_mmd(*rows, *subsets), iters=5)
    profile_step("kid_compute", kid_compute, extra=lambda ev: {"fp64_bound": bound, "scores_ms_by_events": scores_ms})
    emit({"phase": "generative", "images_per_side": GEN_IMAGES, "batch": GEN_BATCH, "trunk": "bfloat16",
          "reduced": f"{GEN_IMAGES} images per side (users evaluate 10k-50k)",
          "update_images_per_s": images_per_s, "compute_s": compute_s, "values": values, "vs_cpu": diffs,
          "rtol": GEN_RTOL, "sepconv7_launches": launches, "kid_fp64_bound": bound, "kid_scores_ms": scores_ms,
          "kid_update_sync_debug_mode": "error", "card": card})
    return launches


# ---------------------------------------------------------------------------
# collection_groups (slice 7): compute groups on the stateful classification step
# ---------------------------------------------------------------------------

GROUPS_BATCH = 65536
GROUPS_UPDATES = 20
EXPECTED_GROUPS = [["acc", "f1", "precision", "recall"], ["confmat"]]


def groups_collection(compute_groups, device=None):
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import classification as tc

    return MetricCollection({
        "acc": tc.MulticlassAccuracy(5, average="micro", validate_args=False, device=device),
        "precision": tc.MulticlassPrecision(5, validate_args=False, device=device),
        "recall": tc.MulticlassRecall(5, validate_args=False, device=device),
        "f1": tc.MulticlassF1Score(5, validate_args=False, device=device),
        "confmat": tc.MulticlassConfusionMatrix(5, validate_args=False, device=device),
    }, compute_groups=compute_groups, device=device)


def group_sets(coll) -> list:
    """The collection's compute groups as sorted lists of names, sorted."""
    return sorted(sorted(members) for members in coll.compute_groups.values())


def distinct_states(coll):
    """Each state dict the collection holds once, with its reductions: the members of a
    compute group share one dict, and a sync ships it once."""
    seen, states, reductions = set(), [], []
    for metric in coll.values():
        if id(metric._state) not in seen:
            seen.add(id(metric._state))
            states.append(metric._state)
            reductions.append(metric._reductions)
    return states, reductions


def members_alias(coll) -> bool:
    """Every member of every compute group holds its leader's state dict and cache."""
    return all(coll[name]._state is coll[members[0]]._state and coll[name]._cache is coll[members[0]]._cache
               for members in coll.compute_groups.values() for name in members)


def launch_calls(events) -> int:
    from torch.autograd import DeviceType

    return sum(1 for e in events if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name)


def collection_groups_phase(card: str) -> None:
    import datetime
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType

    from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError

    gen = torch.Generator(device="cuda").manual_seed(8)
    batches = [(torch.randn((GROUPS_BATCH, 5), generator=gen, device="cuda"),
                torch.randint(0, 5, (GROUPS_BATCH,), generator=gen, device="cuda")) for _ in range(GROUPS_UPDATES)]
    builds = {True: groups_collection(True), False: groups_collection(False)}
    cpu = groups_collection(True, "cpu")
    update_ms, launches, device_ms = {}, {}, {}
    for flag, coll in builds.items():
        times = []
        for preds, target in batches:
            torch.cuda.synchronize()
            start = time.perf_counter()
            coll.update(preds, target)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        update_ms[flag] = median(times[1:])  # the first update derives the groups
        probe = coll.clone()
        events = profile_step(f"collection_update_groups_{flag}", lambda: probe.update(*batches[0]))
        launches[flag] = launch_calls(events)
        device_ms[flag] = sum(e.time_range.elapsed_us() for e in events if e.device_type == DeviceType.CUDA) / 1e3
    for preds, target in batches:
        cpu.update(preds.cpu(), target.cpu())
    grouped, plain = builds[True], builds[False]
    if group_sets(grouped) != EXPECTED_GROUPS or group_sets(cpu) != EXPECTED_GROUPS or plain.compute_groups:
        raise AssertionError(f"collection_groups: groups {group_sets(grouped)}, want {EXPECTED_GROUPS}")
    for name in plain.keys(keep_base=True):
        if not states_equal(grouped[name]._state, plain[name]._state):
            raise AssertionError(f"collection_groups: {name}'s counts differ with and without groups")
    values, plain_values = grouped.compute(), plain.compute()
    if not all(torch.equal(v, plain_values[k]) for k, v in values.items()):
        raise AssertionError("collection_groups: values differ with and without groups")
    ratio_diff = hold_against_cpu("collection_groups", values, cpu.compute())

    fwd, alone = grouped.clone(), groups_collection(True)
    out = fwd(*batches[0])
    alone.update(*batches[0])
    if not all(torch.equal(v, alone.compute()[k]) for k, v in out.items()):
        raise AssertionError("collection_groups: forward's values are not the batch's")
    grouped.persistent(True)
    saved = grouped.state_dict()
    restored = groups_collection(True)
    restored.load_state_dict(saved)
    if not all(torch.equal(v, values[k]) for k, v in restored.compute().items()):
        raise AssertionError("collection_groups: a restored checkpoint computes other values")
    try:
        groups_collection(True).load_state_dict({k: v for k, v in saved.items() if k != "f1.tp"})
        raise AssertionError("collection_groups: a truncated checkpoint loaded")
    except StateCorruptionError:
        pass
    mean = (grouped["acc"] + grouped["f1"]) / 2
    if not torch.equal(mean.compute(), (grouped["acc"].compute() + grouped["f1"].compute()) / 2):
        raise AssertionError("collection_groups: (acc + f1) / 2 is not the mean of the members")
    local = {name: dict(m._state) for name, m in grouped.items(keep_base=True)}
    clone = grouped.clone()
    clone.update(*batches[0])
    if not all(states_equal(m._state, local[n]) for n, m in grouped.items(keep_base=True)) or not members_alias(clone):
        raise AssertionError("collection_groups: a clone's update reached the original, or the clone lost its groups")

    states, reductions = distinct_states(grouped)
    expected = expected_collectives(states, reductions)
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_groups_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        def sync_once():
            grouped.sync(distributed_available=lambda: True)
            torch.cuda.synchronize()

        sync_once()
        if not members_alias(grouped) or not all(states_equal(m._state, local[n]) for n, m in grouped.items(keep_base=True)):
            raise AssertionError("collection_groups: the synced members do not alias, or changed at a world of one")
        grouped.unsync()
        if not members_alias(grouped):
            raise AssertionError("collection_groups: the members do not alias after unsync")
        sync_ms = median_ms(sync_once, after=grouped.unsync)
        events = profile_step("collection_groups_sync", lambda: (sync_once(), grouped.unsync()), extra=lambda ev: {
            "collective_ops": count_collective_ops(e.name for e in ev if e.device_type == DeviceType.CPU),
            "expected_collectives": expected["sync_coalesced"]})
        traced = count_collective_ops(e.name for e in events if e.device_type == DeviceType.CPU)
        if traced["total"] != expected["sync_coalesced"]:
            raise AssertionError(f"collection_groups: the sync traced {traced}, {expected['sync_coalesced']} predicted")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    emit({"phase": "collection_groups", "batch": GROUPS_BATCH, "updates": GROUPS_UPDATES, "classes": 5,
          "groups": group_sets(grouped), "update_ms": {"groups": update_ms[True], "no_groups": update_ms[False]},
          "launch_calls_per_update": {"groups": launches[True], "no_groups": launches[False]},
          "device_ms_per_update": {"groups": device_ms[True], "no_groups": device_ms[False]},
          "cls_max_ratio_diff": ratio_diff, "sync": {"ms": sync_ms, "traced": traced, "predicted": expected,
                                                     "bytes_shipped": shipped_bytes(states, reductions)},
          "card": card})


# ---------------------------------------------------------------------------
# exact match, Jaccard, MCC, Cohen's kappa; the curve family

TOWER_BATCH = 65536
TOWER_CLASSES = 5
TOWER_LABELS = 80
TOWER_MULTIDIM = (4096, 16)
TOWER_IGNORE = 0  # inside [0, 5): class 0's targets are ignored and class 0 leaves the macro mean
TOWER_ITERS = 10


def tower_inputs(gen: torch.Generator, batch: int = TOWER_BATCH, classes: int = TOWER_CLASSES,
                 labels: int = TOWER_LABELS, multidim: tuple = TOWER_MULTIDIM, device: str = "cuda") -> dict:
    """The tower's inputs from ``gen``: multiclass logits that lean to the target,
    multidim labels right at about 90% of positions, multilabel probabilities that lean
    to the target."""
    target = torch.randint(0, classes, (batch,), generator=gen, device=device)
    logits = torch.randn((batch, classes), generator=gen, device=device)
    logits.scatter_add_(1, target[:, None], torch.full((batch, 1), 1.5, device=device))
    md_target = torch.randint(0, classes, multidim, generator=gen, device=device)
    md_noise = torch.randint(0, classes, multidim, generator=gen, device=device)
    md_preds = torch.where(torch.rand(multidim, generator=gen, device=device) < 0.9, md_target, md_noise)
    ml_target = torch.randint(0, 2, (batch, labels), generator=gen, device=device)
    ml_preds = 0.35 * ml_target + 0.65 * torch.rand((batch, labels), generator=gen, device=device)
    return {"multiclass": (logits, target), "multidim": (md_preds, md_target), "multilabel": (ml_preds, ml_target)}


def tower_metrics(device=None, classes: int = TOWER_CLASSES, labels: int = TOWER_LABELS) -> dict:
    """name -> (input kind, metric), at their default arguments but the stated ones."""
    from torchmetrics_tpu_torch import classification as tc

    return {
        "jaccard_macro": ("multiclass", tc.MulticlassJaccardIndex(classes, ignore_index=TOWER_IGNORE, device=device)),
        "mcc": ("multiclass", tc.MulticlassMatthewsCorrCoef(classes, device=device)),
        "kappa_quadratic": ("multiclass", tc.MulticlassCohenKappa(classes, weights="quadratic", device=device)),
        "exact_match_multidim": ("multidim", tc.MulticlassExactMatch(classes, device=device)),
        "jaccard_multilabel": ("multilabel", tc.MultilabelJaccardIndex(labels, device=device)),
        "mcc_multilabel": ("multilabel", tc.MultilabelMatthewsCorrCoef(labels, device=device)),
        "exact_match_multilabel": ("multilabel", tc.MultilabelExactMatch(labels, device=device)),
    }


def run_tower(metrics: dict, inputs: dict) -> dict:
    """One update of each metric on its input, then ``compute()``: name -> (states, value)."""
    out = {}
    for name, (kind, metric) in metrics.items():
        metric.update(*inputs[kind])
        out[name] = (dict(metric._state), metric.compute())
    return out


def hold_tower(got: dict, want: dict, bitwise: bool = False) -> float:
    """Metric by metric: states equal bit for bit; values within ``RATIO_ATOL`` (bit for
    bit when ``bitwise``). Returns the largest value difference."""
    worst = 0.0
    for name, (states, value) in want.items():
        got_states, got_value = got[name]
        if not states_equal({k: v.cpu() for k, v in got_states.items()}, {k: v.cpu() for k, v in states.items()}):
            raise AssertionError(f"classification_tower {name}: states differ")
        got_value, value = got_value.cpu(), value.cpu()
        if got_value.dtype != value.dtype or got_value.shape != value.shape:
            raise AssertionError(f"classification_tower {name}: {got_value.dtype}{tuple(got_value.shape)} against "
                                 f"{value.dtype}{tuple(value.shape)}")
        diff = float((got_value - value).abs().max())
        if not (diff == 0.0 if bitwise else diff <= RATIO_ATOL):
            raise AssertionError(f"classification_tower {name}: values differ by {diff}")
        worst = max(worst, diff)
    return worst


def synced_ms(call) -> float:
    """Host clock around one call, synchronised at both ends."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3


def fresh_compute(metric):
    """``compute()`` without the cached value."""
    metric._computed = None
    return metric.compute()


def with_tf32(call):
    """``call()`` with TF32 matmuls allowed, restored after."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return call()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def classification_tower_phase(card: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(9)
    inputs = tower_inputs(gen)
    cpu_inputs = {kind: tuple(t.cpu() for t in pair) for kind, pair in inputs.items()}
    card_run = run_tower(tower_metrics(), inputs)
    worst = hold_tower(card_run, run_tower(tower_metrics("cpu"), cpu_inputs))
    hold_tower(with_tf32(lambda: run_tower(tower_metrics(), inputs)), card_run, bitwise=True)
    timings = {}
    for name, (kind, metric) in tower_metrics().items():
        update_ms = median([synced_ms(lambda: metric.update(*inputs[kind])) for _ in range(TOWER_ITERS + 1)][1:])
        compute_ms = median([synced_ms(lambda: fresh_compute(metric)) for _ in range(TOWER_ITERS + 1)][1:])
        timings[name] = {"update_ms": update_ms, "compute_ms": compute_ms, "value": float(card_run[name][1])}
    emit({"phase": "classification_tower", "batch": TOWER_BATCH, "classes": TOWER_CLASSES, "labels": TOWER_LABELS,
          "multidim": list(TOWER_MULTIDIM), "metrics": timings, "max_value_diff": worst, "tf32_bitwise": True,
          "card": card})


CTR_SCORES = 1 << 22
CTR_UPDATES = 16
CTR_THRESHOLDS = 200
CTR_POSITIVE_SHARE = 0.03
MAX_FPR = 0.1
IMAGENET_ROWS = 50000
IMAGENET_CLASSES = 1000
IMAGENET_UPDATES = 50
IMAGENET_THRESHOLDS = 100
BINNED_PEAK_LIMIT = 100 * 2**20
EXACT_LAUNCH_LIMIT = 200
UNSORTED_THRESHOLDS = [0.75, 0.25, 0.5, 0.25, 1.0, 0.0]


def ctr_logits(gen: torch.Generator, n: int = CTR_SCORES, device: str = "cuda"):
    """Logged click-through predictions' logits: about 3% positives, logits that lean to
    the clicks."""
    target = (torch.rand(n, generator=gen, device=device) < CTR_POSITIVE_SHARE).to(torch.int64)
    return torch.randn(n, generator=gen, device=device) + 1.5 * target - 3.5, target


def ctr_probabilities(logits: torch.Tensor) -> torch.Tensor:
    """The logged scores: probabilities rounded to thousandths (so ties abound)."""
    return torch.round(torch.sigmoid(logits) * 1000) / 1000


def ctr_scores(gen: torch.Generator, n: int = CTR_SCORES, device: str = "cuda"):
    """Logged click-through predictions: ``ctr_logits`` as logged probabilities."""
    logits, target = ctr_logits(gen, n, device)
    return ctr_probabilities(logits), target


def imagenet_logits(gen: torch.Generator, rows: int = IMAGENET_ROWS, classes: int = IMAGENET_CLASSES,
                    device: str = "cuda"):
    """A validation set's logits, which lean to the target class."""
    target = torch.randint(0, classes, (rows,), generator=gen, device=device)
    logits = torch.randn((rows, classes), generator=gen, device=device)
    logits.scatter_add_(1, target[:, None], torch.full((rows, 1), 2.5, device=device))
    return logits, target


def imagenet_scores(gen: torch.Generator, rows: int = IMAGENET_ROWS, classes: int = IMAGENET_CLASSES,
                    device: str = "cuda"):
    """A validation set's softmax rows: ``imagenet_logits`` through a softmax."""
    logits, target = imagenet_logits(gen, rows, classes, device)
    return logits.softmax(dim=1), target


def ctr_metrics(device=None, thresholds: int = CTR_THRESHOLDS) -> dict:
    from torchmetrics_tpu_torch import classification as tc

    out = {}
    for tag, thr in (("exact", None), ("binned", thresholds)):
        out[f"auroc_{tag}"] = tc.BinaryAUROC(thresholds=thr, device=device)
        out[f"ap_{tag}"] = tc.BinaryAveragePrecision(thresholds=thr, device=device)
        out[f"roc_{tag}"] = tc.BinaryROC(thresholds=thr, device=device)
        out[f"pr_curve_{tag}"] = tc.BinaryPrecisionRecallCurve(thresholds=thr, device=device)
    out["auroc_max_fpr"] = tc.BinaryAUROC(max_fpr=MAX_FPR, device=device)
    return out


def imagenet_metrics(device=None, classes: int = IMAGENET_CLASSES, thresholds: int = IMAGENET_THRESHOLDS) -> dict:
    from torchmetrics_tpu_torch import classification as tc

    return {
        "auroc_exact": tc.MulticlassAUROC(classes, device=device),
        "ap_exact": tc.MulticlassAveragePrecision(classes, device=device),
        "auroc_binned": tc.MulticlassAUROC(classes, thresholds=thresholds, device=device),
        "ap_binned": tc.MulticlassAveragePrecision(classes, thresholds=thresholds, device=device),
        "roc_macro_binned": tc.MulticlassROC(classes, thresholds=thresholds, average="macro", device=device),
    }


def metric_state_bytes(metric) -> int:
    """The bytes of a metric's states, list states by their parts."""
    return sum(t.numel() * t.element_size() for v in metric._state.values() for t in (v if isinstance(v, list) else [v]))


def compare_curves(label: str, got, want, thresholds: bool = False) -> float:
    """A curve-family result on the card against the CPU's, recursively: thresholds
    (the third part of an ``(x, y, thresholds)`` curve) bit for bit, other values within
    ``RATIO_ATOL`` with NaN in the same places. Returns the largest difference."""
    if isinstance(want, (tuple, list)):
        if not isinstance(got, (tuple, list)) or len(got) != len(want):
            raise AssertionError(f"{label}: structure differs from the CPU's")
        curve = isinstance(want, tuple) and len(want) == 3
        return max([compare_curves(label, g, w, thresholds or (curve and i == 2))
                    for i, (g, w) in enumerate(zip(got, want))], default=0.0)
    got = got.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype}{tuple(got.shape)} on the card, {want.dtype}{tuple(want.shape)} "
                             "on the CPU")
    if thresholds or not want.is_floating_point():
        if not torch.equal(got.view(torch.int32) if got.dtype == torch.float32 else got,
                           want.view(torch.int32) if want.dtype == torch.float32 else want):
            raise AssertionError(f"{label}: differs from the CPU's bit for bit")
        return 0.0
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError(f"{label}: NaN in other places than on the CPU")
    finite = ~want.isnan()
    diff = float((got[finite] - want[finite]).abs().max()) if bool(finite.any()) else 0.0
    if not diff <= RATIO_ATOL:
        raise AssertionError(f"{label}: differs from the CPU's by {diff}")
    return diff


def curve_edge_inputs(n: int = 300, classes: int = 4) -> dict:
    """A few hundred scores with NaN, +0.0 and -0.0 among them (tied zeros of both signs,
    whose curve point takes the sign of the last zero in the scores' order); multiclass
    class 3 and multilabel label 0 without positives."""
    rng = np.random.default_rng(8)
    preds = rng.uniform(size=n).astype(np.float32)
    preds[::13], preds[1::17], preds[2::17] = np.nan, -0.0, 0.0  # the last zero is +0.0
    mc_preds = rng.uniform(size=(n, classes)).astype(np.float32)
    mc_preds[::11, 1], mc_preds[3::19, 2], mc_preds[4::19, 2], mc_preds[5::23, 0] = np.nan, 0.0, -0.0, 0.0
    ml_preds = rng.uniform(size=(n, classes)).astype(np.float32)
    ml_preds[::7, 2], ml_preds[1::9, 3] = np.nan, -0.0
    ml_target = rng.integers(0, 2, (n, classes))
    ml_target[:, 0] = 0
    return {"binary": (preds, rng.integers(0, 2, n)), "multiclass": (mc_preds, rng.integers(0, classes - 1, n)),
            "multilabel": (ml_preds, ml_target)}


def curve_edge_results(inputs: dict, device) -> dict:
    """The functional curve family on the edge inputs, exact and with an unsorted list of
    thresholds that repeats one."""
    import warnings

    from torchmetrics_tpu_torch import functional as tf

    (bp, bt), (mp, mt), (lp, lt) = [tuple(torch.from_numpy(x).to(device) for x in inputs[k])
                                    for k in ("binary", "multiclass", "multilabel")]
    c = mp.shape[1]
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for tag, thr in (("exact", None), ("list", UNSORTED_THRESHOLDS)):
            out[f"binary_pr_curve_{tag}"] = tf.binary_precision_recall_curve(bp, bt, thr)
            out[f"binary_roc_{tag}"] = tf.binary_roc(bp, bt, thr)
            out[f"binary_auroc_{tag}"] = tf.binary_auroc(bp, bt, thresholds=thr)
            out[f"binary_ap_{tag}"] = tf.binary_average_precision(bp, bt, thr)
            out[f"multiclass_pr_curve_{tag}"] = tf.multiclass_precision_recall_curve(mp, mt, c, thr)
            out[f"multiclass_roc_macro_{tag}"] = tf.multiclass_roc(mp, mt, c, thr, average="macro")
            out[f"multiclass_auroc_none_{tag}"] = tf.multiclass_auroc(mp, mt, c, "none", thr)
            out[f"multiclass_ap_none_{tag}"] = tf.multiclass_average_precision(mp, mt, c, "none", thr)
            out[f"multilabel_pr_curve_{tag}"] = tf.multilabel_precision_recall_curve(lp, lt, c, thr)
            out[f"multilabel_auroc_none_{tag}"] = tf.multilabel_auroc(lp, lt, c, "none", thr)
            out[f"multilabel_ap_macro_{tag}"] = tf.multilabel_average_precision(lp, lt, c, "macro", thr)
    return out


def run_curves(metrics: dict, batches: list) -> dict:
    """Every batch into every metric, then each ``compute()``, all timed on the host's
    clock around synchronised calls: name -> {update_ms (median and mean), compute_ms
    (first and second call), state_bytes, value}."""
    import warnings

    out = {}
    for name, metric in metrics.items():
        times = [synced_ms(lambda: metric.update(*batch)) for batch in batches]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            first = synced_ms(lambda: fresh_compute(metric))
            value = []
            second = synced_ms(lambda: value.append(fresh_compute(metric)))
        out[name] = {"update_ms": median(times), "update_ms_mean": sum(times) / len(times),
                     "compute_ms": [first, second], "state_bytes": metric_state_bytes(metric), "value": value[0]}
    return out


def cpu_reference(metrics: dict, cpu_metrics: dict, batches: list, sources: dict) -> dict:
    """The CPU port's values for each metric: ``sources`` maps a metric to the CPU metric
    whose states it shares (same state family), which alone takes the batches; the others
    merge its states."""
    import warnings

    for name, source in sources.items():
        if source == name:
            for batch in batches:
                cpu_metrics[name].update(*(t.cpu() for t in batch))
    values = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, source in sources.items():
            if source != name:
                cpu_metrics[name].merge_state({k: (list(v) if isinstance(v, list) else v)
                                               for k, v in cpu_metrics[source]._state.items()})
            values[name] = cpu_metrics[name].compute()
    for name, metric in metrics.items():
        if not states_equal({k: ([t.cpu() for t in v] if isinstance(v, list) else v.cpu())
                             for k, v in metric._state.items()}, cpu_metrics[name]._state):
            raise AssertionError(f"curves {name}: the card's states differ from the CPU's")
    return values


def curve_sources(names) -> dict:
    """Each metric's state twin: the first metric of its state family (binned or exact)."""
    family = {name: "binned" if "binned" in name else "exact" for name in names}
    leaders = {}
    for name in names:
        leaders.setdefault(family[name], name)
    return {name: leaders[family[name]] for name in names}


def binned_update_peak_bytes(batches: list) -> int:
    """The bytes one binned ImageNet update allocates beyond what the card held before it
    (the state and thresholds exist already: one update ran first)."""
    probe = imagenet_metrics()["auroc_binned"]
    probe.update(*batches[0])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    probe.update(*batches[1])
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def curves_phase(card: str) -> dict:
    """Returns each workload's logits, scores, targets and batches, and its metrics on
    the card and on the CPU, for the phases that read the same data and states."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    lines, data = {}, {}
    for workload, make, scores, build, updates in (
            ("ctr", ctr_logits, ctr_probabilities, ctr_metrics, CTR_UPDATES),
            ("imagenet", imagenet_logits, lambda x: x.softmax(dim=1), imagenet_metrics, IMAGENET_UPDATES)):
        logits, target = make(gen)
        preds = scores(logits)
        batches = list(zip(preds.chunk(updates), target.chunk(updates)))
        metrics, cpu_metrics = build(), build("cpu")
        results = run_curves(metrics, batches)
        values = cpu_reference(metrics, cpu_metrics, batches, curve_sources(metrics))
        data[workload] = {"logits": logits, "scores": preds, "target": target, "batches": batches,
                          "metrics": metrics, "cpu_metrics": cpu_metrics}
        worst = max(compare_curves(f"curves {workload} {name}", results[name].pop("value"), values[name])
                    for name in metrics)
        events = profile_step(f"curves_{workload}_auroc_exact_compute", lambda: fresh_compute(metrics["auroc_exact"]))
        launches = launch_calls(events)
        if not launches < EXACT_LAUNCH_LIMIT:
            raise AssertionError(f"curves {workload}: the exact AUROC compute made {launches} launch calls")
        lines[workload] = {"scores": list(preds.shape), "updates": updates, "metrics": results,
                           "max_value_diff": worst, "exact_compute_launch_calls": launches}
        if workload == "ctr":
            lines[workload].update(positive_share=float(target.float().mean()),
                                   distinct_scores=int(torch.unique(preds).numel()))
    peak = binned_update_peak_bytes(batches)
    if not peak < BINNED_PEAK_LIMIT:
        raise AssertionError(f"curves: a binned ImageNet update took {peak} bytes beyond its inputs")
    inputs = curve_edge_inputs()
    edge_diff = max(compare_curves(f"curves edge {name}", value, want) for (name, value), want in
                    zip(curve_edge_results(inputs, "cuda").items(), curve_edge_results(inputs, "cpu").values()))
    emit({"phase": "curves", **lines, "binned_update_peak_bytes": peak, "edge_cases_max_diff": edge_diff,
          "card": card})
    return data


CALIBRATION_BINS = 15
FAIRNESS_GROUPS = 8
FAIRNESS_THRESHOLD = 0.05  # a click-through score's operating threshold (about 3% of samples click)
RANKING_PEAK_LIMIT = 2**30
SUM_RTOL = 1e-6  # float sums, which the card and the CPU add in other orders (in float64, rounded once)
VALUE_RTOL = 1e-6
FLOAT_SUMS = {"conf_bin", "acc_bin", "measures", "measure"}  # held within SUM_RTOL, the rest bit for bit


def fairness_groups(gen: torch.Generator, n: int, groups: int = FAIRNESS_GROUPS, device: str = "cuda"):
    """Each sample's group, drawn with weights 1, 1/2, ..., 1/groups (skewed, as the
    subgroups of a user population are)."""
    weights = 1.0 / torch.arange(1, groups + 1, dtype=torch.float32, device=device)
    return torch.multinomial(weights, n, replacement=True, generator=gen)


def tail_inputs(data: dict, multilabel: tuple, groups: torch.Tensor) -> dict:
    """kind -> batches: the curves phase's CTR and ImageNet batches (probabilities and
    logits), the 65,536 x 80 multilabel scores in one batch, and the CTR batches with
    their groups."""
    ctr, imagenet = data["ctr"], data["imagenet"]
    ctr_n, imagenet_n = len(ctr["batches"]), len(imagenet["batches"])
    return {
        "ctr_scores": ctr["batches"],
        "ctr_logits": list(zip(ctr["logits"].chunk(ctr_n), ctr["target"].chunk(ctr_n))),
        "ctr_groups": list(zip(ctr["scores"].chunk(ctr_n), ctr["target"].chunk(ctr_n), groups.chunk(ctr_n))),
        "imagenet_scores": imagenet["batches"],
        "imagenet_logits": list(zip(imagenet["logits"].chunk(imagenet_n), imagenet["target"].chunk(imagenet_n))),
        "multilabel": [multilabel],
    }


def tail_metrics(device=None, classes: int = IMAGENET_CLASSES, labels: int = TOWER_LABELS,
                 groups: int = FAIRNESS_GROUPS) -> dict:
    """name -> (input kind, metric), at their defaults but the stated arguments."""
    from torchmetrics_tpu_torch import classification as tc

    out = {f"calibration_{norm}": ("ctr_scores", tc.BinaryCalibrationError(CALIBRATION_BINS, norm, device=device))
           for norm in ("l1", "l2", "max")}
    out["calibration_multiclass"] = ("imagenet_scores",
                                     tc.MulticlassCalibrationError(classes, CALIBRATION_BINS, device=device))
    out["hinge_binary"] = ("ctr_logits", tc.BinaryHingeLoss(device=device))
    for mode in ("crammer-singer", "one-vs-all"):
        out[f"hinge_{mode}"] = ("imagenet_logits", tc.MulticlassHingeLoss(classes, multiclass_mode=mode, device=device))
    out["coverage_error"] = ("multilabel", tc.MultilabelCoverageError(labels, device=device))
    out["ranking_average_precision"] = ("multilabel", tc.MultilabelRankingAveragePrecision(labels, device=device))
    out["ranking_loss"] = ("multilabel", tc.MultilabelRankingLoss(labels, device=device))
    out["fairness"] = ("ctr_groups", tc.BinaryFairness(groups, threshold=FAIRNESS_THRESHOLD, device=device))
    out["group_rates"] = ("ctr_groups", tc.BinaryGroupStatRates(groups, threshold=FAIRNESS_THRESHOLD, device=device))
    return out


def run_tail(metrics: dict, inputs: dict, timed: bool = True) -> dict:
    """Every batch of its kind into each metric, then ``compute()``: name -> {states,
    value} and, when ``timed``, update_ms (median) and compute_ms (first and second
    call), on the host's clock around synchronised calls."""
    out = {}
    for name, (kind, metric) in metrics.items():
        if timed:
            times = [synced_ms(lambda: metric.update(*batch)) for batch in inputs[kind]]
            first = synced_ms(lambda: fresh_compute(metric))
            value = []
            second = synced_ms(lambda: value.append(fresh_compute(metric)))
            out[name] = {"update_ms": median(times), "compute_ms": [first, second], "value": value[0]}
        else:
            for batch in inputs[kind]:
                metric.update(*batch)
            out[name] = {"value": metric.compute()}
        out[name]["states"] = {k: (torch.cat(v) if isinstance(v, list) else v).clone()
                               for k, v in metric._state.items()}
    return out


def summary(value: torch.Tensor):
    """A value for a report line: its entries, or of a long vector its mean, min and max."""
    return value.tolist() if value.numel() <= 8 else [float(value.double().nanmean()), float(value.min()),
                                                      float(value.max())]


def largest_rel_diff(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """The largest ``|got - want| / max(|want|, floor)`` (``|got - want|`` where that
    scale is 0), NaN in the same places; inf if they are not. ``floor=1`` makes it
    relative above magnitude 1 and absolute below."""
    got, want = got.cpu().double(), want.cpu().double()
    if not torch.equal(got.isnan(), want.isnan()):
        return math.inf
    finite = ~want.isnan()
    if not bool(finite.any()):
        return 0.0
    diff = (got - want).abs()[finite]
    scale = want.abs()[finite].clamp(min=floor)
    return float(torch.where(scale > 0, diff / scale, diff).max())


def hold_tail(got: dict, want: dict, bitwise: bool = False) -> dict:
    """Metric by metric: states bit for bit, but the float sums in ``FLOAT_SUMS`` within
    ``SUM_RTOL`` relative; values (dicts by their keys) within ``VALUE_RTOL`` relative,
    or everything bit for bit when ``bitwise``. Returns the largest relative differences."""
    worst = {"sums": 0.0, "values": 0.0}
    for name, entry in want.items():
        for key, value in entry["states"].items():
            mine = got[name]["states"][key].cpu()
            if mine.dtype != value.dtype or mine.shape != value.shape:
                raise AssertionError(f"tower_tail {name} {key}: {mine.dtype}{tuple(mine.shape)} against "
                                     f"{value.dtype}{tuple(value.shape)}")
            if key in FLOAT_SUMS and not bitwise:
                diff = largest_rel_diff(mine, value)
                if not diff <= SUM_RTOL:
                    raise AssertionError(f"tower_tail {name} {key}: states differ by {diff} relative")
                worst["sums"] = max(worst["sums"], diff)
            elif not torch.equal(mine, value.cpu()):
                raise AssertionError(f"tower_tail {name} {key}: states differ")
        value, mine = entry["value"], got[name]["value"]
        if isinstance(value, dict) and list(value) != list(mine):
            raise AssertionError(f"tower_tail {name}: keys {list(mine)} against {list(value)}")
        for a, b in zip(*((list(v.values()) if isinstance(v, dict) else [v]) for v in (mine, value))):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"tower_tail {name}: value {a.dtype}{tuple(a.shape)} against {b.dtype}"
                                     f"{tuple(b.shape)}")
            diff = largest_rel_diff(a, b)
            if not (diff == 0.0 if bitwise else diff <= VALUE_RTOL):
                raise AssertionError(f"tower_tail {name}: values differ by {diff} relative")
            worst["values"] = max(worst["values"], diff)
    return worst


def update_peak_bytes(metric, batch) -> int:
    """The bytes one update allocates beyond what the card held before it (an update
    ran first, so the states exist)."""
    metric.update(*batch)
    return peak_extra_bytes(lambda: metric.update(*batch))[1]


def peak_extra_bytes(call, keep: int = 0):
    """``(result, bytes)``: the bytes ``call()`` allocates beyond what the card held before
    it, less ``keep`` (its output's bytes)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = call()
    torch.cuda.synchronize()
    return result, torch.cuda.max_memory_allocated() - base - keep


def tower_tail_phase(card: str, data: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(11)
    groups = fairness_groups(gen, data["ctr"]["target"].numel())
    multilabel = tower_inputs(torch.Generator(device="cuda").manual_seed(9))["multilabel"]
    inputs = tail_inputs(data, multilabel, groups)
    cpu_inputs = {kind: [tuple(t.cpu() for t in batch) for batch in batches] for kind, batches in inputs.items()}
    metrics = tail_metrics()
    card_run = run_tail(metrics, inputs)
    worst = hold_tail(card_run, run_tail(tail_metrics("cpu"), cpu_inputs, timed=False))
    ranking = ("coverage_error", "ranking_average_precision", "ranking_loss")
    peaks = {name: update_peak_bytes(tail_metrics()[name][1], multilabel) for name in ranking}
    if not max(peaks.values()) < RANKING_PEAK_LIMIT:
        raise AssertionError(f"tower_tail: a ranking update took {peaks} bytes beyond its inputs")
    rerun = ranking + ("hinge_crammer-singer", "hinge_one-vs-all")
    fresh = tail_metrics()
    again = with_tf32(lambda: run_tail({name: fresh[name] for name in rerun}, inputs, timed=False))
    hold_tail(again, {name: card_run[name] for name in rerun}, bitwise=True)
    lines = {name: {"update_ms": entry["update_ms"], "compute_ms": entry["compute_ms"],
                    "value": {k: summary(v) for k, v in entry["value"].items()} if isinstance(entry["value"], dict)
                    else summary(entry["value"])} for name, entry in card_run.items()}
    emit({"phase": "tower_tail", "metrics": lines, "max_value_rel_diff": worst["values"],
          "max_sum_rel_diff": worst["sums"], "ranking_update_peak_bytes": peaks, "tf32_bitwise": True,
          "ctr_scores": data["ctr"]["target"].numel(), "imagenet_rows": list(data["imagenet"]["logits"].shape),
          "multilabel": list(multilabel[0].shape), "groups": torch.bincount(groups).tolist(), "card": card})
    for name in ("calibration_l1", "calibration_multiclass", "hinge_one-vs-all", "ranking_loss", "fairness"):
        kind, metric = metrics[name]
        profile_step(f"tower_tail_{name}_update", lambda: metric.update(*inputs[kind][0]))


# The exact macro EER of ImageNet interpolates all 1,000 curves onto the union of their
# false positive rates, about 50M points: 5e10 interpolations, which no implementation of
# the JAX package's semantics finishes inside this script's time. It runs binned here, and
# exact at a small size in tests/test_torch_operating_points.py.
MACRO_EER_NOTE = "exact macro EER at ImageNet size left out: 5e10 interpolations onto a 50M-point union"
POINT_FLOORS = {"min_recall": 0.5, "min_precision": 0.2, "min_specificity": 0.99, "min_sensitivity": 0.5}
POINT_LAUNCH_PROFILES = ("eer_none_exact", "logauc_none_exact", "recall_at_precision_exact")


def point_metrics(workload: str, device=None, classes: int = IMAGENET_CLASSES, thresholds=None) -> dict:
    """name -> metric: EER, LogAUC (default range and (0.01, 0.5)) and the four operating
    points, exact and binned (at the curves phase's thresholds unless given);
    ImageNet's per class (``average=None``) and macro."""
    from torchmetrics_tpu_torch import classification as tc

    out = {}
    if workload == "ctr":
        for tag, thr in (("exact", None), ("binned", thresholds or CTR_THRESHOLDS)):
            kwargs = {"thresholds": thr, "device": device}
            out[f"eer_{tag}"] = tc.BinaryEER(**kwargs)
            out[f"logauc_{tag}"] = tc.BinaryLogAUC(**kwargs)
            out[f"logauc_wide_{tag}"] = tc.BinaryLogAUC(fpr_range=(0.01, 0.5), **kwargs)
            out[f"precision_at_recall_{tag}"] = tc.BinaryPrecisionAtFixedRecall(POINT_FLOORS["min_recall"], **kwargs)
            out[f"recall_at_precision_{tag}"] = tc.BinaryRecallAtFixedPrecision(POINT_FLOORS["min_precision"],
                                                                                **kwargs)
            out[f"sensitivity_at_specificity_{tag}"] = tc.BinarySensitivityAtSpecificity(
                POINT_FLOORS["min_specificity"], **kwargs)
            out[f"specificity_at_sensitivity_{tag}"] = tc.BinarySpecificityAtSensitivity(
                POINT_FLOORS["min_sensitivity"], **kwargs)
        return out
    for tag, thr in (("exact", None), ("binned", thresholds or IMAGENET_THRESHOLDS)):
        kwargs = {"thresholds": thr, "device": device}
        for average in ("none", "macro"):
            if average == "none" or thr is not None:  # the exact macro curve: see MACRO_EER_NOTE
                out[f"eer_{average}_{tag}"] = tc.MulticlassEER(classes, average=None if average == "none"
                                                               else average, **kwargs)
            out[f"logauc_{average}_{tag}"] = tc.MulticlassLogAUC(classes, average=None if average == "none"
                                                                 else average, **kwargs)
        out[f"precision_at_recall_{tag}"] = tc.MulticlassPrecisionAtFixedRecall(classes, POINT_FLOORS["min_recall"],
                                                                              **kwargs)
        out[f"recall_at_precision_{tag}"] = tc.MulticlassRecallAtFixedPrecision(classes, POINT_FLOORS["min_precision"],
                                                                              **kwargs)
        out[f"sensitivity_at_specificity_{tag}"] = tc.MulticlassSensitivityAtSpecificity(
            classes, POINT_FLOORS["min_specificity"], **kwargs)
        out[f"specificity_at_sensitivity_{tag}"] = tc.MulticlassSpecificityAtSensitivity(
            classes, POINT_FLOORS["min_sensitivity"], **kwargs)
    return out


def adopt_states(metrics: dict, sources: dict) -> None:
    """Each metric takes the states of the source of its family (``"exact"`` or
    ``"binned"`` in its name), by reference: no update runs."""
    for name, metric in metrics.items():
        source = sources["binned" if "binned" in name else "exact"]
        metric.merge_state({k: (list(v) if isinstance(v, list) else v) for k, v in source._state.items()})


def compare_points(label: str, got, want) -> float:
    """An EER or LogAUC value, or an operating point (value, threshold), on the card
    against the CPU's: thresholds bit for bit (NaN by place), values within
    ``RATIO_ATOL`` with NaN in the same places. Returns the largest value difference."""
    if isinstance(want, tuple):
        if not isinstance(got, tuple) or len(got) != 2:
            raise AssertionError(f"{label}: structure differs from the CPU's")
        threshold, want_threshold = got[1].cpu(), want[1]
        same = (threshold.dtype == want_threshold.dtype and threshold.shape == want_threshold.shape
                and torch.equal(threshold.isnan(), want_threshold.isnan())
                and torch.equal(torch.where(threshold.isnan(), 0.0, threshold).view(torch.int32),
                                torch.where(want_threshold.isnan(), 0.0, want_threshold).view(torch.int32)))
        if not same:
            raise AssertionError(f"{label}: the thresholds differ from the CPU's bit for bit")
        return compare_curves(label, got[0], want[0])
    return compare_curves(label, got, want)


def curve_point_edge_results(inputs: dict, device) -> dict:
    """The functional EER, LogAUC and operating points on ``curve_edge_inputs`` (NaN and
    signed zeros, a class and a label without positives), on its scores in quarters (ties
    on the objective) too, exact and with an unsorted list of thresholds that repeats one
    and holds 1.0 (NaN precision); floors that leave the class without positives no
    feasible point."""
    import warnings

    from torchmetrics_tpu_torch import functional as tf

    out = {}
    (bp, bt), (mp, mt), (lp, lt) = [tuple(torch.from_numpy(x).to(device) for x in inputs[k])
                                    for k in ("binary", "multiclass", "multilabel")]
    c = mp.shape[1]
    ties = {"scores": (bp, mp, lp), "quarters": tuple(torch.round(x * 4) / 4 for x in (bp, mp, lp))}
    points = (("precision_at_fixed_recall", "min_recall"), ("recall_at_fixed_precision", "min_precision"),
              ("sensitivity_at_specificity", "min_specificity"), ("specificity_at_sensitivity", "min_sensitivity"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kind, (b, m, ml) in ties.items():
            for tag, thr in (("exact", None), ("list", UNSORTED_THRESHOLDS)):
                key = f"{kind}_{tag}"
                out[f"binary_eer_{key}"] = tf.binary_eer(b, bt, thr)
                out[f"multiclass_eer_{key}"] = tf.multiclass_eer(m, mt, c, thr)
                out[f"multilabel_logauc_{key}"] = tf.multilabel_logauc(ml, lt, c, thresholds=thr, average=None)
                out[f"binary_logauc_{key}"] = tf.binary_logauc(b, bt, (0.01, 0.5), thr)
                for stem, floor in points:
                    for value in (0.5, 1.0):
                        out[f"binary_{stem}_{value}_{key}"] = getattr(tf, f"binary_{stem}")(b, bt, value, thr)
                        out[f"multiclass_{stem}_{value}_{key}"] = getattr(tf, f"multiclass_{stem}")(m, mt, c, value, thr)
                        out[f"multilabel_{stem}_{value}_{key}"] = getattr(tf, f"multilabel_{stem}")(ml, lt, c, value,
                                                                                                 thr)
    return out


def curve_points_phase(card: str, data: dict) -> None:
    import warnings

    lines = {}
    worst = 0.0
    for workload in ("ctr", "imagenet"):
        sources = {"exact": data[workload]["metrics"]["auroc_exact"], "binned": data[workload]["metrics"]["auroc_binned"]}
        cpu_sources = {k: data[workload]["cpu_metrics"][f"auroc_{k}"] for k in ("exact", "binned")}
        metrics, cpu_metrics = point_metrics(workload), point_metrics(workload, "cpu")
        adopt_states(metrics, sources)
        adopt_states(cpu_metrics, cpu_sources)
        results = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, metric in metrics.items():
                first = synced_ms(lambda: fresh_compute(metric))
                value = []
                second = synced_ms(lambda: value.append(fresh_compute(metric)))
                worst = max(worst, compare_points(f"curve_points {workload} {name}", value[0],
                                                  cpu_metrics[name].compute()))
                shown = value[0] if isinstance(value[0], tuple) else (value[0],)
                results[name] = {"compute_ms": [first, second], "value": [summary(v) for v in shown]}
        lines[workload] = results
        if workload == "imagenet":
            launches = {}
            for name in POINT_LAUNCH_PROFILES:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    events = profile_step(f"curve_points_imagenet_{name}_compute",
                                          lambda: fresh_compute(metrics[name]))
                launches[name] = launch_calls(events)
            if not max(launches.values()) < EXACT_LAUNCH_LIMIT:
                raise AssertionError(f"curve_points: the exact ImageNet computes made {launches} launch calls")
            lines["exact_compute_launch_calls"] = launches
    inputs = curve_edge_inputs()
    edge = {name: (value, want) for (name, value), want in
            zip(curve_point_edge_results(inputs, "cuda").items(), curve_point_edge_results(inputs, "cpu").values())}
    edge_diff = max(compare_points(f"curve_points edge {name}", value, want) for name, (value, want) in edge.items())
    fallbacks = {"no_feasible_1e6": bool((edge["multiclass_specificity_at_sensitivity_0.5_scores_exact"][0][1][3]
                                          == 1e6).item()),
                 "no_feasible_nan": bool(edge["multiclass_recall_at_fixed_precision_0.5_scores_exact"][0][1][3]
                                         .isnan().item())}
    if not all(fallbacks.values()):
        raise AssertionError(f"curve_points edge: the class without positives gave {fallbacks}")
    emit({"phase": "curve_points", **lines, "max_value_diff": worst, "edge_cases": len(edge), "note": MACRO_EER_NOTE,
          "edge_cases_max_diff": edge_diff, "fallbacks": fallbacks, "floors": POINT_FLOORS, "card": card})


# ---------------------------------------------------------------------------
# regression and correlation (slice 10): M5 demand, WeatherBench-2-shaped verification,
# radar nowcasts, MT metric meta-evaluation, embeddings, distillation
# ---------------------------------------------------------------------------

M5_SERIES = 30490  # the M5 competition's item-store series
M5_DAYS = 28  # its forecast horizon: one update a day
M5_ZERO_SHARE = 0.68
WB_POINTS = 121 * 240  # WeatherBench 2's 1.5-degree grid
WB_INITS = 64  # 00 and 12 UTC over 32 days: one update an initialisation
# the four headline variables: climatological mean, spread and forecast error, in their units
WB_VARIABLES = (("z500", 54000.0, 3300.0, 250.0), ("t850", 275.0, 15.0, 1.2), ("t2m", 280.0, 18.0, 1.5),
                ("u10", 0.5, 5.0, 2.0))
ENSEMBLE_POINTS = 721 * 1440  # the 0.25-degree grid
ENSEMBLE_MEMBERS = 50
ENSEMBLE_UPDATES = 2
NOWCAST = (16, 18, 256, 256)  # crops, lead times, pixels: DGMR-style radar nowcast scoring
NOWCAST_UPDATES = 4
CSI_THRESHOLDS = (1.0, 4.0, 8.0)  # mm/h
KENDALL_PAIRS = 32768  # (metric score, human score) pairs of an MT meta-evaluation
KENDALL_UPDATES = 8
EMBEDDINGS = (65536, 768)
EMBEDDING_UPDATES = 16
DISTILL = (50000, 1000)  # teacher and student softmax rows over ImageNet's classes
DISTILL_UPDATES = 50
PEAK_LIMIT = 2**30  # a CRPS update's or the Kendall compute's memory beyond its inputs
KENDALL_LAUNCH_LIMIT = 500
MOMENT_SPLIT = 40  # the moments children: rank 0 takes 40 initialisations, rank 1 the other 24
# states held bit for bit, but the float sums and values of these metrics within SUM_RTOL
# relative, or SUM_RTOL absolute below magnitude 1: their summed terms come from log, exp
# or pow, whose last bit the card's and the CPU's libraries may round apart (every other
# float sum is added in float64 and rounded once: bit for bit). A divergence row sums
# terms p log(p/m) whose log is off by about one ulp of 1 per unit of probability mass,
# and a row's mass is 1: its error is absolute, so a small row's relative error grows
TRANSCENDENTAL = {"msle", "log_cosh", "minkowski_3", "tweedie_1.5"} | {
    f"{div}_{red}_{kind}" for div in ("kl", "js") for red in ("mean", "none") for kind in ("probs", "log")}
# values whose formula subtracts second moments (R2's tss = sum y^2 - sum y * mean, explained
# variance's E[y^2] - E[y]^2): a relative error e in a state moves them by e * kappa, kappa
# = sum y^2 / tss, so their bound is VALUE_RTOL * kappa (the class's NRMSE std uses centred
# sums merged by Chan's formula and does not cancel)
CANCELLING = {"r2": ("sum_squared_error", "sum_error", "total"), "rse": ("sum_squared_obs", "sum_obs", "total"),
              "explained_variance": ("sum_squared_target", "sum_target", "num_obs")}


def m5_inputs(series: int = M5_SERIES, days: int = M5_DAYS, seed: int = 13, device: str = "cuda"):
    """(forecast, sold), float32 (days, series): 68% of the days sell nothing, the rest
    1 + a gamma count; the forecasts are positive."""
    rng = np.random.default_rng(seed)
    sold = np.where(rng.uniform(size=(days, series)) < M5_ZERO_SHARE, 0.0,
                    1.0 + np.floor(rng.gamma(1.2, 3.0, (days, series))))
    forecast = np.maximum(sold * rng.uniform(0.6, 1.4, sold.shape) + rng.gamma(0.5, 0.8, sold.shape), 0.01)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (forecast, sold))


def weather_inputs(inits: int = WB_INITS, points: int = WB_POINTS, seed: int = 17, device: str = "cuda"):
    """(forecast, truth), float32 (inits, points, 4): the four variables around their
    climatology, the forecast with its error and a small bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mean, spread, error = (torch.tensor([v[i] for v in WB_VARIABLES], device=device) for i in (1, 2, 3))
    truth = mean + spread * torch.randn((inits, points, 4), generator=gen, device=device)
    forecast = truth + error * (torch.randn((inits, points, 4), generator=gen, device=device) + 0.1)
    return forecast, truth


def ensemble_inputs(points: int = ENSEMBLE_POINTS, members: int = ENSEMBLE_MEMBERS, updates: int = ENSEMBLE_UPDATES,
                    seed: int = 19, device: str = "cuda") -> list:
    """``updates`` batches of (members (points, members), truth (points,)): 2 m
    temperature, members spread around a forecast centre."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(updates):
        truth = 280.0 + 18.0 * torch.randn(points, generator=gen, device=device)
        centre = truth + 1.5 * torch.randn(points, generator=gen, device=device)
        out.append((centre[:, None] + 1.5 * torch.randn((points, members), generator=gen, device=device), truth))
    return out


def nowcast_inputs(shape=NOWCAST, updates: int = NOWCAST_UPDATES, seed: int = 23, device: str = "cuda") -> list:
    """Rain rates in mm/h (55% dry, the rest log-normal) and a nowcast of them,
    ``updates`` batches of crops."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw():
        return torch.randn(shape, generator=gen, device=device)

    rain = torch.where(torch.rand(shape, generator=gen, device=device) < 0.55, 0.0, torch.exp(0.5 + 1.2 * draw()))
    nowcast = rain * torch.exp(0.4 * draw()) + torch.where(torch.rand(shape, generator=gen, device=device) < 0.03,
                                                           torch.exp(draw()), 0.0)
    return list(zip(nowcast.chunk(updates), rain.chunk(updates)))


def regression_inputs(device: str = "cuda", scale: float = 1.0) -> dict:
    """kind -> batches; ``scale`` < 1 shrinks every size for a rehearsal."""
    def size(n):
        return max(2, int(n * scale))

    m5 = m5_inputs(size(M5_SERIES), device=device)
    weather = weather_inputs(WB_INITS, size(WB_POINTS), device=device)
    return {"m5": list(zip(*(t.unbind(0) for t in m5))), "weather": list(zip(*(t.unbind(0) for t in weather))),
            "ensemble": ensemble_inputs(size(ENSEMBLE_POINTS), device=device),
            "nowcast": nowcast_inputs((NOWCAST[0], NOWCAST[1], size(NOWCAST[2]), size(NOWCAST[3])), device=device)}


def regression_metrics(device=None) -> dict:
    """name -> (input kind, metric): the M5 team's, the weather team's, CRPS and CSI."""
    from torchmetrics_tpu_torch import regression as tr

    kw = {"device": device}
    out = {name: ("m5", metric) for name, metric in {
        "mse": tr.MeanSquaredError(**kw), "rmse": tr.MeanSquaredError(squared=False, **kw),
        "mae": tr.MeanAbsoluteError(**kw), "mape": tr.MeanAbsolutePercentageError(**kw),
        "smape": tr.SymmetricMeanAbsolutePercentageError(**kw), "wmape": tr.WeightedMeanAbsolutePercentageError(**kw),
        "msle": tr.MeanSquaredLogError(**kw), "log_cosh": tr.LogCoshError(**kw),
        "minkowski_3": tr.MinkowskiDistance(3, **kw), "tweedie_1.5": tr.TweedieDevianceScore(1.5, **kw),
        "r2": tr.R2Score(**kw), "rse": tr.RelativeSquaredError(**kw), "explained_variance": tr.ExplainedVariance(**kw),
        **{f"nrmse_{norm}": tr.NormalizedRootMeanSquaredError(norm, **kw) for norm in ("mean", "range", "std", "l2")},
        "pearson": tr.PearsonCorrCoef(**kw), "spearman": tr.SpearmanCorrCoef(**kw)}.items()}
    outputs = len(WB_VARIABLES)
    out.update({f"weather_{name}": ("weather", metric) for name, metric in {
        "pearson": tr.PearsonCorrCoef(outputs, **kw), "concordance": tr.ConcordanceCorrCoef(outputs, **kw),
        "r2_raw_values": tr.R2Score(outputs, multioutput="raw_values", **kw),
        "r2_variance_weighted": tr.R2Score(outputs, multioutput="variance_weighted", **kw),
        "explained_variance": tr.ExplainedVariance("raw_values", **kw),
        "nrmse_std": tr.NormalizedRootMeanSquaredError("std", outputs, **kw),
        "nrmse_range": tr.NormalizedRootMeanSquaredError("range", outputs, **kw)}.items()})
    out["crps"] = ("ensemble", tr.ContinuousRankedProbabilityScore(**kw))
    for thr in CSI_THRESHOLDS:
        out[f"csi_{thr:g}"] = ("nowcast", tr.CriticalSuccessIndex(thr, **kw))
        out[f"csi_{thr:g}_per_lead"] = ("nowcast", tr.CriticalSuccessIndex(thr, keep_sequence_dim=1, **kw))
    return out


def cancellation(name: str, states: dict) -> float:
    """kappa = sum y^2 / tss of a cancelling value (the largest over its outputs), from
    its states in float64; 1 for every other metric."""
    stem = name.replace("weather_", "").replace("_raw_values", "").replace("_variance_weighted", "")
    if stem not in CANCELLING:
        return 1.0
    squares, sums, count = (states[k].cpu().double() for k in CANCELLING[stem])
    return float((squares / (squares - sums * sums / count)).abs().max().clamp(min=1.0))


def hold_states(phase: str, got: dict, want: dict, bitwise: bool = False) -> dict:
    """Metric by metric against the CPU's run: every state float32 (the JAX package's
    dtype) and of the CPU's shape; states bit for bit, but the float sums of the
    ``TRANSCENDENTAL`` metrics within ``SUM_RTOL`` (relative, absolute below 1); values
    within ``VALUE_RTOL``, the cancelling ones within ``VALUE_RTOL * kappa`` and the
    ``TRANSCENDENTAL`` ones as their sums; or everything bit for bit when ``bitwise``.
    Returns the largest differences and kappas."""
    worst = {"sums": 0.0, "values": 0.0, "kappa": {}}
    for name, entry in want.items():
        for key, value in entry["states"].items():
            mine = got[name]["states"][key].cpu()
            if mine.dtype != torch.float32 or value.dtype != torch.float32 or mine.shape != value.shape:
                raise AssertionError(f"{phase} {name} {key}: {mine.dtype}{tuple(mine.shape)} against "
                                     f"{value.dtype}{tuple(value.shape)}")
            if name in TRANSCENDENTAL and not bitwise:
                diff = largest_rel_diff(mine, value, floor=1.0)
                if not diff <= SUM_RTOL:
                    raise AssertionError(f"{phase} {name} {key}: states differ by {diff} relative")
                worst["sums"] = max(worst["sums"], diff)
            elif not torch.equal(mine, value.cpu()):
                raise AssertionError(f"{phase} {name} {key}: states differ")
        kappa = cancellation(name, entry["states"])
        if kappa > 1.0:
            worst["kappa"][name] = kappa
        for a, b in zip(*((list(v) if isinstance(v, tuple) else [v]) for v in (got[name]["value"], entry["value"]))):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{phase} {name}: value {a.dtype}{tuple(a.shape)} against {b.dtype}{tuple(b.shape)}")
            diff = largest_rel_diff(a, b, floor=1.0 if name in TRANSCENDENTAL else 0.0)
            if not (diff == 0.0 if bitwise else diff <= VALUE_RTOL * kappa):
                raise AssertionError(f"{phase} {name}: values differ by {diff} relative (kappa {kappa})")
            worst["values"] = max(worst["values"], diff)
    return worst


def phase_seconds(clock: list) -> dict:
    """Host seconds of a phase's parts from its clock readings: inputs (made on the card
    and copied to the host), the card's run, the CPU port's run, and the checks after."""
    parts = ("inputs", "card_run", "cpu_run", "checks")
    return {name: b - a for name, a, b in zip(parts, clock, clock[1:])}


def short_value(value):
    return [summary(v) for v in value] if isinstance(value, tuple) else summary(value)


def phase_lines(run: dict) -> dict:
    return {name: {"update_ms": entry["update_ms"], "compute_ms": entry["compute_ms"],
                   "value": short_value(entry["value"])} for name, entry in run.items()}


def compute_peak_bytes(metric) -> int:
    """The bytes one ``compute()`` allocates beyond what the card held before it."""
    return peak_extra_bytes(lambda: fresh_compute(metric))[1]


def regression_phase(card: str) -> None:
    import warnings

    from torchmetrics_tpu_torch.functional.regression.utils import _rank_data

    clock = [time.perf_counter()]
    inputs = regression_inputs()
    cpu_inputs = {kind: [tuple(t.cpu() for t in batch) for batch in batches] for kind, batches in inputs.items()}
    metrics = regression_metrics()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clock.append(time.perf_counter())
        card_run = run_tail(metrics, inputs)
        clock.append(time.perf_counter())
        worst = hold_states("regression", card_run, run_tail(regression_metrics("cpu"), cpu_inputs, timed=False))
        clock.append(time.perf_counter())
    spearman = metrics["spearman"][1]._concat_state()
    cpu_spearman = {k: v.cpu() for k, v in spearman.items()}
    for key in ("preds", "target"):
        if not torch.equal(_rank_data(spearman[key]).cpu(), _rank_data(cpu_spearman[key])):
            raise AssertionError(f"regression: Spearman's {key} ranks differ from the CPU's")
    zero_run = int((cpu_spearman["target"] == 0).sum())
    crps_peak = update_peak_bytes(regression_metrics()["crps"][1], inputs["ensemble"][0])
    if not crps_peak < PEAK_LIMIT:
        raise AssertionError(f"regression: a CRPS update took {crps_peak} bytes beyond its inputs")
    r2_names = ("r2", "rse", "weather_r2_raw_values", "weather_r2_variance_weighted")
    fresh = regression_metrics()
    again = with_tf32(lambda: run_tail({name: fresh[name] for name in r2_names}, inputs, timed=False))
    hold_states("regression tf32", again, {name: card_run[name] for name in r2_names}, bitwise=True)
    clock.append(time.perf_counter())
    emit({"phase": "regression", "seconds": phase_seconds(clock), "metrics": phase_lines(card_run), "max_value_rel_diff": worst["values"],
          "max_transcendental_sum_rel_diff": worst["sums"], "kappa": worst["kappa"], "tf32_bitwise": list(r2_names),
          "spearman_ranks_bitwise": True, "m5_zero_run": zero_run, "crps_update_peak_bytes": crps_peak,
          "sizes": {"m5": [M5_DAYS, M5_SERIES], "weather": [WB_INITS, WB_POINTS, len(WB_VARIABLES)],
                    "ensemble": [ENSEMBLE_UPDATES, ENSEMBLE_POINTS, ENSEMBLE_MEMBERS],
                    "nowcast": [NOWCAST_UPDATES, *NOWCAST]}, "card": card})
    m5_sums = [metric for name, (kind, metric) in metrics.items() if kind == "m5" and name not in ("spearman",)]
    batch = inputs["m5"][0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        profile_step("regression_m5_sum_state_update", lambda: [metric.update(*batch) for metric in m5_sums])
    profile_step("regression_crps_update", lambda: metrics["crps"][1].update(*inputs["ensemble"][0]))
    profile_step("regression_weather_pearson_update", lambda: metrics["weather_pearson"][1].update(*inputs["weather"][0]))
    profile_step("regression_spearman_compute", lambda: fresh_compute(metrics["spearman"][1]))


def kendall_inputs(n: int = KENDALL_PAIRS, updates: int = KENDALL_UPDATES, seed: int = 29, device: str = "cuda"):
    """(metric score, human score) batches: direct-assessment scores in whole points
    (ties), a metric score that follows them with noise."""
    rng = np.random.default_rng(seed)
    human = rng.integers(0, 101, n).astype(np.float32)
    score = (np.tanh((human - 50) / 30 + rng.normal(0, 0.6, n))).astype(np.float32)
    return list(zip(*(torch.from_numpy(a).to(device).chunk(updates) for a in (score, human))))


def embedding_inputs(shape=EMBEDDINGS, updates: int = EMBEDDING_UPDATES, seed: int = 31, device: str = "cuda"):
    gen = torch.Generator(device=device).manual_seed(seed)
    preds = torch.randn(shape, generator=gen, device=device)
    target = preds + 0.7 * torch.randn(shape, generator=gen, device=device)
    return list(zip(preds.chunk(updates), target.chunk(updates)))


def distill_inputs(shape=DISTILL, updates: int = DISTILL_UPDATES, seed: int = 37, device: str = "cuda") -> dict:
    """Teacher and student softmax rows, as probabilities and as log-probabilities."""
    gen = torch.Generator(device=device).manual_seed(seed)
    teacher = 2.0 * torch.randn(shape, generator=gen, device=device)
    student = teacher + 0.8 * torch.randn(shape, generator=gen, device=device)
    return {"probs": list(zip(teacher.softmax(1).chunk(updates), student.softmax(1).chunk(updates))),
            "log": list(zip(teacher.log_softmax(1).chunk(updates), student.log_softmax(1).chunk(updates)))}


def correlation_inputs(device: str = "cuda", scale: float = 1.0) -> dict:
    def size(n):
        return max(8, int(n * scale))

    distill = distill_inputs((size(DISTILL[0]), DISTILL[1]), device=device)
    return {"mt": kendall_inputs(size(KENDALL_PAIRS), device=device),
            "embeddings": embedding_inputs((size(EMBEDDINGS[0]), EMBEDDINGS[1]), device=device),
            "distill_probs": distill["probs"], "distill_log": distill["log"]}


def correlation_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch import regression as tr

    kw = {"device": device}
    out = {"kendall_b_t_test": ("mt", tr.KendallRankCorrCoef("b", t_test=True, **kw)),
           "kendall_c": ("mt", tr.KendallRankCorrCoef("c", **kw)),
           "cosine_mean": ("embeddings", tr.CosineSimilarity("mean", **kw)),
           "cosine_none": ("embeddings", tr.CosineSimilarity("none", **kw))}
    for div, cls in (("kl", tr.KLDivergence), ("js", tr.JensenShannonDivergence)):
        for red in ("mean", "none"):
            for kind in ("probs", "log"):
                out[f"{div}_{red}_{kind}"] = (f"distill_{kind}", cls(log_prob=kind == "log",
                                                                     reduction=None if red == "none" else red, **kw))
    return out


def correlation_phase(card: str) -> None:
    from torchmetrics_tpu_torch.functional.regression.kendall import _pair_counts

    clock = [time.perf_counter()]
    inputs = correlation_inputs()
    cpu_inputs = {kind: [tuple(t.cpu() for t in batch) for batch in batches] for kind, batches in inputs.items()}
    metrics = correlation_metrics()
    clock.append(time.perf_counter())
    card_run = run_tail(metrics, inputs)
    clock.append(time.perf_counter())
    worst = hold_states("correlation", card_run, run_tail(correlation_metrics("cpu"), cpu_inputs, timed=False))
    clock.append(time.perf_counter())
    kendall = metrics["kendall_b_t_test"][1]._concat_state()
    con, dis = _pair_counts(kendall["preds"], kendall["target"])
    cpu_con, cpu_dis = _pair_counts(kendall["preds"].cpu(), kendall["target"].cpu())
    if not (torch.equal(con.cpu(), cpu_con) and torch.equal(dis.cpu(), cpu_dis)):
        raise AssertionError("correlation: Kendall's pair counts differ from the CPU's")
    x, y = kendall_edge_inputs()
    edge_counts = [tuple(float(c) for c in _pair_counts(x.to(device), y.to(device))) for device in ("cuda", "cpu")]
    if edge_counts[0] != edge_counts[1]:
        raise AssertionError(f"correlation: Kendall's pair counts with NaN and inf differ: {edge_counts}")
    kendall_peak = compute_peak_bytes(metrics["kendall_b_t_test"][1])
    if not kendall_peak < PEAK_LIMIT:
        raise AssertionError(f"correlation: the Kendall compute took {kendall_peak} bytes beyond its inputs")
    rerun = ("kendall_b_t_test", "kendall_c", "cosine_mean", "cosine_none")
    fresh = correlation_metrics()
    again = with_tf32(lambda: run_tail({name: fresh[name] for name in rerun}, inputs, timed=False))
    hold_states("correlation tf32", again, {name: card_run[name] for name in rerun}, bitwise=True)
    events = profile_step("correlation_kendall_compute", lambda: fresh_compute(metrics["kendall_b_t_test"][1]))
    kendall_launches = launch_calls(events)
    if not kendall_launches < KENDALL_LAUNCH_LIMIT:
        raise AssertionError(f"correlation: the Kendall compute made {kendall_launches} launch calls")
    clock.append(time.perf_counter())
    emit({"phase": "correlation", "seconds": phase_seconds(clock), "metrics": phase_lines(card_run), "max_value_rel_diff": worst["values"],
          "max_transcendental_sum_rel_diff": worst["sums"], "kendall_pairs": [float(con), float(dis)],
          "kendall_edge_pairs": edge_counts[0], "kendall_compute_peak_bytes": kendall_peak,
          "kendall_compute_launch_calls": kendall_launches, "tf32_bitwise": list(rerun),
          "sizes": {"mt": KENDALL_PAIRS, "embeddings": list(EMBEDDINGS), "distill": list(DISTILL)}, "card": card})
    moments_two_ranks_phase(card)


def kendall_edge_inputs():
    """1,000 pairs in whole points with NaN and both infinities: pairs that compare NaN
    (a NaN difference) must count neither concordant nor discordant."""
    rng = np.random.default_rng(41)
    x = rng.integers(0, 20, 1000).astype(np.float32)
    y = (x + rng.integers(-3, 4, 1000)).astype(np.float32)
    x[:6] = [np.nan, np.inf, -np.inf, np.inf, np.nan, -np.inf]
    y[3:9] = [np.inf, np.nan, -np.inf, np.inf, np.nan, 0.0]
    return torch.from_numpy(x), torch.from_numpy(y)


def moment_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch import regression as tr

    outputs = len(WB_VARIABLES)
    return {"pearson": tr.PearsonCorrCoef(outputs, device=device),
            "concordance": tr.ConcordanceCorrCoef(outputs, device=device),
            "nrmse_std": tr.NormalizedRootMeanSquaredError("std", outputs, device=device),
            "r2": tr.R2Score(outputs, multioutput="raw_values", device=device)}


def moment_split(rank: int, world: int, inits: int = WB_INITS) -> range:
    """The initialisations of rank ``rank`` (all of them at ``world=1``): uneven halves."""
    if world == 1:
        return range(inits)
    return range(0, MOMENT_SPLIT) if rank == 0 else range(MOMENT_SPLIT, inits)


def moment_values(rank: int, world: int):
    """The moment metrics over this rank's initialisations of the weather data, then
    ``compute()`` (synced when ``world`` > 1): values and the median sync ms."""
    forecast, truth = weather_inputs()
    metrics = moment_metrics()
    for i in moment_split(rank, world):
        for metric in metrics.values():
            metric.update(forecast[i], truth[i])
    torch.cuda.synchronize()
    metric = metrics["pearson"]

    def sync_once():
        metric.sync()
        torch.cuda.synchronize()

    sync_ms = median_ms(sync_once, iters=10, after=metric.unsync) if world > 1 else 0.0
    return {name: metric.compute() for name, metric in metrics.items()}, sync_ms


def moments_two_ranks_phase(card: str, world: int = 2) -> None:
    start = time.perf_counter()
    results = run_children("moments", world)
    children_s = time.perf_counter() - start
    want = {k: v.cpu() for k, v in moment_values(0, 1)[0].items()}
    worst = 0.0
    for result in results:
        for key, want_value in want.items():
            dtype, got = result["values"][key]
            got = torch.tensor(got, dtype=want_value.dtype)
            if dtype != str(want_value.dtype) or got.shape != want_value.shape:
                raise AssertionError(f"moments_two_ranks rank {result['rank']} {key}: {dtype}{tuple(got.shape)}")
            diff = largest_rel_diff(got, want_value)
            if not diff <= VALUE_RTOL:
                raise AssertionError(f"moments_two_ranks rank {result['rank']} {key}: {diff} relative from the "
                                     "whole data's value")
            worst = max(worst, diff)
    emit({"phase": "moments_two_ranks", "world": world, "children_s": children_s, "backend": "gloo", "tensors": "cuda",
          "inits": [len(moment_split(r, world)) for r in range(world)],
          "sync_ms": {f"rank{r['rank']}": r["sync_ms"] for r in results}, "max_rel_diff": worst,
          "values": {k: summary(v) for k, v in want.items()}, "card": card})


# ---------------------------------------------------------------------------
# wrappers (slice 11): BootStrapper, FeatureShare, Classwise, Tracker, MinMax, Running,
# Multioutput, Multitask and the input transformers, on the card against the CPU port
# ---------------------------------------------------------------------------

BOOT_REPLICAS = 100
BOOT_LIST_REPLICAS = 20
BOOT_QUANTILES = [0.025, 0.975]
BOOT_CPU_PREFIX = 5  # updates the CPU port replays; it holds 100 replicas of 1,000 x 1,000 rows
SHARE_BATCH = 128
SHARE_UPDATES = 4  # two real and two fake batches
SHARE_KID = {"subsets": 10, "subset_size": SHARE_BATCH, "seed": 0}
TRACKER_EPOCHS = 3
RUNNING_WINDOW = 5
WEATHER_NAN_SHARE = 0.01


def clock_seconds(clock: list) -> dict:
    """Host seconds of a phase's parts from its ``(label, time)`` readings: each label's
    part ends at its reading."""
    return {label: t - before for (_, before), (label, t) in zip(clock, clock[1:])}


def tree_leaves(value, prefix: str = "") -> dict:
    """A nested output (dicts, tuples, tensors) as a flat dict of tensors by path."""
    if isinstance(value, dict):
        return {k: v for key, item in value.items() for k, v in tree_leaves(item, f"{prefix}{key}.").items()}
    if isinstance(value, (tuple, list)):
        return {k: v for i, item in enumerate(value) for k, v in tree_leaves(item, f"{prefix}{i}.").items()}
    return {prefix.rstrip("."): torch.as_tensor(value)}


def hold_tree(label: str, got, want) -> float:
    """``hold_against_cpu`` over nested outputs: counts bit for bit, ratios within 1e-6."""
    got, want = tree_leaves(got), tree_leaves(want)
    if list(got) != list(want):
        raise AssertionError(f"{label}: keys {list(got)[:5]}... on the card, {list(want)[:5]}... on the CPU")
    return hold_against_cpu(label, got, {k: v.cpu() for k, v in want.items()})


def replica_states(boot) -> list:
    """BootStrapper's replica states: the stacked ``(k, ...)`` states, or each clone's
    states and update count."""
    if boot._use_stacked:
        return [dict(boot._stacked)]
    return [{**m._state, "update_count": torch.tensor(m._update_count)} for m in boot.metrics]


def bootstrapper(device=None, classes: int = IMAGENET_CLASSES, replicas: int = BOOT_REPLICAS,
                 sampling: str = "multinomial"):
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.wrappers import BootStrapper

    return BootStrapper(MulticlassAccuracy(num_classes=classes, device=device), num_bootstraps=replicas,
                        sampling_strategy=sampling, quantile=BOOT_QUANTILES, seed=0)


def hold_bootstrap(label: str, boot, cpu_boot) -> float:
    """Replica states bit for bit (integer counts), mean, std and quantiles within 1e-6."""
    for r, (got, want) in enumerate(zip(replica_states(boot), replica_states(cpu_boot))):
        if not states_equal({k: v.cpu() for k, v in got.items()}, want):
            raise AssertionError(f"{label}: replica states {r} differ from the CPU port's")
    return hold_tree(label, boot.compute(), cpu_boot.compute())


def wrapper_suite(device, data: dict, classes: int = IMAGENET_CLASSES) -> dict:
    """Classwise, Tracker, MinMax, Running, Multioutput, Multitask and
    BinaryTargetTransformer over ``data`` (``imagenet``, ``ctr`` and ``weather`` batches)
    on ``device``: name -> value, and the update ms of each."""
    from torchmetrics_tpu_torch.classification import BinaryAccuracy, MulticlassAccuracy
    from torchmetrics_tpu_torch.regression import MeanSquaredError, PearsonCorrCoef
    from torchmetrics_tpu_torch.wrappers import (
        BinaryTargetTransformer,
        ClasswiseWrapper,
        MetricTracker,
        MinMaxMetric,
        MultioutputWrapper,
        MultitaskWrapper,
        Running,
    )

    timed = device != "cpu"
    ms: dict = {}

    def run(name, call):
        if timed:
            ms.setdefault(name, []).append(synced_ms(call))
        else:
            call()

    imagenet, ctr, weather = data["imagenet"], data["ctr"], data["weather"]
    classwise = ClasswiseWrapper(MulticlassAccuracy(classes, average=None, device=device))
    minmax = MinMaxMetric(MulticlassAccuracy(classes, device=device))
    running = Running(MulticlassAccuracy(classes, device=device), window=RUNNING_WINDOW)
    tracker = MetricTracker(MulticlassAccuracy(classes, device=device))
    for i, (logits, target) in enumerate(imagenet):
        if i % -(-len(imagenet) // TRACKER_EPOCHS) == 0:
            tracker.increment()
        run("classwise", lambda: classwise.update(logits, target))
        run("minmax_forward", lambda: minmax.forward(logits, target))
        run("running", lambda: running.update(logits, target))
        run("tracker", lambda: tracker.update(logits, target))
    best, step = tracker.best_metric(return_step=True)
    if best is None or step is None:
        raise AssertionError(f"wrappers: MetricTracker.best_metric gave {best, step} on {device}")
    multioutput = MultioutputWrapper(PearsonCorrCoef(device=device), num_outputs=4)
    for forecast, truth in weather:
        run("multioutput", lambda: multioutput.update(forecast, truth))
    multitask = MultitaskWrapper({"cls": BinaryAccuracy(device=device), "reg": MeanSquaredError(device=device)})
    binarised = BinaryTargetTransformer(BinaryAccuracy(device=device), threshold=0.5)
    for scores, target in ctr:
        run("multitask", lambda: multitask.update({"cls": scores, "reg": scores},
                                                  {"cls": target, "reg": target.to(scores.dtype)}))
        run("binary_target", lambda: binarised.update(scores, target.to(scores.dtype)))
    values = {"classwise": classwise.compute(), "minmax": minmax.compute(), "running": running.compute(),
              "tracker": {"all": tracker.compute_all(), "best": torch.tensor(best), "step": torch.tensor(step)},
              "multioutput": multioutput.compute(), "multitask": multitask.compute(),
              "binary_target": binarised.compute()}
    if len(values["classwise"]) != classes:
        raise AssertionError(f"wrappers: ClasswiseWrapper gave {len(values['classwise'])} keys")
    return {"values": values, "update_ms": {k: median(v) for k, v in ms.items()}}


def wrapper_data(device: str = "cuda", scale: float = 1.0, seed: int = 11) -> dict:
    """The ImageNet logits, the CTR scores and the weather fields of the earlier phases,
    in their update batches; 1% of the weather rows get a NaN. ``scale`` < 1 shrinks them
    for a rehearsal."""
    def size(n):
        return max(8, int(n * scale))

    gen = torch.Generator(device=device).manual_seed(seed)
    logits, target = imagenet_logits(gen, size(IMAGENET_ROWS), size(IMAGENET_CLASSES), device)
    scores, clicks = ctr_scores(gen, size(CTR_SCORES), device)
    forecast, truth = weather_inputs(max(2, int(WB_INITS * scale)), size(WB_POINTS), device=device)
    nan_rows = torch.rand(forecast.shape[:2], generator=gen, device=device) < WEATHER_NAN_SHARE
    column = torch.randint(0, 4, forecast.shape[:2], generator=gen, device=device)
    forecast = forecast.clone()
    forecast[nan_rows, column[nan_rows]] = float("nan")
    return {"imagenet": list(zip(logits.chunk(IMAGENET_UPDATES), target.chunk(IMAGENET_UPDATES))),
            "ctr": list(zip(scores.chunk(CTR_UPDATES), clicks.chunk(CTR_UPDATES))),
            "weather": list(zip(forecast.unbind(0), truth.unbind(0))), "nan_rows": int(nan_rows.sum())}


def share_members(extractor, device=None) -> list:
    """FID, KID and MiFID behind one extractor, ``normalize=False`` (uint8 input)."""
    from torchmetrics_tpu_torch.image import (
        FrechetInceptionDistance,
        KernelInceptionDistance,
        MemorizationInformedFrechetInceptionDistance,
    )

    return [FrechetInceptionDistance(feature=extractor, device=device),
            KernelInceptionDistance(feature=extractor, device=device, **SHARE_KID),
            MemorizationInformedFrechetInceptionDistance(feature=extractor, device=device)]


def feature_share_run(extractor, batches: list, device=None) -> dict:
    """The members shared (``FeatureShare``) and each alone, over ``batches`` of
    (images, real) that lie on the host: the members' states, the seconds of each, and
    the sepconv7 launches of each, counted from 0 around each loop."""
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7
    from torchmetrics_tpu_torch.wrappers import FeatureShare

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    share = FeatureShare(share_members(extractor, device))
    sync()
    sepconv7.launches = 0
    start = time.perf_counter()
    for imgs, real in batches:
        share.update(imgs, real=real)
    sync()
    shared_s, shared_launches = time.perf_counter() - start, sepconv7.launches
    alone = share_members(extractor, device)
    sync()
    sepconv7.launches = 0
    start = time.perf_counter()
    for member in alone:
        for imgs, real in batches:
            member.update(imgs, real=real)
    sync()
    return {"shared": [m._state for m in share.values()], "alone": [m._state for m in alone],
            "shared_s": shared_s, "alone_s": time.perf_counter() - start, "share": share,
            "shared_launches": shared_launches, "alone_launches": sepconv7.launches}


def wrappers_phase(card: str) -> int:
    """Returns the sepconv7 launches of FeatureShare's shared updates."""
    from torchmetrics_tpu_torch.image import InceptionV3Features

    clock = [("start", time.perf_counter())]
    data = wrapper_data()
    cpu_data = {k: [tuple(t.cpu() for t in batch) for batch in v] if isinstance(v, list) else v
                for k, v in data.items()}
    # BootStrapper, stacked (multinomial) and list (poisson) paths, against the CPU port
    # on a prefix of the updates
    boot_lines = {}
    for path, sampling, replicas in (("stacked", "multinomial", BOOT_REPLICAS),
                                     ("list", "poisson", BOOT_LIST_REPLICAS)):
        boot, cpu_boot = (bootstrapper(device, replicas=replicas, sampling=sampling) for device in (None, "cpu"))
        if boot._use_stacked is not (path == "stacked"):
            raise AssertionError(f"wrappers: BootStrapper({sampling}) took the wrong path")
        times = []
        for i, batch in enumerate(data["imagenet"]):
            times.append(synced_ms(lambda: boot.update(*batch)))
            if i < BOOT_CPU_PREFIX:
                cpu_boot.update(*cpu_data["imagenet"][i])
            if i == BOOT_CPU_PREFIX - 1:
                worst = hold_bootstrap(f"wrappers bootstrap {path}", boot, cpu_boot)
        value = boot.compute()
        if not all(bool(torch.isfinite(v).all()) for v in tree_leaves(value).values()):
            raise AssertionError(f"wrappers bootstrap {path}: {value}")
        probe = bootstrapper(None, replicas=replicas, sampling=sampling)
        peak = update_peak_bytes(probe, data["imagenet"][0])
        events = profile_step(f"wrappers_bootstrap_{path}_update", lambda: probe.update(*data["imagenet"][0]))
        boot_lines[path] = {"replicas": replicas, "sampling": sampling, "update_ms": median(times[1:]),
                            "launch_calls": launch_calls(events), "peak_extra_bytes": peak,
                            "cpu_prefix_updates": BOOT_CPU_PREFIX, "max_value_diff": worst,
                            "value": {k: summary(v) for k, v in tree_leaves(value).items()}}
        clock.append((f"bootstrap_{path}", time.perf_counter()))
    # FeatureShare over FID, KID and MiFID on one bf16 trunk; the batches start on the host
    trunk = InceptionV3Features.from_numpy_params(he_scaled(InceptionV3Features._random_params(0)),
                                                  compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(12)
    batches = [(torch.randint(0, 256, (SHARE_BATCH, 3, 299, 299), generator=gen, dtype=torch.uint8), i % 2 == 0)
               for i in range(SHARE_UPDATES)]
    for member in share_members(trunk):  # warm-up: cuDNN plans, cuBLAS, the allocator
        member.update(batches[0][0].cuda(), real=True)
    run = feature_share_run(trunk, batches)
    launches = run["shared_launches"]
    if launches != SEPCONV_PER_FORWARD * SHARE_UPDATES:
        raise AssertionError(f"wrappers: {launches} sepconv7 launches over {SHARE_UPDATES} shared updates")
    if run["alone_launches"] != 3 * SEPCONV_PER_FORWARD * SHARE_UPDATES:
        raise AssertionError(f"wrappers: {run['alone_launches']} sepconv7 launches over the members alone")
    for i, (got, want) in enumerate(zip(run["shared"], run["alone"])):
        if not states_equal(got, want):
            raise AssertionError(f"wrappers: FeatureShare member {i}'s states differ from the metric alone")
    images = SHARE_BATCH * SHARE_UPDATES
    clock.append(("feature_share", time.perf_counter()))
    # the other wrappers, against the CPU port
    card_run = wrapper_suite(None, data)
    worst = hold_tree("wrappers suite", card_run["values"], wrapper_suite("cpu", cpu_data)["values"])
    clock.append(("suite", time.perf_counter()))
    emit({"phase": "wrappers", "bootstrap": boot_lines,
          "feature_share": {"batch": SHARE_BATCH, "updates": SHARE_UPDATES, "trunk": "bfloat16",
                            "inputs": "uint8 on the host", "sepconv7_launches": launches,
                            "sepconv7_launches_alone": run["alone_launches"],
                            "launches_per_update": launches / SHARE_UPDATES,
                            "images_per_s_shared": images / run["shared_s"],
                            "images_per_s_alone": images / run["alone_s"],
                            "members_equal_alone": True},
          "suite": {"update_ms": card_run["update_ms"], "max_value_diff": worst,
                    "weather_nan_rows": data["nan_rows"],
                    "tracker_best": summary(card_run["values"]["tracker"]["best"]),
                    "tracker_step": int(card_run["values"]["tracker"]["step"])},
          "seconds": clock_seconds(clock), "card": card})
    return launches


# ---------------------------------------------------------------------------
# panoptic (slice 11): PanopticQuality and ModifiedPanopticQuality on COCO-panoptic maps
# ---------------------------------------------------------------------------

PANOPTIC_THINGS = tuple(range(1, 81))  # COCO panoptic: 80 thing and 53 stuff categories
PANOPTIC_STUFFS = tuple(range(81, 134))
PANOPTIC_SHAPE = (480, 640)
PANOPTIC_IMAGES = 64  # of val2017's 5,000: the JAX algorithm takes ~0.3 s an image, read twice
PANOPTIC_BATCH = 16
PANOPTIC_CELL = 16
PANOPTIC_MAX_SEGMENTS = 30
PANOPTIC_VOID = 0  # in neither set: void


def panoptic_maps(rng, n: int, shape=PANOPTIC_SHAPE, cell: int = PANOPTIC_CELL,
                  max_segments: int = PANOPTIC_MAX_SEGMENTS):
    """(preds, target), int32 ``(n, H, W, 2)`` of (category, instance): 1 to
    ``max_segments`` Voronoi segments a target on a grid of ``cell`` pixels, each of a
    seeded category (things numbered by instance, stuff instance 0), 5% of the cells
    void; predictions move 15% of the cells to a neighbour's segment and relabel 10% of
    the segments."""
    gh, gw = shape[0] // cell, shape[1] // cell
    yy, xx = np.mgrid[0:gh, 0:gw]
    cats = np.array(PANOPTIC_THINGS + PANOPTIC_STUFFS)
    things = np.array(PANOPTIC_THINGS)
    preds, target = np.zeros((2, n, gh, gw, 2), np.int32)
    for i in range(n):
        k = int(rng.integers(1, max_segments + 1))
        centres = rng.uniform(0, 1, size=(k, 2)) * (gh, gw)
        seg = ((yy[..., None] - centres[:, 0]) ** 2 + (xx[..., None] - centres[:, 1]) ** 2).argmin(-1)
        seg_cat = cats[rng.integers(0, len(cats), size=k)]
        inst = np.where(np.isin(seg_cat, things), np.arange(1, k + 1), 0)
        target[i] = np.stack([seg_cat[seg], inst[seg]], -1)
        target[i][rng.random((gh, gw)) < 0.05] = (PANOPTIC_VOID, 0)
        moved = rng.random((gh, gw)) < 0.15
        pseg = np.where(moved, np.roll(seg, 1, axis=1), seg)
        pcat = np.where(rng.random(k) < 0.1, cats[rng.integers(0, len(cats), size=k)], seg_cat)
        preds[i] = np.stack([pcat[pseg], inst[pseg]], -1)

    def full(a):
        return np.ascontiguousarray(a.repeat(cell, axis=1).repeat(cell, axis=2))

    return full(preds), full(target)


def panoptic_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality, PanopticQuality

    return {"pq": PanopticQuality(PANOPTIC_THINGS, PANOPTIC_STUFFS, return_sq_and_rq=True, device=device),
            "mpq": ModifiedPanopticQuality(PANOPTIC_THINGS, PANOPTIC_STUFFS, device=device)}


def panoptic_values(metrics: dict) -> dict:
    """Each metric's value, and PQ's per-class (pq, sq, rq) from the same states."""
    pq = metrics["pq"]
    pq.return_per_class = True
    per_class = fresh_compute(pq)
    pq.return_per_class = False
    return {**{name: fresh_compute(metric) for name, metric in metrics.items()}, "pq_per_class": per_class}


def panoptic_run(metrics: dict, batches: list) -> dict:
    """Update every metric with every batch: per batch, the ms of each metric's host
    statistics (``_host_batch_state``: the batch's numpy sums and their copy to the
    metric's device) and, on the card, the ms of the whole update that ran them."""
    timed = next(iter(metrics.values())).device.type == "cuda"
    ms = {name: [] for name in metrics}
    host = {name: [] for name in metrics}

    def clocked(inner, record: list):
        def call(*args, **kwargs):
            start = time.perf_counter()
            out = inner(*args, **kwargs)
            record.append((time.perf_counter() - start) * 1e3)
            return out
        return call

    for name, metric in metrics.items():
        metric._host_batch_state = clocked(metric._host_batch_state, host[name])
    try:
        for preds, target in batches:
            for name, metric in metrics.items():
                if timed:
                    ms[name].append(synced_ms(lambda: metric.update(preds, target)))
                else:
                    metric.update(preds, target)
    finally:
        for metric in metrics.values():
            metric.__dict__.pop("_host_batch_state", None)
    return {"update_ms": ms, "host_ms": host}


def panoptic_phase(card: str) -> None:
    clock = [("start", time.perf_counter())]
    preds, target = panoptic_maps(np.random.default_rng(14), PANOPTIC_IMAGES)
    batches = [(torch.from_numpy(p), torch.from_numpy(t)) for p, t in
               zip(np.split(preds, PANOPTIC_IMAGES // PANOPTIC_BATCH), np.split(target, PANOPTIC_IMAGES // PANOPTIC_BATCH))]
    clock.append(("data", time.perf_counter()))
    metrics, cpu_metrics = panoptic_metrics(), panoptic_metrics("cpu")
    run = panoptic_run(metrics, batches)
    clock.append(("card", time.perf_counter()))
    panoptic_run(cpu_metrics, batches)
    clock.append(("cpu", time.perf_counter()))
    for name, metric in metrics.items():
        if any(t.device.type != "cuda" for t in metric._state.values()):
            raise AssertionError(f"panoptic {name}: a state left the card")
        if not states_equal({k: v.cpu() for k, v in metric._state.items()}, cpu_metrics[name]._state):
            raise AssertionError(f"panoptic {name}: states differ from the CPU port's")
    values = {}
    for (name, got), want in zip(panoptic_values(metrics).items(), panoptic_values(cpu_metrics).values()):
        got = got.cpu()
        if not torch.equal(torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(want, nan=-1.0)):
            raise AssertionError(f"panoptic {name}: {got} on the card, {want} on the CPU")
        values[name] = summary(got)
    # the host's share of each update, from the clocks of that same update
    host_ms, ms = run["host_ms"], run["update_ms"]
    shares = {name: median([h / u for h, u in zip(host_ms[name], ms[name])]) for name in metrics}
    emit({"phase": "panoptic", "images": PANOPTIC_IMAGES, "batch": PANOPTIC_BATCH, "shape": list(PANOPTIC_SHAPE),
          "categories": {"things": len(PANOPTIC_THINGS), "stuffs": len(PANOPTIC_STUFFS)},
          "reduced": f"{PANOPTIC_IMAGES} of val2017's 5000 images",
          "update_ms": {name: median(v) for name, v in ms.items()},
          "host_ms_of_an_update": {name: median(v) for name, v in host_ms.items()},
          "host_share": shares, "segments_per_image": [1, PANOPTIC_MAX_SEGMENTS],
          "states": "bit for bit", "values": values, "seconds": clock_seconds(clock), "card": card})


# ---------------------------------------------------------------------------
# retrieval (slice 12): an MS MARCO passage dev-small re-ranking run
# ---------------------------------------------------------------------------

MSMARCO_QUERIES = 6980  # dev-small's queries
MSMARCO_DEPTH = 1000  # BM25 candidates a query
MSMARCO_IDS = 1_102_400  # query ids are sparse, up to about 1.1M
MSMARCO_UPDATE_QUERIES = 100  # each query's candidates arrive together, 100 queries an update
MSMARCO_JUDGED = (0.94, 0.055, 0.005)  # 1, 2 or 3 judged passages: 1.065 a query, as dev-small's qrels
MSMARCO_RECALL = 0.86  # a judged passage among BM25's 1,000 candidates
MSMARCO_SIGNED_ZERO_QUERIES = 8  # queries that carry exact +0.0 and -0.0 scores
TREC_QUERIES = 43  # TREC DL 2019 passage: judged queries
TREC_GAINS = (0.9, 0.05, 0.03, 0.02)  # graded 0-3, about a tenth of the candidates above 0
MAX_FPR_QUERIES = 256  # RetrievalAUROC(max_fpr=0.1) loops over the queries on the host
VALUE_ATOL = 1e-7  # below magnitude 1e-1, with VALUE_RTOL above


def bf16_logits(gen: torch.Generator, shape, mean: float, std: float, device: str) -> torch.Tensor:
    """Cross-encoder logits: normal, rounded to bfloat16 and held as float32."""
    logits = torch.randn(shape, generator=gen, device=device) * std + mean
    return logits.to(torch.bfloat16).to(torch.float32)


def msmarco_inputs(queries: int = MSMARCO_QUERIES, depth: int = MSMARCO_DEPTH,
                   update_queries: int = MSMARCO_UPDATE_QUERIES, seed: int = 41, device: str = "cuda") -> dict:
    """A re-ranking run in MS MARCO dev-small's shape: ``queries`` sparse query ids
    (int64), ``depth`` candidates each in BM25 order, binary relevance (1-3 judged
    passages a query, each among the candidates with probability ``MSMARCO_RECALL``,
    nearer the top more often), cross-encoder logits in bfloat16 (negatives about
    N(-2, 2), positives about N(3, 2)), and a few queries with exact +0.0 and -0.0
    scores. Returns the update batches ``(preds, target, indexes)`` and the run's shares
    of queries without a positive and of tied scores within a query."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.choice(MSMARCO_IDS, size=queries, replace=False).astype(np.int64))
    judged = rng.choice(len(MSMARCO_JUDGED), size=queries, p=MSMARCO_JUDGED) + 1
    target = np.zeros((queries, depth), np.int64)
    for q in range(queries):
        found = rng.random(judged[q]) < MSMARCO_RECALL
        ranks = np.minimum(rng.geometric(8.0 / depth, size=found.sum()) - 1, depth - 1)
        target[q, ranks] = 1
    gen = torch.Generator(device=device).manual_seed(seed)
    target = torch.from_numpy(target).to(device)
    preds = torch.where(target > 0, bf16_logits(gen, target.shape, 3.0, 2.0, device),
                        bf16_logits(gen, target.shape, -2.0, 2.0, device))
    for q in rng.choice(queries, size=min(MSMARCO_SIGNED_ZERO_QUERIES, queries), replace=False):
        preds[q, :4] = torch.tensor([0.0, -0.0, 0.0, -0.0], device=device)
    indexes = ids.to(device)[:, None].expand(queries, depth)
    ordered = preds.sort(-1).values
    tied = torch.zeros_like(ordered, dtype=torch.bool)
    tied[:, 1:] |= ordered[:, 1:] == ordered[:, :-1]
    tied[:, :-1] |= ordered[:, :-1] == ordered[:, 1:]
    batches = [tuple(x[i:i + update_queries].reshape(-1) for x in (preds, target, indexes))
               for i in range(0, queries, update_queries)]
    return {"batches": batches, "empty_share": float((target.sum(-1) == 0).double().mean()),
            "tie_share": float(tied.double().mean()), "rows": queries * depth}


def trec_inputs(queries: int = TREC_QUERIES, depth: int = MSMARCO_DEPTH, seed: int = 43, device: str = "cuda"):
    """A TREC DL 2019 passage-shaped set: ``queries`` x ``depth`` candidates, graded
    gains 0-3 (about a tenth above 0), logits that rise with the gain, in bfloat16."""
    rng = np.random.default_rng(seed)
    gains = torch.from_numpy(rng.choice(len(TREC_GAINS), size=(queries, depth), p=TREC_GAINS)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    preds = bf16_logits(gen, gains.shape, 0.0, 2.0, device) + 1.5 * gains - 2.0
    ids = torch.from_numpy(rng.choice(MSMARCO_IDS, size=queries, replace=False).astype(np.int64)).to(device)
    return preds.reshape(-1), gains.reshape(-1), ids[:, None].expand(queries, depth).reshape(-1)


def retrieval_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch import retrieval as r

    return {
        "mrr@10": r.RetrievalMRR(top_k=10, device=device),
        "map": r.RetrievalMAP(device=device),
        "map_median_skip": r.RetrievalMAP(aggregation="median", empty_target_action="skip", device=device),
        "ndcg@10": r.RetrievalNormalizedDCG(top_k=10, device=device),
        "precision@10": r.RetrievalPrecision(top_k=10, device=device),
        "recall@100": r.RetrievalRecall(top_k=100, device=device),
        "hit_rate@10": r.RetrievalHitRate(top_k=10, device=device),
        "fall_out@10": r.RetrievalFallOut(top_k=10, device=device),
        "r_precision": r.RetrievalRPrecision(device=device),
        "auroc": r.RetrievalAUROC(device=device),
        "pr_curve@100": r.RetrievalPrecisionRecallCurve(max_k=100, device=device),
        "recall@precision0.05": r.RetrievalRecallAtFixedPrecision(min_precision=0.05, max_k=100, device=device),
    }


def run_retrieval(metrics: dict, batches: list, timed: bool = True) -> dict:
    """Every batch into every metric, then each ``compute()``: name -> states, value and,
    when ``timed``, the median update ms and the ms of a first and a second compute
    (host clock, synchronised; the first loads the kernels no earlier phase ran)."""
    out = {}
    for name, metric in metrics.items():
        times = [synced_ms(lambda: metric.update(*batch)) if timed else metric.update(*batch) for batch in batches]
        compute_ms = [synced_ms(lambda: fresh_compute(metric)) for _ in range(2)] if timed else None
        out[name] = {"value": fresh_compute(metric), "states": metric._concat_state(),
                     "update_ms": median(times) if timed else None, "compute_ms": compute_ms}
    return out


def value_diff(got: torch.Tensor, want: torch.Tensor, absolute: bool = False) -> float:
    """How far ``got`` is from ``want`` in units of the value tolerance (relative
    ``VALUE_RTOL``, absolute ``VALUE_ATOL`` below magnitude 1e-1, or absolute throughout):
    at most 1 passes. Equal values (infinities too) pass, NaN must be in the same places,
    integers and dtypes equal."""
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return math.inf
    if not want.is_floating_point():
        return 0.0 if torch.equal(got, want) else math.inf
    got, want = got.double(), want.double()
    if not torch.equal(got.isnan(), want.isnan()):
        return math.inf
    keep = ~want.isnan() & (got != want)
    if not bool(keep.any()):
        return 0.0
    scale = torch.full_like(want, VALUE_ATOL) if absolute else torch.where(
        want.abs() < 0.1, VALUE_ATOL, VALUE_RTOL * want.abs())
    return float(((got - want).abs() / scale)[keep].max())


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaN payloads and signed zeros too)."""
    got, want = got.cpu(), want.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got, want)


def hold_retrieval(label: str, got: dict, want: dict) -> dict:
    """States bit for bit, values (``ks`` and ``best_k`` equal) within the retrieval
    tolerance. Returns each value's difference in tolerance units."""
    worst = {}
    for name, entry in want.items():
        mine, theirs = got[name]["states"], entry["states"]
        if list(mine) != list(theirs) or not all(same_bits(mine[k], theirs[k]) for k in theirs):
            raise AssertionError(f"{label} {name}: states differ from the CPU's")
        values = [tree_leaves(got[name]["value"]), tree_leaves(entry["value"])]
        if list(values[0]) != list(values[1]):
            raise AssertionError(f"{label} {name}: values {list(values[0])} against {list(values[1])}")
        diffs = [value_diff(a, b) for a, b in zip(values[0].values(), values[1].values())]
        if not max(diffs) <= 1.0:
            raise AssertionError(f"{label} {name}: {values[0]} on the card, {values[1]} on the CPU")
        worst[name] = max(diffs)
    return worst


def retrieval_edge_inputs():
    """Five queries (ids 2-11) on the host: one with +-0.0, NaN and +-inf scores, one
    of a single document, one all positive, one all negative, and one with ignored (-1)
    targets; ``skip`` of the all-negative query leaves an even count for the median."""
    preds = torch.tensor([0.5, -0.0, 0.0, float("nan"), float("inf"), -float("inf"), 0.25, 0.5,  # id 5
                          0.75,  # id 9
                          0.1, 0.3, 0.3,  # id 2
                          0.9, 0.2, 0.4, 0.4,  # id 7
                          0.6, 0.2, 0.8, 0.1, 0.7, 0.3])  # id 11
    target = torch.tensor([1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, -1, 0, -1, 1, 0])
    indexes = torch.tensor([5] * 8 + [9] + [2] * 3 + [7] * 4 + [11] * 6)
    return preds, target, indexes


def retrieval_edge_results(device) -> dict:
    """The edge queries through each empty-target action, ``ignore_index``, top-k beyond
    a query's length, ``adaptive_k`` and the median of an even count; ``error`` must raise."""
    from torchmetrics_tpu_torch import retrieval as r

    preds, target, indexes = (t.to(device) for t in retrieval_edge_inputs())
    out = {}
    for action in ("neg", "pos", "skip"):
        kw = {"empty_target_action": action, "ignore_index": -1, "device": device}
        built = {"map_median": r.RetrievalMAP(aggregation="median", **kw),
                 "ndcg@50": r.RetrievalNormalizedDCG(top_k=50, **kw),
                 "precision@50_adaptive": r.RetrievalPrecision(top_k=50, adaptive_k=True, **kw),
                 "mrr@2": r.RetrievalMRR(top_k=2, **kw), "fall_out": r.RetrievalFallOut(**kw),
                 "auroc": r.RetrievalAUROC(**kw), "r_precision": r.RetrievalRPrecision(**kw),
                 "pr_curve@8_adaptive": r.RetrievalPrecisionRecallCurve(max_k=8, adaptive_k=True, **kw)}
        for name, metric in built.items():
            metric.update(preds, target, indexes)
            out[f"{name}_{action}"] = {"value": metric.compute(), "states": metric._concat_state()}
    error = r.RetrievalMAP(empty_target_action="error", ignore_index=-1, device=device)
    error.update(preds, target, indexes)
    try:
        error.compute()
    except ValueError:
        pass
    else:
        raise AssertionError(f"retrieval edges: empty_target_action='error' did not raise on {device}")
    return out


def retrieval_phase(card: str) -> None:
    import warnings

    from torchmetrics_tpu_torch import retrieval as r
    from torchmetrics_tpu_torch.functional.retrieval.utils import _pad_queries

    clock = [("start", time.perf_counter())]
    data = msmarco_inputs()
    cpu_batches = [tuple(t.cpu() for t in batch) for batch in data["batches"]]
    clock.append(("inputs", time.perf_counter()))
    metrics = retrieval_metrics()
    card_run = run_retrieval(metrics, data["batches"])
    clock.append(("card", time.perf_counter()))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cpu_run = run_retrieval(retrieval_metrics("cpu"), cpu_batches, timed=False)
    clock.append(("cpu", time.perf_counter()))
    worst = hold_retrieval("retrieval", card_run, cpu_run)
    state = card_run["map"]["states"]
    layout = _pad_queries(state["indexes"], state["preds"], state["target"])
    cpu_state = cpu_run["map"]["states"]
    for got, want in zip(layout, _pad_queries(cpu_state["indexes"], cpu_state["preds"], cpu_state["target"])):
        if not same_bits(got, want):
            raise AssertionError("retrieval: the padded layout differs from the CPU's")
    # TREC DL 2019: graded gains at 10 and at full depth
    trec = trec_inputs()
    trec_values = {}
    for top_k in (10, None):
        card_ndcg, cpu_ndcg = (r.RetrievalNormalizedDCG(top_k=top_k, device=d) for d in (None, "cpu"))
        card_ndcg.update(*trec)
        cpu_ndcg.update(*(t.cpu() for t in trec))
        got, want = card_ndcg.compute(), cpu_ndcg.compute()
        if not value_diff(got, want) <= 1.0:
            raise AssertionError(f"retrieval trec ndcg@{top_k}: {got} on the card, {want} on the CPU")
        trec_values[f"ndcg@{top_k or 'all'}"] = float(got)
    # RetrievalAUROC(max_fpr=0.1): one binary_auroc a query, on a prefix of the queries
    rows = MAX_FPR_QUERIES * MSMARCO_DEPTH
    prefix = [torch.cat([b[i] for b in data["batches"]])[:rows] for i in range(3)]
    partial, cpu_partial = (r.RetrievalAUROC(max_fpr=MAX_FPR, device=d) for d in (None, "cpu"))
    partial.update(*prefix)
    cpu_partial.update(*(t.cpu() for t in prefix))
    partial_ms = synced_ms(lambda: fresh_compute(partial))
    if not value_diff(partial.compute(), cpu_partial.compute()) <= 1.0:
        raise AssertionError(f"retrieval max_fpr: {partial.compute()} on the card, {cpu_partial.compute()} on the CPU")
    clock.append(("trec_and_max_fpr", time.perf_counter()))
    edges = retrieval_edge_results("cuda")
    edge_worst = hold_retrieval("retrieval edges", edges, retrieval_edge_results("cpu"))
    peak = {name: compute_peak_bytes(metrics[name]) for name in ("map", "ndcg@10", "auroc", "pr_curve@100")}
    clock.append(("edges_and_peaks", time.perf_counter()))
    emit({"phase": "retrieval", "queries": MSMARCO_QUERIES, "depth": MSMARCO_DEPTH, "rows": data["rows"],
          "updates": len(data["batches"]), "queries_without_positive": data["empty_share"],
          "tied_score_share": data["tie_share"],
          "update_ms": {name: entry["update_ms"] for name, entry in card_run.items()},
          "compute_ms_first_second": {name: entry["compute_ms"] for name, entry in card_run.items()},
          "values": {name: {k: summary(v) for k, v in tree_leaves(entry["value"]).items()}
                     for name, entry in card_run.items()},
          "max_diff_in_tolerance_units": max(worst.values()), "states": "bit for bit",
          "padded_layout": "bit for bit", "trec_dl_2019": trec_values,
          "max_fpr": {"queries": MAX_FPR_QUERIES, "compute_ms": partial_ms, "ms_per_query": partial_ms / MAX_FPR_QUERIES,
                      "value": float(partial.compute())},
          "edges": {"cases": len(edges), "max_diff_in_tolerance_units": max(edge_worst.values())},
          "compute_peak_extra_bytes": peak, "state_bytes": metric_state_bytes(metrics["map"]),
          "seconds": clock_seconds(clock), "card": card})
    for name in ("ndcg@10", "map"):
        profile_step(f"retrieval_{name}_compute", lambda: fresh_compute(metrics[name]))


# ---------------------------------------------------------------------------
# segmentation (slice 12): Cityscapes val, and BraTS 2021-shaped MRI volumes
# ---------------------------------------------------------------------------

CITYSCAPES_FRAMES = 500  # val
CITYSCAPES_SHAPE = (1024, 2048)
CITYSCAPES_CLASSES = 19  # the training classes
CITYSCAPES_BATCH = 8
CITYSCAPES_VOID = 255
CITYSCAPES_VOID_SHARE = 0.1
CITYSCAPES_CPU_UPDATES = 2  # the CPU port reads the first 16 frames
# the classes' pixel shares, roughly Cityscapes': road, sidewalk, building, wall, fence,
# pole, traffic light, traffic sign, vegetation, terrain, sky, person, rider, car, truck,
# bus, train, motorcycle, bicycle
CITYSCAPES_SHARES = (0.37, 0.055, 0.22, 0.006, 0.008, 0.015, 0.002, 0.006, 0.17, 0.008, 0.035, 0.012, 0.002,
                     0.065, 0.0025, 0.002, 0.002, 0.001, 0.004)
CITYSCAPES_CELLS = (16, 32)  # the random fields' cells over a frame: the regions' scale
CITYSCAPES_NOISE = 0.05  # the prediction's field noise: boundary errors
CITYSCAPES_SWAPS = 1  # classes a frame's prediction confuses for another
BRATS_SHAPE = (240, 240, 155)  # 1 mm isotropic, the MSD Task01 layout
BRATS_VOLUMES = 16
BRATS_BATCH = 2
BRATS_CLASSES = 4  # background, necrotic core, oedema, enhancing (BraTS's label 4 as 3)
BRATS_WT_VOXELS = (20_000, 120_000)  # whole tumour, 20-120 cm3
BRATS_SHIFT = 3  # the prediction's shift in voxels, at most
BRATS_SCALE = 0.1  # and its scale, +-10%
BRATS_STRAYS = (2, 5)  # stray blobs a prediction
SEGMENTATION_RTOL = 1e-6


def cityscapes_batch(gen: torch.Generator, frames: int, shape=CITYSCAPES_SHAPE, classes: int = CITYSCAPES_CLASSES,
                     device: str = "cuda"):
    """``frames`` (prediction, target) label maps, int64 ``(frames, H, W)``: the target's
    regions are the argmax of smooth random class fields biased by the classes' pixel
    shares, with void (255) on about a tenth of the pixels in blobs; the prediction is
    the argmax of the same fields plus smooth noise (errors along the boundaries), with
    ``CITYSCAPES_SWAPS`` classes a frame confused for another."""
    cells = CITYSCAPES_CELLS
    shares = torch.tensor(CITYSCAPES_SHARES[:classes], device=device)
    bias = (shares / shares.sum()).log()[None, :, None, None] * 0.5

    def smooth(channels, size):
        field = torch.randn((frames, channels, *size), generator=gen, device=device)
        return torch.nn.functional.interpolate(field, size=shape, mode="bicubic", align_corners=False)

    field = smooth(classes, cells) + bias
    target = field.argmax(1)
    noise = smooth(classes, (cells[0] * 4, cells[1] * 4))
    pred = (field + CITYSCAPES_NOISE * noise).argmax(1)
    del field, noise
    swap = torch.arange(classes, device=device).repeat(frames, 1)
    picks = torch.randint(0, classes, (frames, CITYSCAPES_SWAPS, 2), generator=gen, device=device)
    swap.scatter_(1, picks[..., 0], picks[..., 1])
    pred = swap.gather(1, pred.reshape(frames, -1)).reshape(pred.shape)
    void = smooth(1, cells)[:, 0]
    cut = torch.quantile(void[:, ::8, ::8].reshape(-1).float(), 1 - CITYSCAPES_VOID_SHARE)
    target = torch.where(void > cut, CITYSCAPES_VOID, target)
    return pred, target


def segmentation_metrics(device=None, classes: int = CITYSCAPES_CLASSES) -> dict:
    from torchmetrics_tpu_torch import segmentation as s

    return {"miou": s.MeanIoU(classes, input_format="index", device=device),
            "miou_per_class": s.MeanIoU(classes, per_class=True, input_format="index", device=device),
            "dice_macro": s.DiceScore(classes, input_format="index", average="macro", device=device),
            "generalized_dice": s.GeneralizedDiceScore(classes, input_format="index", device=device)}


def hold_segmentation(label: str, got: dict, want: dict) -> dict:
    """Metric by metric: states float32 and bit for bit (the counts and ``DiceScore``'s
    rows), but the float sums (``MeanIoU``'s and ``GeneralizedDiceScore``'s ``score``)
    within ``SEGMENTATION_RTOL``; values within it."""
    worst = {"sums": 0.0, "values": 0.0}
    for name, metric in want.items():
        mine = got[name]
        for key, value in metric._concat_state().items():
            card = mine._concat_state()[key].cpu()
            if card.dtype != torch.float32 or card.dtype != value.dtype or card.shape != value.shape:
                raise AssertionError(f"{label} {name} {key}: {card.dtype}{tuple(card.shape)} against "
                                     f"{value.dtype}{tuple(value.shape)}")
            if key == "score":
                diff = largest_rel_diff(card, value)
                if not diff <= SEGMENTATION_RTOL:
                    raise AssertionError(f"{label} {name} {key}: differs by {diff} relative")
                worst["sums"] = max(worst["sums"], diff)
            elif not torch.equal(card, value):
                raise AssertionError(f"{label} {name} {key}: states differ from the CPU's")
        diff = largest_rel_diff(fresh_compute(mine), fresh_compute(metric))
        if not diff <= SEGMENTATION_RTOL:
            raise AssertionError(f"{label} {name}: values differ by {diff} relative")
        worst["values"] = max(worst["values"], diff)
    return worst


def segmentation_edge_results(device) -> dict:
    """Small inputs, the same on the card and the CPU: an absent class (Hausdorff 0,
    per-class IoU -1), float logits with argmax ties, multi-hot one-hot input, the
    background in and out, anisotropic 3-D spacing, chessboard and taxicab."""
    from torchmetrics_tpu_torch import functional as f

    gen = torch.Generator().manual_seed(47)
    index_p = torch.randint(0, 4, (2, 24, 20), generator=gen)
    index_t = torch.randint(0, 4, (2, 24, 20), generator=gen)
    index_p[index_p == 2] = 0
    index_t[index_t == 2] = 1  # class 2 is absent
    logits = torch.randint(-1, 2, (2, 4, 24, 20), generator=gen).float()  # argmax ties
    multi_p = torch.randint(0, 2, (2, 4, 24, 20), generator=gen)
    multi_t = torch.randint(0, 2, (2, 4, 24, 20), generator=gen)
    vol_p = torch.randint(0, 2, (1, 3, 12, 10, 9), generator=gen)
    vol_t = torch.randint(0, 2, (1, 3, 12, 10, 9), generator=gen)
    ip, it, lg, mp, mt, vp, vt = (x.to(device) for x in (index_p, index_t, logits, multi_p, multi_t, vol_p, vol_t))
    out = {}
    for background in (True, False):
        out[f"miou_per_class_absent_{background}"] = f.mean_iou(ip, it, 4, background, True, "index")
        out[f"hausdorff_absent_{background}"] = f.hausdorff_distance(ip, it, 4, background, input_format="index")
        out[f"dice_logits_{background}"] = f.dice_score(lg, mt, 4, background, "none")
        out[f"dice_multi_hot_{background}"] = f.dice_score(mp, mt, 4, background, "weighted")
        out[f"generalized_dice_mixed_{background}"] = f.generalized_dice_score(lg, it, 4, background, True,
                                                                               input_format="mixed")
    for metric in ("euclidean", "chessboard", "taxicab"):
        out[f"hausdorff_3d_{metric}"] = f.hausdorff_distance(vp, vt, 3, True, metric, spacing=[0.7, 1.3, 2.9])
        out[f"hausdorff_3d_{metric}_directed"] = f.hausdorff_distance(vp, vt, 3, True, metric, directed=True,
                                                                      spacing=[0.7, 1.3, 2.9])
    if not bool((out["miou_per_class_absent_True"][:, 2] == -1).all()):
        raise AssertionError(f"segmentation edges: an absent class's IoU is not -1 on {device}")
    if not bool((out["hausdorff_absent_False"][:, 1] == 0).all()):
        raise AssertionError(f"segmentation edges: an absent class's Hausdorff distance is not 0 on {device}")
    return out


def segmentation_phase(card: str) -> None:
    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(53)
    metrics = segmentation_metrics()
    cpu_metrics = segmentation_metrics("cpu")
    ms, frames, update_batches = [], 0, []
    snapshot = None
    while frames < CITYSCAPES_FRAMES:
        n = min(CITYSCAPES_BATCH, CITYSCAPES_FRAMES - frames)
        batch = cityscapes_batch(gen, n)
        ms.append(synced_ms(lambda: [m.update(*batch) for m in metrics.values()]))
        if len(update_batches) < CITYSCAPES_CPU_UPDATES:
            update_batches.append(tuple(t.cpu() for t in batch))
            if len(update_batches) == CITYSCAPES_CPU_UPDATES:
                snapshot = {name: m.clone() for name, m in metrics.items()}
        frames += n
    clock.append(("card", time.perf_counter()))
    for batch in update_batches:
        for m in cpu_metrics.values():
            m.update(*batch)
    clock.append(("cpu", time.perf_counter()))
    worst = hold_segmentation("segmentation", snapshot, cpu_metrics)
    values = {name: m.compute() for name, m in metrics.items()}
    miou = float(values["miou"])
    if not (0.6 <= miou <= 0.8 and all(bool(torch.isfinite(v).all()) for v in values.values()
                                       if v.numel() == 1)):
        raise AssertionError(f"segmentation: {values}")
    edges = segmentation_edge_results("cuda")
    edge_worst = 0.0
    for name, want in segmentation_edge_results("cpu").items():
        got = edges[name].cpu()
        diff = 0.0 if torch.equal(got, want) else largest_rel_diff(got, want)
        if not ((name.startswith("hausdorff") and diff == 0.0) or diff <= SEGMENTATION_RTOL):
            raise AssertionError(f"segmentation edges {name}: {got} on the card, {want} on the CPU")
        edge_worst = max(edge_worst, diff)
    probe = segmentation_metrics()
    batch = cityscapes_batch(gen, CITYSCAPES_BATCH)
    peak = {name: update_peak_bytes(m, batch) for name, m in probe.items()}
    read = sum(t.numel() * t.element_size() for t in batch)
    clock.append(("checks", time.perf_counter()))
    update_ms = median(ms[:-1])
    emit({"phase": "segmentation", "frames": CITYSCAPES_FRAMES, "shape": list(CITYSCAPES_SHAPE),
          "classes": CITYSCAPES_CLASSES, "batch": CITYSCAPES_BATCH, "updates": len(ms),
          "update_ms_all_four": update_ms, "frames_per_s": CITYSCAPES_BATCH / update_ms * 1e3,
          "update_ms_each": {name: synced_ms(lambda: m.update(*batch)) for name, m in probe.items()},
          "void_share": float((batch[1] == CITYSCAPES_VOID).double().mean()),
          "values": {name: summary(v) for name, v in values.items()}, "miou": miou,
          "cpu_updates": CITYSCAPES_CPU_UPDATES, "max_sum_rel_diff": worst["sums"],
          "max_value_rel_diff": worst["values"], "edges": {"cases": len(edges), "max_rel_diff": edge_worst},
          "update_peak_extra_bytes": peak, "bytes_read_per_update": read,
          "read_bound_ms_per_metric": read / PEAK_BYTES_PER_S * 1e3, "seconds": clock_seconds(clock), "card": card})
    profile_step("segmentation_update_all_four", lambda: [m.update(*batch) for m in probe.values()])


def ellipsoid(grid, center, radii, noise: torch.Tensor) -> torch.Tensor:
    """Voxels within a noisy ellipsoid: scaled distance below ``1 + noise``."""
    d = sum(((g - c) / r) ** 2 for g, c, r in zip(grid, center, radii))
    return d <= (1.0 + noise) ** 2


def brats_volume(rng, shape=BRATS_SHAPE, device: str = "cuda", wt_voxels=BRATS_WT_VOXELS):
    """One (prediction, target) pair of int64 label volumes: nested noisy ellipsoids
    (whole tumour of ``wt_voxels`` voxels; within it the tumour core, necrotic core (1)
    inside enhancing (3); oedema (2) the rest), and a prediction of the same ellipsoids
    shifted by up to ``BRATS_SHIFT`` voxels, scaled by up to ``BRATS_SCALE`` and given
    a few stray blobs."""
    grid = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=device) for s in shape], indexing="ij")
    size = np.asarray(shape, np.float64)
    volume = rng.uniform(*wt_voxels)
    aspect = rng.uniform(0.75, 1.3, 3)
    radii = (3 * volume / (4 * np.pi) / aspect.prod()) ** (1 / 3) * aspect
    center = rng.uniform(0.3, 0.7, 3) * size
    core = (center + rng.uniform(-0.15, 0.15, 3) * radii, radii * rng.uniform(0.45, 0.6))
    necrotic = (core[0] + rng.uniform(-0.1, 0.1, 3) * core[1], core[1] * rng.uniform(0.4, 0.6))

    def noise():
        cells = torch.from_numpy(rng.normal(0, 0.12, (1, 1, 6, 6, 4)).astype(np.float32)).to(device)
        return torch.nn.functional.interpolate(cells, size=shape, mode="trilinear", align_corners=False)[0, 0]

    def labels(shift, scale):
        wt = ellipsoid(grid, center + shift, radii * scale, noise())
        tc = ellipsoid(grid, core[0] + shift, core[1] * scale, noise()) & wt
        ncr = ellipsoid(grid, necrotic[0] + shift, necrotic[1] * scale, noise()) & tc
        return torch.where(ncr, 1, torch.where(tc, 3, torch.where(wt, 2, 0)))

    target = labels(np.zeros(3), 1.0)
    pred = labels(rng.integers(-BRATS_SHIFT, BRATS_SHIFT + 1, 3), rng.uniform(1 - BRATS_SCALE, 1 + BRATS_SCALE))
    for _ in range(rng.integers(*BRATS_STRAYS)):
        blob = ellipsoid(grid, rng.uniform(0.15, 0.85, 3) * size, np.full(3, rng.uniform(2.0, 5.0)),
                         torch.zeros((), device=device))
        pred = torch.where(blob, int(rng.integers(1, BRATS_CLASSES)), pred)
    return pred, target


def brats_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch import segmentation as s

    return {"dice": s.DiceScore(BRATS_CLASSES, include_background=False, input_format="index", average="none",
                                device=device),
            "hausdorff": s.HausdorffDistance(BRATS_CLASSES, input_format="index", distance_metric="euclidean",
                                             spacing=[1.0, 1.0, 1.0], directed=True, device=device)}


def host_reads(call) -> int:
    """The synchronising calls (host reads) of ``call`` on the card, counted by
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def edge_counts(pred: torch.Tensor, target: torch.Tensor, classes: int = BRATS_CLASSES):
    """Edge voxels per (volume, class) of index volumes, background left out, and the
    directed distances the Hausdorff update evaluates (``E_pred x E_target`` a pair)."""
    from torchmetrics_tpu_torch.functional.segmentation.utils import _mask_edges, _segmentation_inputs_format

    p, t = _segmentation_inputs_format(pred, target, False, classes, "index")
    ep, et = (_mask_edges(x).flatten(2).sum(-1) for x in (p, t))
    return ep.cpu(), et.cpu(), int((ep * et).sum())


def segmentation_3d_phase(card: str) -> None:
    clock = [("start", time.perf_counter())]
    rng = np.random.default_rng(59)
    volumes = [brats_volume(rng) for _ in range(BRATS_VOLUMES)]
    batches = [tuple(torch.stack(x) for x in zip(*volumes[i:i + BRATS_BATCH]))
               for i in range(0, BRATS_VOLUMES, BRATS_BATCH)]
    clock.append(("inputs", time.perf_counter()))
    metrics = brats_metrics()
    hd_ms, dice_ms = [], []
    for i, batch in enumerate(batches):
        dice_ms.append(synced_ms(lambda: metrics["dice"].update(*batch)))
        hd_ms.append(synced_ms(lambda: metrics["hausdorff"].update(*batch)))
        if i == 0:
            first = {name: m.clone() for name, m in metrics.items()}
    clock.append(("card", time.perf_counter()))
    cpu_metrics = brats_metrics("cpu")
    for m in cpu_metrics.values():
        m.update(*(t.cpu() for t in batches[0]))
    clock.append(("cpu", time.perf_counter()))
    for name, m in cpu_metrics.items():
        if not states_equal({k: v.cpu() for k, v in first[name]._concat_state().items()}, m._concat_state()):
            raise AssertionError(f"segmentation_3d {name}: states differ from the CPU's")
    values = {name: m.compute() for name, m in metrics.items()}
    if not bool(torch.isfinite(values["hausdorff"])) or not bool(((values["dice"] >= 0) & (values["dice"] <= 1)).all()):
        raise AssertionError(f"segmentation_3d: {values}")
    counts = [edge_counts(*batch) for batch in batches]
    probe = brats_metrics()["hausdorff"]
    reads = host_reads(lambda: probe.update(*batches[0]))
    clock.append(("checks", time.perf_counter()))
    edges_pred = torch.cat([c[0] for c in counts]).float()
    edges_target = torch.cat([c[1] for c in counts]).float()
    emit({"phase": "segmentation_3d", "volumes": BRATS_VOLUMES, "shape": list(BRATS_SHAPE), "batch": BRATS_BATCH,
          "spacing_mm": [1.0, 1.0, 1.0], "updates": len(batches),
          "hausdorff_update_ms": median(hd_ms), "hausdorff_update_ms_max": max(hd_ms),
          "dice_update_ms": median(dice_ms),
          "edge_voxels_per_volume_class": {"pred": [float(edges_pred.mean()), float(edges_pred.min()),
                                                    float(edges_pred.max())],
                                           "target": [float(edges_target.mean()), float(edges_target.min()),
                                                      float(edges_target.max())]},
          "distances_evaluated": sum(c[2] for c in counts), "host_reads_per_update": reads,
          "values": {name: summary(v) for name, v in values.items()},
          "cpu_updates": 1, "states": "bit for bit", "seconds": clock_seconds(clock), "card": card})
    profile_step("segmentation_3d_hausdorff_update", lambda: probe.update(*batches[0]))


# ---------------------------------------------------------------------------
# pairwise, procrustes, nominal and clustering (slice 13)
# ---------------------------------------------------------------------------

PAIRWISE_ROWS = 8192  # queries and passages of a dense-retrieval batch
PAIRWISE_WIDTH = 768  # a BERT-base embedding
PAIRWISE_SELF_ROWS = 4096
PAIRWISE_CPU_ROWS = 256  # the CPU port's rows for the products (the rows are independent)
PAIRWISE_CPU_DIFF_ROWS = 64  # and for manhattan and minkowski: float64 differences take seconds on the host
PAIRWISE_EXPONENT = 3
PAIRWISE_FUNCTIONS = ("cosine", "linear", "euclidean", "manhattan", "minkowski")
PRODUCTS_13 = ("cosine", "linear", "euclidean")
PAIRWISE_UNITS = 4  # card against CPU: within 4 float32 rounding units (2**-24) of the terms
PEAK_LIMIT_13 = 10**9  # a call's or a compute's bytes beyond its inputs and output
POSES = 65536
POSE_JOINTS = 17  # Human3.6M's skeleton
POSE_BATCH = 4096
POSE_PLANAR_SHARE = 0.01
SINGULAR_GAP = 1e-3  # a rotation is held where the singular values are this far apart (and from zero)
WIDE_CLOUDS = (4096, 64, 16)  # clouds, points, dimensions: wider than 3, so through torch.linalg.svd
ADULT_ROWS = 48842  # UCI Adult, train and test
# workclass, education, marital-status, occupation, relationship, race, sex, native-country
ADULT_CARDINALITIES = (9, 16, 7, 15, 6, 5, 2, 42)
ADULT_NAN_SHARE = 0.01  # Adult's missing ('?') entries
ADULT_PAIR = (1, 3)  # education against occupation, for the classes
ADULT_UPDATES = 8
CROWD = (10000, 5, 5)  # items, categories, raters
CROWD_UPDATES = 10
CLUSTER_SAMPLES = 50000  # ImageNet val
CLUSTER_CLASSES = 1000
CLUSTERS = 1000
CLUSTER_WIDTH = 768
CLUSTER_UPDATES = 50
CLUSTER_PURITY = 0.6  # a class's share in its own cluster; the rest by the clusters' uneven sizes
def pairwise_inputs(rows: int = PAIRWISE_ROWS, width: int = PAIRWISE_WIDTH, seed: int = 61, device: str = "cuda"):
    """Query and passage embeddings as a dual encoder gives them: each passage near some
    query (so the distances cancel as a retriever's do), float32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    queries = torch.randn(rows, width, generator=gen, device=device)
    near = queries[torch.randperm(rows, generator=gen, device=device)]
    return queries, 0.6 * near + 0.8 * torch.randn(rows, width, generator=gen, device=device)


def pairwise_call(name: str, x, y=None, reduction=None, **kw):
    from torchmetrics_tpu_torch.functional import pairwise as p

    fn = {"cosine": p.pairwise_cosine_similarity, "linear": p.pairwise_linear_similarity,
          "euclidean": p.pairwise_euclidean_distance, "manhattan": p.pairwise_manhattan_distance,
          "minkowski": functools.partial(p.pairwise_minkowski_distance, exponent=PAIRWISE_EXPONENT)}[name]
    return fn(x, y, reduction=reduction, **kw)


def pairwise_tolerance(name: str, x: torch.Tensor, y: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """``PAIRWISE_UNITS`` float32 rounding units of each entry's terms: ``|x_i| |y_j|``
    for linear (1 for cosine's unit rows); for euclidean the root of that many units of
    ``|x_i|^2 + |y_j|^2`` (the identity cancels); for manhattan and minkowski, sums of
    positive terms, of the value."""
    unit = PAIRWISE_UNITS * 2.0**-24
    nx, ny = x.double().norm(dim=1), y.double().norm(dim=1)
    if name == "cosine":
        return torch.full(matrix.shape, unit, dtype=torch.float64)
    if name == "linear":
        return unit * nx[:, None] * ny[None]
    if name == "euclidean":
        return (unit * (nx[:, None] ** 2 + ny[None] ** 2)).sqrt()
    return unit * matrix.double().abs()


def hold_pairwise(label: str, got: dict, want: dict, tolerances: dict) -> float:
    """Card rows ``got[key]`` against the CPU's ``want[key]`` within ``tolerances[key]``;
    NaN in the same places. Returns the largest difference in tolerance units."""
    worst = 0.0
    for key, ref in want.items():
        mine, ref, tol = got[key].cpu().double(), ref.double(), tolerances[key]
        if mine.shape != ref.shape or not torch.equal(mine.isnan(), ref.isnan()):
            raise AssertionError(f"{label} {key}: {tuple(mine.shape)} on the card, {tuple(ref.shape)} on the CPU")
        keep = ~ref.isnan() & (mine != ref)
        units = float(((mine - ref).abs() / tol)[keep].max()) if bool(keep.any()) else 0.0
        if not units <= 1.0:
            raise AssertionError(f"{label} {key}: {units} tolerance units from the CPU's")
        worst = max(worst, units)
    return worst


def pairwise_reference(x: torch.Tensor, y: torch.Tensor, rows: int, self_pairs: bool) -> tuple:
    """The CPU port's first ``rows`` rows of each function (None and "mean"; for
    ``self_pairs`` the diagonal zeroed as ``y=None`` does) and their tolerances."""
    from torchmetrics_tpu_torch.functional.pairwise.helpers import _reduce_distance_matrix

    want, tolerances = {}, {}
    for name in PAIRWISE_FUNCTIONS:
        cut = rows if name in PRODUCTS_13 else min(rows, PAIRWISE_CPU_DIFF_ROWS)
        xs = x[:cut].cpu()
        matrix = pairwise_call(name, xs, y.cpu(), zero_diagonal=self_pairs)
        tol = pairwise_tolerance(name, xs, y.cpu(), matrix)
        if self_pairs:
            tol.diagonal().zero_()
        mean = _reduce_distance_matrix(matrix, "mean")
        want[name], want[f"{name}_mean"] = matrix, mean
        tolerances[name] = tol
        tolerances[f"{name}_mean"] = tol.mean(-1) + PAIRWISE_UNITS * 2.0**-24 * mean.double().abs()
    return want, tolerances


def pairwise_phase(card: str) -> None:
    clock = [("start", time.perf_counter())]
    queries, passages = pairwise_inputs()
    selves = queries[:PAIRWISE_SELF_ROWS]
    for name in PAIRWISE_FUNCTIONS:  # load each call's kernels (cuBLAS's float64 GEMM) before the clocks
        pairwise_call(name, queries[:128], passages[:128], "mean")
    clock.append(("inputs", time.perf_counter()))
    got, ms, peaks = {}, {}, {}
    for kind, x, y in (("", queries, passages), ("self_", selves, None)):
        for name in PAIRWISE_FUNCTIONS:
            for reduction in (None, "mean"):
                key = f"{kind}{name}" + ("_mean" if reduction else "")
                out_rows = x.shape[0]
                out_bytes = out_rows * (1 if reduction else (y if y is not None else x).shape[0]) * 4
                start = time.perf_counter()
                out, peak = peak_extra_bytes(lambda: pairwise_call(name, x, y, reduction), keep=out_bytes)
                ms[key] = (time.perf_counter() - start) * 1e3
                peaks[key] = peak
                if peak > PEAK_LIMIT_13:
                    raise AssertionError(f"pairwise {key}: {peak} bytes beyond its output")
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"pairwise {key}: a value is not finite")
                got[key] = out[:PAIRWISE_CPU_ROWS if name in PRODUCTS_13 else PAIRWISE_CPU_DIFF_ROWS].cpu()
                if name in PRODUCTS_13 and reduction is None:
                    again = with_tf32(lambda: pairwise_call(name, x, y))
                    if not same_bits(again, out):
                        raise AssertionError(f"pairwise {key}: a rerun with TF32 allowed changed the bits")
                del out
    clock.append(("card", time.perf_counter()))
    want, tolerances = pairwise_reference(queries, passages, PAIRWISE_CPU_ROWS, False)
    self_want, self_tolerances = pairwise_reference(selves, selves, PAIRWISE_CPU_ROWS, True)
    clock.append(("cpu", time.perf_counter()))
    worst = hold_pairwise("pairwise", got, want, tolerances)
    worst_self = hold_pairwise("pairwise self", {k[5:]: v for k, v in got.items() if k.startswith("self_")},
                               self_want, self_tolerances)
    emit({"phase": "pairwise", "x": [PAIRWISE_ROWS, PAIRWISE_WIDTH], "y": [PAIRWISE_ROWS, PAIRWISE_WIDTH],
          "self_rows": PAIRWISE_SELF_ROWS, "exponent": PAIRWISE_EXPONENT, "call_ms": ms,
          "peak_extra_bytes_beyond_output": peaks,
          "reduced": f"the CPU port reads the first {PAIRWISE_CPU_ROWS} rows of the products and the first "
                     f"{PAIRWISE_CPU_DIFF_ROWS} of manhattan and minkowski (the rows are independent)",
          "max_diff_in_tolerance_units": max(worst, worst_self), "tf32_rerun": "bit for bit",
          "seconds": clock_seconds(clock), "card": card})
    profile_step("pairwise_cosine", lambda: pairwise_call("cosine", queries, passages))
    profile_step("pairwise_self_manhattan", lambda: pairwise_call("manhattan", selves))


def quaternion_rotations(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``(n, 3, 3)`` of unnormalised quaternions ``(n, 4)``."""
    w, x, y, z = (q / q.norm(dim=1, keepdim=True)).unbind(1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1).reshape(-1, 3, 3)


def pose_inputs(n: int = POSES, joints: int = POSE_JOINTS, seed: int = 67, device: str = "cuda"):
    """(predicted, ground-truth) 3-D poses in mm, as PA-MPJPE evaluation gives them: a
    seeded skeleton moved per pose, the prediction rotated, scaled, shifted and noisy.
    The first ``POSE_PLANAR_SHARE`` of the pairs lie in the plane z = 0 (a zero singular
    value: their rotation is not unique)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    skeleton = 300.0 * torch.randn(joints, 3, generator=gen, device=device)
    truth = skeleton + 80.0 * torch.randn(n, joints, 3, generator=gen, device=device)
    rotation = quaternion_rotations(torch.randn(n, 4, generator=gen, device=device))
    scale = 0.8 + 0.4 * torch.rand(n, 1, 1, generator=gen, device=device)
    shift = 500.0 * torch.randn(n, 1, 3, generator=gen, device=device)
    pred = scale * truth @ rotation.transpose(1, 2) + shift + 40.0 * torch.randn(n, joints, 3, generator=gen,
                                                                                  device=device)
    planar = max(1, int(n * POSE_PLANAR_SHARE))
    pred[:planar, :, 2] = 0.0
    truth[:planar, :, 2] = 0.0
    return pred, truth


def wide_cloud_inputs(n: int = WIDE_CLOUDS[0], points: int = WIDE_CLOUDS[1], dim: int = WIDE_CLOUDS[2],
                      seed: int = 69, device: str = "cuda"):
    """(moved, reference) clouds of ``dim``-wide points, as in aligning two embedding
    spaces: one seeded rotation, a scale per cloud and noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    truth = torch.randn(n, points, dim, generator=gen, device=device)
    rotation = torch.linalg.qr(torch.randn(dim, dim, generator=gen, device=device).cpu())[0].to(device)
    scale = 0.8 + 0.4 * torch.rand(n, 1, 1, generator=gen, device=device)
    return scale * truth @ rotation.T + 0.1 * torch.randn(n, points, dim, generator=gen, device=device), truth


def procrustes_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch.shape import ProcrustesDisparity

    return {"mean": ProcrustesDisparity("mean", device=device), "sum": ProcrustesDisparity("sum", device=device)}


def singular_gaps(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Per pose pair: the least gap between the sorted singular values of the normalised
    cross-covariance, zero included (LAPACK's, on the host)."""
    p1, p2 = (p.double().cpu() for p in (pred, truth))
    p1, p2 = p1 - p1.mean(1, keepdim=True), p2 - p2.mean(1, keepdim=True)
    p1, p2 = p1 / p1.norm(dim=(1, 2), keepdim=True), p2 / p2.norm(dim=(1, 2), keepdim=True)
    w = torch.linalg.svdvals((p2.transpose(1, 2) @ p1).transpose(1, 2))
    gaps = -torch.diff(torch.cat([w, torch.zeros(w.shape[0], 1, dtype=w.dtype)], 1), dim=1)
    return gaps.min(1).values


def hold_procrustes(label: str, got: tuple, want: tuple, gaps: torch.Tensor, pred, truth) -> dict:
    """``(disparity, scale, rotation)`` of the card against the CPU's: disparity and scale
    within the value tolerance; the rotation within ``1e-6 / gap`` where the singular
    values are ``SINGULAR_GAP`` apart, and elsewhere (not unique) by the disparity it gives."""
    disparity, scale, rotation = (t.cpu() for t in got)
    out = {"disparity": value_diff(disparity, want[0]), "scale": value_diff(scale, want[1])}
    distinct = gaps > SINGULAR_GAP
    rot_diff = (rotation.double() - want[2].double()).abs().amax((1, 2))
    out["rotation"] = float((rot_diff / (1e-6 / gaps))[distinct].max()) if bool(distinct.any()) else 0.0
    p1, p2 = (p.double().cpu() for p in (pred, truth))
    p1, p2 = p1 - p1.mean(1, keepdim=True), p2 - p2.mean(1, keepdim=True)
    p1, p2 = p1 / p1.norm(dim=(1, 2), keepdim=True), p2 / p2.norm(dim=(1, 2), keepdim=True)
    applied = (p1 - scale.double()[:, None] * (p2 @ rotation.double().transpose(1, 2))).square().sum((1, 2))
    out["disparity_by_the_rotation"] = value_diff(applied.float()[~distinct], want[0][~distinct])
    if not max(out.values()) <= 1.0:
        raise AssertionError(f"{label}: {out} tolerance units from the CPU's")
    return out


def procrustes_phase(card: str) -> None:
    from torchmetrics_tpu_torch.functional import procrustes_disparity

    clock = [("start", time.perf_counter())]
    pred, truth = pose_inputs()
    batches = list(zip(pred.split(POSE_BATCH), truth.split(POSE_BATCH)))
    clock.append(("inputs", time.perf_counter()))
    metrics = procrustes_metrics()
    update_ms = {name: median([synced_ms(lambda: m.update(*b)) for b in batches]) for name, m in metrics.items()}
    compute_ms = {name: synced_ms(lambda: fresh_compute(m)) for name, m in metrics.items()}
    guarded = procrustes_metrics()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # an update that reads the host raises
    try:
        for m in guarded.values():
            for b in batches:
                m.update(*b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    functional_ms = synced_ms(lambda: procrustes_disparity(pred, truth, return_all=True))
    functional = procrustes_disparity(pred, truth, return_all=True)
    clock.append(("card", time.perf_counter()))
    cpu_metrics = procrustes_metrics("cpu")
    for m in cpu_metrics.values():
        for b in batches:
            m.update(*(t.cpu() for t in b))
    cpu_functional = procrustes_disparity(pred.cpu(), truth.cpu(), return_all=True)
    gaps = singular_gaps(pred, truth)
    clock.append(("cpu", time.perf_counter()))
    for name, m in metrics.items():
        if not states_equal(m._state, guarded[name]._state):
            raise AssertionError(f"procrustes {name}: the guarded run's states differ")
        for key in ("disparity", "total"):
            if value_diff(m._state[key], cpu_metrics[name]._state[key]) > 1.0:
                raise AssertionError(f"procrustes {name}: {key} {m._state[key]} on the card, "
                                     f"{cpu_metrics[name]._state[key]} on the CPU")
    values = {name: float(m.compute()) for name, m in metrics.items()}
    diffs = {name: value_diff(m.compute(), cpu_metrics[name].compute()) for name, m in metrics.items()}
    diffs.update(hold_procrustes("procrustes functional", functional, cpu_functional, gaps, pred, truth))
    if not max(diffs.values()) <= 1.0:
        raise AssertionError(f"procrustes: {diffs} tolerance units from the CPU's")
    probe = procrustes_metrics()["mean"]
    reads = host_reads(lambda: probe.update(*batches[0]))
    peak = update_peak_bytes(probe, batches[0])
    library = procrustes_svd_comparison(batches, metrics)
    diffs.update(library.pop("diffs"))
    clock.append(("checks", time.perf_counter()))
    wide_pred, wide_truth = wide_cloud_inputs()
    wide = procrustes_disparity(wide_pred, wide_truth, return_all=True)
    wide_ms = synced_ms(lambda: procrustes_disparity(wide_pred, wide_truth, return_all=True))
    wide_reads = host_reads(lambda: procrustes_disparity(wide_pred, wide_truth))
    cpu_wide = procrustes_disparity(wide_pred.cpu(), wide_truth.cpu(), return_all=True)
    wide_gaps = singular_gaps(wide_pred, wide_truth)
    wide_diffs = hold_procrustes("procrustes wide", wide, cpu_wide, wide_gaps, wide_pred, wide_truth)
    diffs.update({f"wide_{key}": value for key, value in wide_diffs.items()})
    clock.append(("wide", time.perf_counter()))
    emit({"phase": "procrustes", "poses": POSES, "joints": POSE_JOINTS, "batch": POSE_BATCH,
          "planar_poses": int((gaps < SINGULAR_GAP).sum()), "update_ms": update_ms, "compute_ms": compute_ms,
          "functional_ms_all_poses": functional_ms, "values": values, "host_reads_per_update": reads,
          "sync_debug_error_mode": "16 updates a metric, no host read", "update_peak_extra_bytes": peak,
          "torch_linalg_svd": library,
          "wide": {"clouds": list(WIDE_CLOUDS), "functional_ms": wide_ms, "host_reads": wide_reads,
                   "rotations_held": int((wide_gaps > SINGULAR_GAP).sum())},
          "max_diff_in_tolerance_units": diffs, "seconds": clock_seconds(clock), "card": card})
    profile_step("procrustes_update", lambda: probe.update(*batches[0]))
    with procrustes_through_the_library():
        profile_step("procrustes_update_torch_linalg_svd", lambda: probe.update(*batches[0]))


def procrustes_through_the_library():
    """A context in which every Procrustes SVD is one ``torch.linalg.svd`` of the batch."""
    from unittest import mock

    import torchmetrics_tpu_torch.functional.shape.procrustes as procrustes_module

    return mock.patch.object(procrustes_module, "_JACOBI_MAX_D", 0)


def procrustes_svd_comparison(batches: list, metrics: dict) -> dict:
    """The same pose updates with the SVD taken by ``torch.linalg.svd``: update ms and host
    reads, the states within the value tolerance of the Jacobi path's (``metrics``), and
    the two SVDs alone on one batch's cross-covariances (median ms of 5)."""
    from torchmetrics_tpu_torch.functional.shape.procrustes import _jacobi_svd

    library = procrustes_metrics()
    with procrustes_through_the_library():
        update_ms = {name: median([synced_ms(lambda: m.update(*b)) for b in batches]) for name, m in library.items()}
        reads = host_reads(lambda: procrustes_metrics()["mean"].update(*batches[0]))
    diffs = {f"torch_linalg_svd_{name}": value_diff(m.compute(), metrics[name].compute()) for name, m in library.items()}
    p1, p2 = (p.double() for p in batches[0])
    p1, p2 = p1 - p1.mean(1, keepdim=True), p2 - p2.mean(1, keepdim=True)
    cross = (p2.transpose(1, 2) @ p1).transpose(1, 2)
    svd_ms = {"jacobi": median([synced_ms(lambda: _jacobi_svd(cross)) for _ in range(5)]),
              "torch_linalg_svd": median([synced_ms(lambda: torch.linalg.svd(cross)) for _ in range(5)])}
    return {"update_ms": update_ms, "host_reads_per_update": reads, "svd_ms_one_batch": svd_ms, "diffs": diffs}


def adult_table(rows: int = ADULT_ROWS, cardinalities=ADULT_CARDINALITIES, seed: int = 71, device: str = "cuda"):
    """A UCI Adult-shaped categorical table ``(rows, 8)`` float32: skewed categories
    (Zipf-like weights in a seeded order), tied to a latent group so the columns
    associate, and ``ADULT_NAN_SHARE`` of the entries NaN."""
    gen = torch.Generator(device=device).manual_seed(seed)
    latent = torch.randint(0, 6, (rows,), generator=gen, device=device)
    columns = []
    for k in cardinalities:
        weights = (torch.arange(1, k + 1, device=device, dtype=torch.float64) ** -1.1)[
            torch.randperm(k, generator=gen, device=device)]
        drawn = torch.multinomial(weights, rows, replacement=True, generator=gen)
        tied = (latent * 5 + torch.randint(0, 2, (rows,), generator=gen, device=device)) % k
        columns.append(torch.where(torch.rand(rows, generator=gen, device=device) < 0.5, tied, drawn))
    table = torch.stack(columns, 1).to(torch.float32)
    table[torch.rand(table.shape, generator=gen, device=device) < ADULT_NAN_SHARE] = float("nan")
    return table


def crowd_ratings(shape=CROWD, seed: int = 73, device: str = "cuda"):
    """(probabilities ``(items, categories, raters)``, counts ``(items, categories)``):
    raters' softmax outputs around each item's true category, and the votes they give."""
    items, categories, raters = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    truth = torch.randint(0, categories, (items,), generator=gen, device=device)
    logits = torch.randn(items, categories, raters, generator=gen, device=device)
    logits[torch.arange(items, device=device), truth] += 1.5
    probs = logits.softmax(1)
    counts = torch.nn.functional.one_hot(probs.argmax(1), categories).sum(1)
    return probs, counts


def nominal_classes(device=None, num_classes: int = max(ADULT_CARDINALITIES[i] for i in ADULT_PAIR)) -> dict:
    from torchmetrics_tpu_torch import nominal as n

    return {"cramers_v": n.CramersV(num_classes, device=device),
            "pearson": n.PearsonsContingencyCoefficient(num_classes, device=device),
            "theils_u": n.TheilsU(num_classes, device=device),
            "tschuprows_t": n.TschuprowsT(num_classes, device=device),
            "fleiss_probs": n.FleissKappa("probs", device=device),
            "fleiss_counts": n.FleissKappa("counts", device=device)}


def nominal_batches(table: torch.Tensor, probs: torch.Tensor, counts: torch.Tensor) -> dict:
    pair = table[:, list(ADULT_PAIR)]
    return {"pair": [tuple(b.unbind(1)) for b in pair.tensor_split(ADULT_UPDATES)],
            "probs": [(b,) for b in probs.tensor_split(CROWD_UPDATES)],
            "counts": [(b,) for b in counts.tensor_split(CROWD_UPDATES)]}


def run_nominal(metrics: dict, batches: dict, timed: bool = True) -> dict:
    """Every batch into its metrics, then each ``compute()``: name -> states, value and,
    when ``timed``, the median update ms and the compute ms."""
    out = {}
    for name, metric in metrics.items():
        feed = batches["probs" if name == "fleiss_probs" else "counts" if name == "fleiss_counts" else "pair"]
        times = [synced_ms(lambda: metric.update(*b)) if timed else metric.update(*b) for b in feed]
        out[name] = {"update_ms": median(times) if timed else None,
                     "compute_ms": synced_ms(lambda: fresh_compute(metric)) if timed else None,
                     "value": fresh_compute(metric), "states": metric._concat_state()}
    return out


def nominal_matrices(table: torch.Tensor) -> dict:
    from torchmetrics_tpu_torch.functional import nominal as f

    out = {}
    for strategy in ("replace", "drop"):
        for name in ("cramers_v_matrix", "pearsons_contingency_coefficient_matrix", "theils_u_matrix",
                     "tschuprows_t_matrix"):
            start = time.perf_counter()
            out[f"{name}_{strategy}"] = (getattr(f, name)(table, nan_strategy=strategy),
                                         (time.perf_counter() - start) * 1e3)
    return out


def nominal_tables(table: torch.Tensor) -> dict:
    """The contingency table of every column pair under both NaN strategies."""
    from torchmetrics_tpu_torch.functional.nominal._association import _nominal_update

    columns = table.shape[1]
    return {(i, j, s): _nominal_update(table[:, i], table[:, j], None, s).cpu()
            for s in ("replace", "drop") for i in range(columns) for j in range(i + 1, columns)}


def hold_nominal(label: str, got: dict, want: dict) -> float:
    """States bit for bit, values within the value tolerance. Returns the largest value
    difference in tolerance units."""
    worst = 0.0
    for name, entry in want.items():
        if not states_equal({k: v.cpu() for k, v in got[name]["states"].items()}, entry["states"]):
            raise AssertionError(f"{label} {name}: states differ from the CPU's")
        diff = value_diff(got[name]["value"], entry["value"])
        if not diff <= 1.0:
            raise AssertionError(f"{label} {name}: {got[name]['value']} on the card, {entry['value']} on the CPU")
        worst = max(worst, diff)
    return worst


def argmax_cases(seed: int = 73) -> list:
    """(array, axis) pairs whose argmax numpy resolves by its rules: the first maximum,
    and the first NaN in a row that holds one. Small integers (many ties) with 2% NaN,
    along each axis of 2-D and 3-D arrays and along rows long enough to be split across
    blocks, in float32 and float64, and a few rows of infinities and signed zeros."""
    rng = np.random.default_rng(seed)
    cases = []
    for dtype in (np.float32, np.float64):
        edges = np.asarray([[0.5, 1.0, 1.0], [np.nan, 0.0, np.nan], [0.0, np.nan, 1.0],
                            [-np.inf, -np.inf, -np.inf], [-0.0, 0.0, -1.0], [np.inf, np.inf, 0.0]], dtype)
        cases += [(edges, 1), (edges.T.copy(), 0)]
        for shape, axis in (((4096, 40), 1), ((40, 4096), 0), ((10000, 5, 5), 1), ((4, 1 << 20), 1)):
            x = rng.integers(0, 4, size=shape).astype(dtype)
            x[rng.random(shape) < 0.02] = np.nan
            cases.append((x, axis))
    return cases


def argmax_mismatches(device: str, argmax=torch.argmax) -> int:
    """Indices where ``argmax`` on ``device`` differs from numpy's over ``argmax_cases``:
    the nominal and Fleiss updates collapse probabilities with ``torch.argmax``."""
    return sum(int((argmax(torch.from_numpy(x).to(device), axis).cpu().numpy() != x.argmax(axis)).sum())
               for x, axis in argmax_cases())


def nominal_phase(card: str) -> None:
    import warnings

    clock = [("start", time.perf_counter())]
    table = adult_table()
    probs, counts = crowd_ratings()
    batches = nominal_batches(table, probs, counts)
    cpu_batches = {k: [tuple(t.cpu() for t in b) for b in v] for k, v in batches.items()}
    clock.append(("inputs", time.perf_counter()))
    metrics = nominal_classes()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        card_run = run_nominal(metrics, batches)
        matrices = nominal_matrices(table)
        tables = nominal_tables(table)
        clock.append(("card", time.perf_counter()))
        cpu_run = run_nominal(nominal_classes("cpu"), cpu_batches, timed=False)
        cpu_matrices = nominal_matrices(table.cpu())
        cpu_tables = nominal_tables(table.cpu())
    clock.append(("cpu", time.perf_counter()))
    worst = hold_nominal("nominal", card_run, cpu_run)
    for key, want in cpu_tables.items():
        if not same_bits(tables[key], want):
            raise AssertionError(f"nominal: the table of columns {key} differs from the CPU's")
    matrix_worst = 0.0
    for name, (value, _) in matrices.items():
        diff = value_diff(value, cpu_matrices[name][0])
        if not diff <= 1.0:
            raise AssertionError(f"nominal {name}: {value} on the card, {cpu_matrices[name][0]} on the CPU")
        matrix_worst = max(matrix_worst, diff)
    probe = nominal_classes()["cramers_v"]
    reads = host_reads(lambda: probe.update(*batches["pair"][0]))
    mismatches = argmax_mismatches("cuda")
    if mismatches:
        raise AssertionError(f"nominal: torch.argmax on the card differs from numpy's at {mismatches} indices")
    clock.append(("checks", time.perf_counter()))
    emit({"phase": "nominal", "rows": ADULT_ROWS, "cardinalities": list(ADULT_CARDINALITIES),
          "nan_share": ADULT_NAN_SHARE, "class_pair": list(ADULT_PAIR), "updates": ADULT_UPDATES,
          "crowd": list(CROWD), "crowd_updates": CROWD_UPDATES,
          "update_ms": {n: e["update_ms"] for n, e in card_run.items()},
          "compute_ms": {n: e["compute_ms"] for n, e in card_run.items()},
          "matrix_ms": {n: ms for n, (_, ms) in matrices.items()},
          "values": {n: float(e["value"]) for n, e in card_run.items()},
          "tables": f"{len(tables)} column-pair tables bit for bit", "states": "bit for bit",
          "host_reads_per_update": reads, "argmax": f"numpy's on ties and NaNs ({len(argmax_cases())} cases)",
          "max_diff_in_tolerance_units": max(worst, matrix_worst), "seconds": clock_seconds(clock), "card": card})
    profile_step("nominal_cramers_v_update", lambda: probe.update(*batches["pair"][0]))
    profile_step("nominal_cramers_v_matrix", lambda: nominal_matrices(table))


def cluster_inputs(samples: int = CLUSTER_SAMPLES, classes: int = CLUSTER_CLASSES, clusters: int = CLUSTERS,
                   width: int = CLUSTER_WIDTH, seed: int = 79, device: str = "cuda"):
    """k-means evaluation of ImageNet-val-shaped embeddings: (cluster labels, class labels
    int64, float32 embeddings ``(samples, width)``). Each class has ``samples / classes``
    samples; ``CLUSTER_PURITY`` of them fall in the class's own cluster and the rest in
    clusters drawn by uneven (Zipf-like) sizes; an embedding lies around its cluster's
    centre."""
    gen = torch.Generator(device=device).manual_seed(seed)
    target = (torch.arange(samples, device=device) % classes)[torch.randperm(samples, generator=gen, device=device)]
    own = torch.randperm(clusters, generator=gen, device=device)[target % clusters]
    sizes = torch.arange(1, clusters + 1, device=device, dtype=torch.float64) ** -0.8
    drawn = torch.multinomial(sizes, samples, replacement=True, generator=gen)
    preds = torch.where(torch.rand(samples, generator=gen, device=device) < CLUSTER_PURITY, own, drawn)
    centres = torch.randn(clusters, width, generator=gen, device=device)
    data = centres[preds] + 0.7 * torch.randn(samples, width, generator=gen, device=device)
    return preds, target, data


def cluster_metrics(device=None, classes: int = CLUSTER_CLASSES) -> dict:
    from torchmetrics_tpu_torch import clustering as c

    names = ("MutualInfoScore", "AdjustedMutualInfoScore", "NormalizedMutualInfoScore", "RandScore",
             "AdjustedRandScore", "FowlkesMallowsIndex", "HomogeneityScore", "CompletenessScore", "VMeasureScore",
             "CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex")
    return {**{name: getattr(c, name)(device=device) for name in names},
            "ClusterAccuracy": c.ClusterAccuracy(classes, device=device)}


INTRINSIC_13 = ("CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex")


def run_clustering(metrics: dict, batches: list, timed: bool = True) -> dict:
    """Every batch of (preds, target, data) into every metric (the intrinsic ones take
    (data, preds)), then each ``compute()``: name -> value and, when ``timed``, the median
    update ms, the ms of a first and a second compute and a third one's peak extra bytes."""
    out = {}
    for name, metric in metrics.items():
        args = [(d, p) if name in INTRINSIC_13 else (p, t) for p, t, d in batches]
        times = [synced_ms(lambda: metric.update(*a)) if timed else metric.update(*a) for a in args]
        entry = {"update_ms": median(times), "compute_ms": [synced_ms(lambda: fresh_compute(metric)) for _ in range(2)],
                 "peak": compute_peak_bytes(metric)} if timed else {}
        out[name] = {**entry, "value": fresh_compute(metric)}
    return out


def expected_terms(preds: torch.Tensor, target: torch.Tensor) -> int:
    """The hypergeometric terms the expected mutual information sums over all cluster pairs."""
    from torchmetrics_tpu_torch.functional.clustering.utils import _contingency_cells

    cells = _contingency_cells(preds, target)
    a, b, n = cells.row_sums[:, None], cells.col_sums[None], preds.numel()
    return int((torch.minimum(a, b) + 1 - (a + b - n).clamp(min=1)).clamp(min=0).sum())


def hold_contingency(label: str, preds, target, cpu_preds, cpu_target) -> None:
    """The nonzero cells, margins and pair sums on the card equal the CPU's bit for bit."""
    from torchmetrics_tpu_torch.functional.clustering.utils import _contingency_cells, _pair_sums

    card, cpu = _contingency_cells(preds, target), _contingency_cells(cpu_preds, cpu_target)
    if not all(same_bits(a, b) for a, b in zip(card, cpu)) or _pair_sums(card) != _pair_sums(cpu):
        raise AssertionError(f"{label}: the contingency cells or pair sums differ from the CPU's")


def hold_clustering(label: str, got: dict, want: dict) -> float:
    worst = 0.0
    for name, entry in want.items():
        diff = value_diff(got[name]["value"], entry["value"], absolute=name == "AdjustedMutualInfoScore")
        if not diff <= 1.0:
            raise AssertionError(f"{label} {name}: {got[name]['value']} on the card, {entry['value']} on the CPU")
        worst = max(worst, diff)
    return worst


def clustering_phase(card: str) -> None:
    clock = [("start", time.perf_counter())]
    preds, target, data = cluster_inputs()
    batches = list(zip(preds.tensor_split(CLUSTER_UPDATES), target.tensor_split(CLUSTER_UPDATES),
                       data.tensor_split(CLUSTER_UPDATES)))
    clock.append(("inputs", time.perf_counter()))
    metrics = cluster_metrics()
    card_run = run_clustering(metrics, batches)
    clock.append(("card", time.perf_counter()))
    cpu_run = run_clustering(cluster_metrics("cpu"), [tuple(t.cpu() for t in b) for b in batches], timed=False)
    clock.append(("cpu", time.perf_counter()))
    hold_contingency("clustering", preds, target, preds.cpu(), target.cpu())
    worst = hold_clustering("clustering", card_run, cpu_run)
    peaks = {name: entry["peak"] for name, entry in card_run.items()}
    if max(peaks.values()) > PEAK_LIMIT_13:
        raise AssertionError(f"clustering: a compute's peak extra bytes {peaks}")
    terms = expected_terms(preds, target)
    clock.append(("checks", time.perf_counter()))
    emit({"phase": "clustering", "samples": CLUSTER_SAMPLES, "classes": CLUSTER_CLASSES, "clusters": CLUSTERS,
          "width": CLUSTER_WIDTH, "updates": CLUSTER_UPDATES, "clusters_used": int(preds.unique().numel()),
          "expected_mutual_info_terms": terms,
          "update_ms": {n: e["update_ms"] for n, e in card_run.items()},
          "compute_ms_first_second": {n: e["compute_ms"] for n, e in card_run.items()},
          "compute_peak_extra_bytes": peaks, "values": {n: float(e["value"]) for n, e in card_run.items()},
          "contingency_and_pair_sums": "bit for bit", "max_diff_in_tolerance_units": worst,
          "seconds": clock_seconds(clock), "card": card})
    for name in ("AdjustedMutualInfoScore", "DaviesBouldinScore"):
        profile_step(f"clustering_{name}_compute", lambda: fresh_compute(metrics[name]))


def flagship_forward(cases: dict) -> dict:
    """The 26 sepconv7 launches of one bf16 trunk forward at the flagship's batch: their
    summed times and bound, and their worst error against the plain version."""
    forward = [cases[(torch.bfloat16, FLAGSHIP_FID_IMAGES, c, o, axis)] for c, o, axis in trunk_sepconv_shapes()]
    return {"B": FLAGSHIP_FID_IMAGES, "max_abs_err": max(case["max_abs_err"] for case in forward),
            **{key: sum(case[key] for case in forward) for key in ("ms", "plain_ms", "bound_ms", "library_ms")}}


def main() -> int:
    if sys.argv[1:2] == [SYNC_CHILD_FLAG]:
        return sync_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from torchmetrics_tpu_torch.kernels.sepconv import KERNEL

    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    build_phase(KERNEL)
    cases = kernel_phase(gen)
    launches, fids = fid_phase(gen, cases)
    trunk_reference_phase(gen)
    classification_phase(gen)
    binary_segmentation_phase(gen, card)
    multilabel_phase(gen, card)
    topk_ties_phase(gen, card)
    sync_nccl_phase(gen, card, fids["float32"])
    sync_two_ranks_phase(card)
    preds, target = coco_scale_dataset(np.random.default_rng(6), COCO_IMAGES)
    detection_accumulate_phase(card, preds, target)
    host_values = map_host_phase(card, preds, target)
    map_device_phase(card, preds, target, host_values)
    launches_by_path = {"fid": launches["bfloat16"], "flagship": flagship_phase(card, preds, target, host_values["map"])}
    flagship_two_ranks_phase(card)
    launches_by_path["generative"] = generative_phase(card)
    collection_groups_phase(card)
    classification_tower_phase(card)
    curve_data = curves_phase(card)
    tower_tail_phase(card, curve_data)
    curve_points_phase(card, curve_data)
    del curve_data
    regression_phase(card)
    correlation_phase(card)
    launches_by_path["feature_share"] = wrappers_phase(card)
    launches["bfloat16"] = sum(launches_by_path.values())
    panoptic_phase(card)
    retrieval_phase(card)
    segmentation_phase(card)
    segmentation_3d_phase(card)
    pairwise_phase(card)
    procrustes_phase(card)
    nominal_phase(card)
    clustering_phase(card)

    print(card, flush=True)
    kernels = []
    for trunk, dtype, batch, path in (("bfloat16", torch.bfloat16, 512, "wgmma, bf16"),
                                      ("float32", torch.float32, 64, "wgmma, 3xTF32")):
        # per trunk forward: the 26 launches with their multiplicities
        forward = [cases[(dtype, batch, c, o, axis)] for c, o, axis in trunk_sepconv_shapes()]
        kernels.append({
            "name": f"sepconv7_{'bf16' if dtype == torch.bfloat16 else 'f32'}",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/sepconv7.cu",
            "replaces": "tools/exp_sepconv.py:55",
            "launches": launches[trunk],
            "max_abs_err": max(case["max_abs_err"] for key, case in cases.items() if key[0] == dtype),
            "ms": sum(case["ms"] for case in forward),
            "plain_ms": sum(case["plain_ms"] for case in forward),
            "bound_ms": sum(case["bound_ms"] for case in forward),
            "bound_by": "operations",
            "library_ms": sum(case["library_ms"] for case in forward),
            "per": f"the 26 launches of one {trunk} B={batch} trunk forward ({path})",
            **({"launches_by_path": launches_by_path, "flagship_forward": flagship_forward(cases)}
               if trunk == "bfloat16" else {}),
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
