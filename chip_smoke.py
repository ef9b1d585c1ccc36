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
   480x640; 1-30 segments an image; 5% void), a prefix of 16 of val2017's 5,000 images
   in two updates of 8: the states on the card, equal to the CPU port's bit for bit, and
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
33. image_quality: a x4 super-resolution model's evaluation on DIV2K's validation set
   from a seed (100 RGB images of 1356 x 2040 float32 in [0, 1], 25 updates of 4;
   smooth random targets; predictions blurred, noisy, with 8 x 8 block offsets) through
   PSNR (and per image), SSIM, MS-SSIM (five scales), UQI, VIF, TV, RMSE-SW (window 8),
   RASE, PSNR-B on the Y channel and ``image_gradients``: the first update's first 2
   images' per-image values within ``IMAGE_UNITS`` float32 rounding units of the CPU
   port's (the gradients bit for bit); SSIM, MS-SSIM, UQI and VIF the same bits with
   TF32 allowed in cuDNN and cuBLAS; the PSNR, SSIM, MS-SSIM, UQI and TV updates under
   ``torch.cuda.set_sync_debug_mode("error")``; an SSIM or MS-SSIM update under 6 GB
   beyond what the card held. Update and compute ms, peak extra bytes, profiled updates.
34. image_quality_3d: 3-D SSIM of MRI-synthesis volumes (16 BraTS-shaped volumes of
   1 x 240 x 240 x 155 in raw intensities, updates of 2, ``data_range`` from the data,
   the 11^3 gaussian window) and MS-SSIM with four scales on the first update: a central
   96 x 96 x 64 crop of the first volume within ``IMAGE_UNITS`` of the CPU port's, the
   same bits with TF32 allowed, no host read in an update; the window applied directly
   and as three 1-D passes, both timed on one batch.
35. pansharpening: PanCollection's WorldView-3 test sets at their published sizes from a
   seed (20 reduced-resolution samples of 8 x 256 x 256 against their truth; 20
   full-resolution samples of 8 x 512 x 512 with ``ms`` 8 x 128 x 128 and the 512 x 512
   ``pan`` repeated to 8 bands) in updates of 4: SAM, ERGAS (ratio 4), SCC and UQI on the
   reduced set; D_lambda, D_s without and with ``pan_lr`` and QNR on the full set. The
   first 4 samples' values within ``PAN_UNITS`` of the CPU port's; D_lambda's compute
   under 6 GB beyond its states; a profiled D_lambda compute and UQI update.
36. audio_separation: Libri2Mix test at its published scale from a seed (3,000 mixtures of 2
   speech-like sources of 5 s at 16 kHz, 60 updates of 50; each estimate its source plus
   leakage and noise, half of them in swapped order) through SNR, SI-SNR, SI-SDR, SA-SDR,
   PIT over SI-SNR (speaker-wise and permutation-wise), SDR with 512 taps (float64 Toeplitz
   solves on the card) and C-SI-SNR on the 512-point STFT (hop 128). The first update's
   first 4 mixtures against the CPU port: dB values within ``AUDIO_ULPS``, permutations
   and SDR's solver flags bit for bit, SDR's float64 dB within ``SDR_DB_ATOL``; every
   update named in ``SEPARATION_NO_HOST_READ`` under ``torch.cuda.set_sync_debug_mode
   ("error")``; SDR's update with its one read of the solver's flags (counted), timed
   against the solve alone, and its raises on a silent target and on NaN input; PIT at 3 speakers (a Libri3Mix-shaped update, no host read either) and at
   5 (16 WSJ0-5mix-shaped mixtures of 5 s at 8 kHz, the Hungarian branch, host reads
   counted). Update ms (first and median), peak extra bytes, profiled updates.
37. speech_quality: SRMR on 16 REVERB-style utterances (8 s at 16 kHz, speech-like sources
   under seeded reverberation of 0.3-0.9 s); DNSMOS on 32 DNS-Challenge-style clips of 10 s
   at 16 kHz through seeded linear stand-ins for its two ONNX models; NISQA on 16 clips of
   10 s at 48 kHz through a checkpoint the phase writes in the published ``nisqa.tar``
   layout at the published widths (seeded weights). The first 2 of each against the CPU
   port within ``SPEECH_UNITS``; NISQA the same bits with TF32 allowed; host reads
   counted, and none in the DNSMOS and NISQA updates (``SPEECH_NO_HOST_READ``); first and
   second update ms, peak extra bytes; SRMR's Hilbert envelope timed
   on the card and in numpy on the host; profiled NISQA and DNSMOS updates.
38. vmaf: 1080p video from a seed (8 videos of 24 frames of 3 x 1080 x 1920, updates of 2;
   a panning texture, its copy blurred, noisy and shifted) through
   ``VideoMultiMethodAssessmentFusion(features=True)`` and a model file the phase writes in
   libvmaf's layout (v0.6.1's feature list, seeded support vectors): the first video's
   first 4 frames' features within ``VMAF_UNITS`` of the CPU port's and the fused score
   within ``VMAF_SCORE_ATOL``, the features the same bits with TF32 allowed; ADM's DWT
   in the port's 4-tap form and through the dense matrices, timed and held together.
   Update and compute ms, peak extra bytes, host reads, a profiled update.
39-41. text_mt, text_asr, text_qa_sum: the string metrics on seeded stand-ins for the
   corpora at their published sizes but where ``TEXT_PHASE_SEGMENTS`` cuts them (a Zipf
   vocabulary of 20,000 pseudo-words, seeded edits): WMT14 en-de newstest2014 (1,024 of
   its 3,003 segments of about 27 tokens, one reference; hypotheses under 30% edits, a
   fifth with a moved block) through BLEU, SacreBLEU
   (``13a``, ``intl``, ``char``), chrF, chrF++, TER and EED; LibriSpeech test-clean
   (2,620 utterances of about 20 words at a 5% edit rate) through WER, CER, MER, WIL,
   WIP and EditDistance; SQuAD v1.1 dev (4,096 of its 10,570 questions, 1-3 answers)
   through SQuAD and CNN/DailyMail test (4,096 of its 11,490 summaries of about 56 words)
   through ROUGE-1/2/L/Lsum. Updates of 64; the first ``TEXT_CPU_BATCHES`` updates
   replayed by the CPU port, states bit for bit and values within ``TEXT_RTOL``; the
   tensor states on the card; update and compute ms, and one profiled update of every
   metric split into the card's busy time and the host's.
42. perplexity: GPT-2-width logits from a seed (8 windows of 1,024 over 50,257 tokens,
   1.65 GB of float32 an update, the target token raised by a seeded margin), 30
   updates (WikiText-103 test's 245,569 tokens), also with ``ignore_index`` on each
   window's last eighth and in bfloat16; the first window held against the CPU port
   (counts equal, sums within ``PPL_RTOL``, bfloat16 within ``PPL_BF16_RTOL``); update
   ms beside the logits' read bound, peak extra bytes, host reads, a profiled update.
43. bert_score: a seeded ``BertModel`` at bert-base-uncased's published config and a
   ``BertTokenizer`` over a 30,522-entry WordPiece vocabulary the phase writes
   (``BERT_BASE``), loaded by path, ``num_layers=9``; 2,999 WMT16-sized pairs in updates
   of 64, with and without IDF, TF32 off; every value finite on the card, the first 64
   pairs within ``BERT_ATOL`` of the CPU port; update and compute ms, the embedder's
   tokens/s and the matching's ms, a profiled matching.
44. infolm: the ``BertForMaskedLM`` of that config, 256 pairs, the first 8 within
   ``INFOLM_RTOL`` of the CPU port; compute ms and masked copies a second.
45. lve: 16 VOCASET-sized sequences (240 frames of FLAME's 5,023 vertices) through
   ``LipVertexError`` over a seeded lip region of 254 vertices: the int32 count equal
   to the CPU port's, the float32 sum within ``LVE_RTOL``; update ms, host reads, a
   profiled update.
46. lpips: ``LearnedPerceptualImagePatchSimilarity`` with seeded weights in the published
   layouts written by ``convert_lpips_weights``: alex, vgg and squeeze on BAPPS-sized
   64x64 patch pairs (20 updates of 50), vgg on 256x256 (8 updates of 32), and one
   forward and backward through vgg at B=16 (the loss use); the first 2 pairs within
   ``MODEL_ATOL`` of the CPU port, the gradient within ``GRAD_RTOL`` relative L2 of the
   CPU port's and within ``GRAD_F64_RTOL`` of the card's own float64 backward; the same
   gradient with TF32 in cuDNN's backward, and in the forward too, must fail them.
47. dists: ``DeepImageStructureAndTextureSimilarity`` (VGG16, L2 pooling) at 256x256 in
   8 updates of 32, the first 2 pairs within ``MODEL_ATOL``.
48. arniqa: ``ARNIQA(reduction="none")`` with a seeded ResNet-50 in the published
   checkpoint's layout read from ``$TORCH_HOME/hub/checkpoints``, on KonIQ-10k-sized
   1024x768 images in 16 updates of 8; one image within ``MODEL_ATOL``.
49. ppl: ``PerceptualPathLength`` (10,000 samples, batches of 64, resize 64, vgg) of a
   seeded toy generator with StyleGAN2's 512-d latent and 256x256 output; 16 samples against
   a CPU twin within ``PPL_MEDIAN_RTOL`` of the median distance, and the LPIPS of 4 of
   the card's image pairs on the CPU within ``PAIR_LPIPS_RTOL``; a batch's generator and
   similarity (resize and LPIPS) times apart.
50. clip_score: ``CLIPScore`` on a seeded CLIP at openai/clip-vit-large-patch14's
   published config (written once with its processor and a ``tokenizers`` BPE file),
   1,024 COCO-val2017-sized image-caption pairs in updates of 64 (cut from 5,000, see
   ``COCO_CAPTIONS``), text-text and image-image; pixel values equal, features within
   ``CLIP_FEATURE_RTOL`` and scores within ``CLIP_SCORE_ATOL`` of the CPU port.
51. clip_iqa: ``CLIPImageQualityAssessment`` on the same model, 64 images of 1024x768
   in updates of 16, four prompts (one user-defined), the anchors on the card; 2 images
   within ``CLIP_PROB_ATOL``.
   Each of phases 46-51 prints update ms (first and steady), peak extra bytes, host reads
   and a profiled update (device busy, idle share).
52. reliability (run right after phase 16): ``FrechetInceptionDistance`` behind the bf16
   trunk (He-scaled seeded weights, sepconv7's 26 launches a forward) at batch 128, 4
   updates of seeded images, run twice without a policy to show that the card repeats
   itself bit for bit (else its spread and a cause are printed, and the retried run is
   held to that spread), then under ``ReliabilityConfig(retry=RetryPolicy(max_attempts=3,
   sleep_fn=no_sleep))`` with a transient fault injected on the first attempt of the 3rd
   update: states and ``compute()`` equal to the uninterrupted run's. Its sepconv7
   launches are the path's count. An exhausted budget (every attempt of the 3rd update
   fails) raises ``TransientRuntimeError`` after 3 attempts, leaves the states of the 2nd
   update bit for bit and update count 2, and a 4th update works; a 4-channel batch
   raises an error that classifies deterministic, after one attempt; sepconv7's launch
   error and a failed build carrying this run's nvcc log classify deterministic. Costs:
   update ms without and with the policy, the bytes the backup clones and their time
   beside the bound, the launch and memcpy calls of one update as ``fid_phase`` builds it,
   with ``reliability=None`` (equal) and with the policy (one copy a tensor state more).
   In an NCCL group of one, ``{fid, acc}`` (FID's states, the accuracy of 65,536 rows)
   syncs through ``FlakyGather`` over the real gather, first call failing: the retried
   sync equals an unfaulted one bit for bit; with one of FID's sums poisoned the
   validated sync raises ``StateCorruptionError`` and no member adopts a synced state;
   the host reads of one validated sync are counted. ``_to_np`` of FID's value and a
   normalised confusion matrix on the card, in float32 and bfloat16, equals
   ``.float().cpu().numpy()``, and ``plot`` without matplotlib raises the JAX package's
   text (matplotlib is never imported).

53. observability (run right after phase 52): the reliability phase's FID (bf16 trunk,
   He-scaled seeded weights, batch 128, 4 updates) under ``telemetry_session(
   TelemetryConfig(block_until_ready=True, cost_accounting=True))``: 4 dispatches, 1
   ``jit_compiles``, 3 ``jit_cache_hits``, no readback; each update's recorded duration
   beside its time by CUDA events (never under 0.9 of it); the cost record's flops equal
   to the trunk's conv flops and the covariance product derived from the conv shapes
   (``fid_update_flops``); in a ``torch.profiler`` trace of the 4 updates, all 104
   sepconv7 launches inside their ``FrechetInceptionDistance.update`` ranges, 26 each;
   the states equal bit for bit to a run without a session (its sepconv7 launches are the
   path's count). Then ``{acc, f1, confmat}`` with compute groups at batch 65536: update
   ms with telemetry off, on and on with blocking timing; launch calls and host reads
   (the confusion matrix's ``bincount`` reads once) off and on, equal; 3 updates of the
   stat-score members ``{acc, f1}`` under ``set_sync_debug_mode("error")`` in a fresh
   session, the cost harvest included;
   ``telemetry_summary()`` with f1 fused into acc. In an NCCL group of one its coalesced
   sync's ``sync_collectives`` equal the profiler's ``nccl:all_gather`` count, its
   ``sync_payload_bytes`` the payload shipped, its metadata row the CPU encoder's from the
   same leaves and vectors; ``gather_counters()`` and ``gather_histograms()`` after it
   launch no collective, ``gather_counters(prefer_sync_rows=False)`` exactly one. The
   phase's JSONL trace goes through ``tools/trace_report.py --json``.

54. aot (run right after phase 53): the AOT warm-start plane. ``{acc, f1, confmat}``
   (phase 53's collection) precompiled at batch 65,536 x 5 for ``update`` and
   ``forward`` into a fresh cache: every member written with both codecs (a missing
   ``"aoti"`` section fails the phase), compile seconds and entry bytes each. Then fresh
   interpreters (``--aot-child``) under a telemetry session: a warm boot whose first
   collection update loads every member's package (``aot_cache_hits`` 3, ``jit_compiles``
   0, the counters reconciled, each load's codec ``"aoti"``), a cold boot with no plane,
   and a boot after one byte of the confusion matrix's entry was flipped (one miss, plane
   stat ``corrupt`` 1, served eagerly without an exception). Each child's states after 16
   seeded batches equal the eager states bit for bit; time to the first update, each
   load's ms, steady update ms and launch calls, loaded against eager. Then FID (bf16
   trunk, batch 128) with the plane active: ``precompile`` reports it uncacheable (a
   module with weights in its config), its 4 updates run eagerly with all 104 sepconv7
   launches (the path's count), each inside its update's profiler range, states equal to
   a run without the plane and the counters reconciled on the eager side. Last the
   ``"mapeval"`` program of the map_device phase's ``DeviceMeanAveragePrecision
   (capacity=524288)``, precompiled by a ``--mapeval-child`` the map_device phase starts
   (its compile overlaps phases 11-53): ``"written"`` with both codecs, and the loaded
   (``"aoti"``) ``compute()`` over the 5000 images within ``MAPEVAL_ATOL`` (1e-6) of the
   eager one, both timed.

55. streaming (run right after phase 54): the streaming plane. (1) ``{acc, f1,
   confmat}`` (5 classes, batch 65,536), each in ``SlidingWindow(window=64)`` (the dual
   tier), 200 updates: the window-parity oracle on the card (the window's states equal
   a fresh metric's fed the trailing ``covered_updates()`` batches bit for bit, values
   within 1e-6), a 12-update prefix at window 4 held against the CPU port (states bit
   for bit, values within 1e-6), update ms and launch calls windowed against plain, the
   host reads of a windowed update equal to the plain one's, and ``{acc, f1}`` windowed
   under ``torch.cuda.set_sync_debug_mode("error")``. (2) FID behind the bf16 trunk
   (He-scaled seeded weights, batch 128) in ``SlidingWindow(window=4)`` over 10 updates
   (two rotations): 260 sepconv7 launches (the path's count), 26 inside each windowed
   update's ``FrechetInceptionDistance.wdual`` range; the oracle within the JAX
   package's ``rtol=1e-5, atol=1e-6``; ``ExponentialDecay(FID, halflife=4)`` over the
   same batches against its closed form in float64 on the host (within 1e-5 of each
   sum's largest magnitude). (3) The two-stack tier on per-batch latencies (``MaxMetric``
   and ``MinMetric``, 3,000 updates of 1,024 values at window 1,000: depth 16, pane 63,
   past several flips; and at ``pane=1``, exact, for 2,500 updates), the ring on
   ``PearsonCorrCoef`` (a custom merge) over phase 21's weather batches at window 8 and
   on ``CatMetric`` (list states), each held to the oracle, with its state bytes. (4)
   ``DriftMonitor`` on windowed accuracy over a stream whose label noise steps up after
   update 100 of 200: no breach before, a breach after, in the session's ``drift(acc)``
   SLO and an ``alert`` event. (5) In an NCCL group of one, ``{acc, f1, confmat}`` and
   FID's states synced with ``sync(async_=True)`` while 8 updates run: the commit equal
   to a blocking sync bit for bit, ``unsync()`` giving back the overlap's states, the
   traced ``nccl:all_gather`` (all threads) as ``collective_counts`` predicts,
   ``overlap_pct``/``gather_s``/``wait_s``; a ``FlakyGather`` whose first call fails
   commits nothing without a policy and recovers under ``RetryPolicy``. (6)
   ``precompile(tags=("wdual",))`` of windowed accuracy writes both codecs; a fresh
   interpreter (``--aot-child ... window``) loads it (one ``"aoti"`` load, no compile),
   its window states after 16 batches equal the eager ones bit for bit. Budget 90 s.
56. serving (right after phase 55; its first boot starts beside phase 55): the serving
   plane. (1) The serving demo's spill churn at full width: ``MulticlassAccuracy(10)``
   tenants, ``ServingConfig(capacity=2048, megabatch_size=512)``, 8,000 tenants over 4
   rounds of 32 seeded logits from the host: tenants/s through the engine against a
   naive loop of one metric per tenant (512 tenants), dispatches, padded rows, spills,
   readmissions, ``tenant_spill_us``; 256 seeded tenants (spilled ones among them) bit
   for bit against CPU metrics fed the same batches; launch calls of one dispatch equal
   at 64 and 512 rows (profiled). (2) ``MulticlassConfusionMatrix(10)`` tenants on 2,048
   of them over 2 rounds: 64 bit for bit against the CPU, launch calls equal at 64 and
   512 rows (the megabatch's one count). (3) Windowed tenants (``window=64``, the dual
   tier): 4 tenants over 130 updates equal to ``SlidingWindow(64)``'s window states bit
   for bit, ``compute_all`` (``vcompute``) equal to ``compute``. (4)
   ``on_error="quarantine"`` with ``_fault_hook`` failing one tenant of a megabatch of
   64: that tenant alone quarantined, its 63 peers equal a clean run bit for bit. (5)
   1,024 journaled tenants over 3 rounds (the default fsync of every append), a snapshot
   after the first: a fresh engine's ``restore`` plus ``replay_journal`` equal to the
   uninterrupted engine bit for bit, a second replay applies nothing; the snapshot's
   bytes and seconds, the journaled feed's seconds. (6) Two boots of
   ``ServingConfig(aot_cache_dir=..., write_on_miss=True)`` in fresh interpreters
   (``--aot-child ... serve``): the second's first megabatch loads (hits ≥ 1, misses 0),
   states equal; first-dispatch ms warm against cold. (7) FID tenants behind the bf16
   trunk: ``ServingConfig(capacity=4, megabatch_size=4)``, 6 tenants over 3 rounds of 32
   seeded images (uint8 levels as [0, 1] floats, ``normalize=True``), 128 a dispatch:
   26 sepconv7 launches a dispatch (the rows fold into the kernel's batch under
   ``vmap``), every tenant within ``SERVE_FID_RTOL`` relative L2 of a standalone FID on
   the card and above it against the next tenant's, every ``"int8"`` spill within
   ``range/510``, spill bytes ``"int8"`` against ``"none"``; the trunk at batch 32 with
   sepconv7 called through ``sepconv7_rows`` and directly, in alternating pairs after
   the warm boot has ended (the op's dispatch cost).
57. quantized_sync: two gloo ranks on the card (``--sync-child ... quantized``) syncing
   ``{acc, f1, confmat}`` at 65,536 rows, FID's sums at 2,048 features (a fixed
   projection) and a ``MeanMetric``: exact, ``SyncConfig(codec="bf16")`` and ``"int8"``
   (integer states bit for bit, float sums within ``quantize.py``'s bounds summed over
   the ranks, as many collectives recorded and ``all_gather`` calls traced as exact,
   bytes by ``quantized_payload_model`` and measured); error feedback over 8 syncs (the
   summed drift within one step); a degraded sync (``DeadRank``: the ledger ``{1: 2}``,
   two ``degraded_sync`` events) and a rejoin at epoch 2 (``rank_rejoin``, the ledger
   empty); ``AsyncSyncHandle(sync_config=...)`` and ``ServingEngine.sync_async(
   sync_config=...)`` equal to blocking quantized syncs bit for bit. Beside them, in an
   NCCL group of one, a ``SyncConfig`` sync ships exact and gives the local states bit
   for bit.
58. chaos: ``run_soak`` on the card. ``bench.py``'s ``production_soak`` (seed 23, 24
   tenants, 120 steps, capacity 8, megabatches of 4, int8 spill, bf16 sync, 40 tenants/s,
   one fault of every kind) twice: the counter, history, fault-ledger, reconciliation and
   digest blocks equal run to run, no unrecovered fault, exact reconciliation, every kind
   injected and resolved. ``durable_failover`` (seed 31, a snapshot every 30 steps, the
   kill at step 70, fsync every record): state parity and degraded-sync parity 1.0, RPO 0
   records, the final digest equal to an uninterrupted run on the card, its RTO. Both
   configs' blocks equal the port's on the CPU (``--chaos-child``). The soak at the
   serving phase's geometry (8,000
   tenants, 64 events a step, churn of 256 every 30 steps, capacity 2,048, megabatches of
   512, int8 spill, bf16 sync, 320 tenants/s): no unrecovered fault, exact reconciliation;
   tenants/s, update p50/p99 µs, shed rate, spills and readmissions; one megabatch
   dispatch and one sync epoch of a short soak on that geometry profiled, each read from
   the soak's own profiler range (launch calls, idle share).
59. fleet: ``run_fleet_soak`` and ``FleetController`` on the card. ``bench.py``'s
   ``fleet_failover`` (seed 37, 3 hosts, ``host-1`` killed at step 40, a join at step 80,
   capacity 12, snapshots every 20 steps, fsync every record) twice: blocks equal run to
   run and to the CPU child's, fleet-failover and migration parity 1.0, RPO 0, no batch
   counted twice; ``migration_us`` and the failover's RTO, both from the report's
   ``timing``. The same schedule on the chaos phase's 8,000-tenant traffic over 3 hosts of
   2,048 slots and megabatches of 512:
   per-tenant parity 1.0 against the uninterrupted single-host reference; tenants adopted
   and migrated, RTO, ``migration_us``. FID tenants behind the bf16 trunk over 3 hosts
   (capacity 4, 32 images a batch, 9 tenants, 3 rounds): two tenants migrate after the
   first round onto ``host-1``, which is killed after the second and failed over past its
   lease; each migrated tenant's digest equal before and after its move, every tenant
   within ``SERVE_FID_RTOL`` of an uninterrupted engine fed the same batches and above it
   against the next tenant's; the fleet's sepconv7 launches count in the kernels line's
   ``launches_by_path["fleet"]``.
   Phases 58 and 59 run in a child on the card (``--soak-child``) and the CPU's published
   soaks in another (``--chaos-child``), both started before phase 54 (aot), so they run
   beside phases 54-57; their lines print after phase 57, when the children are collected.
   The card and the host are shared meanwhile: the times of phases 54-59 are not those of
   a process alone on the card (``SOAK_CHILD_BESIDE``, in phases 58 and 59's lines).

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

import contextlib
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


def profile_step(label: str, step, tries: int = 4, extra=None, within=None) -> list:
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
    reported trace; ``extra(events)`` adds keys to the line. ``within`` names a host range
    that the step opens (a soak's sync epoch): then only the last such range counts, with
    its own wall time (:func:`range_events`)."""
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
        if within is not None:
            events, wall_us = range_events(events, within)
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


def range_events(events, name: str) -> tuple:
    """The last host range named ``name`` among a step's events: the host events inside
    it and the device events of the launches and copies made there (matched by
    correlation id); and the range's wall time in µs."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name == name and e.device_type == DeviceType.CPU]
    if not marks:
        raise AssertionError(f"profile: no host range named {name} in the step")
    begin, end = marks[-1].time_range.start, marks[-1].time_range.end
    inside = [e for e in events if e.device_type == DeviceType.CPU and e is not marks[-1]
              and begin <= e.time_range.start and e.time_range.end <= end]
    made = {e.id for e in inside}
    return inside + [e for e in events if e.device_type == DeviceType.CUDA and e.id in made], end - begin


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
    metrics' ``compute()``; "quantized": :func:`quant_values`' report). Prints its values
    as a RESULT line."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        if mode == "quantized":
            report = quant_values(rank, world)
        elif mode == "flagship":
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
    if mode != "quantized":
        report = {"sync_ms": sync_ms, "values": {k: [str(v.dtype), v.cpu().tolist()] for k, v in values.items()}}
    print("RESULT" + json.dumps({"rank": rank, **report}), flush=True)
    return 0


def run_children(mode: str, world: int = 2, wall_s: int = 300) -> list:
    """Start this script ``world`` times with ``--sync-child`` in ``mode`` (a gloo group
    on the one card, ``GLOO_SOCKET_IFNAME=lo``, a file rendezvous) and return each
    rank's RESULT; a child that fails or outlives ``wall_s`` fails the phase."""
    return finish_children(start_children(mode, world), wall_s)


def start_children(mode: str, world: int = 2) -> tuple:
    """:func:`run_children`'s start: the children run beside the caller until
    :func:`finish_children` takes their results."""
    import tempfile

    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), SYNC_CHILD_FLAG, str(rank), str(world),
                               f"file://{rendezvous}/store", mode], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for rank in range(world)]
    return procs, mode, rendezvous


def finish_children(started: tuple, wall_s: int = 300) -> list:
    procs, mode, rendezvous = started
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


def device_map_metric(preds, target):
    """``DeviceMeanAveragePrecision`` at the phase's geometry over ``preds``/``target``
    in steps of ``IMAGES_PER_STEP`` images, and each update's ms."""
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
    return metric, update_ms


def map_device_phase(card: str, preds, target, host_values: dict):
    """Returns the metric and its result, which the aot phase's ``"mapeval"`` step takes."""
    metric, update_ms = device_map_metric(preds, target)

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
    return metric, result


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


def launch_calls(events, kind: str = "LaunchKernel") -> int:
    """The host's calls of ``kind`` in a trace: kernel launches, or ``"Memcpy"`` copies."""
    from torch.autograd import DeviceType

    return sum(1 for e in events if e.device_type == DeviceType.CPU and kind in e.name)


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
# the reliability plane: FID's retried update, a retried and validated sync, plot values

RELIABILITY_BATCH = 128
RELIABILITY_UPDATES = 4
RELIABILITY_FAIL_ON = 3  # the update whose first attempt fails
RELIABILITY_ATTEMPTS = 3
RELIABILITY_TIMED = 8  # timed updates a build, after one untimed
RELIABILITY_ACC_BATCH = 65536
PLOT_ERROR_TEXT = "matplotlib is required to plot metrics, install it to use the `.plot` method"
POISONED_LEAF = "real_features_sum"


def no_sleep(seconds: float) -> None:
    """The policies' ``sleep_fn``: a retry here waits for nothing."""


def retry_config():
    from torchmetrics_tpu_torch.reliability import ReliabilityConfig, RetryPolicy

    return ReliabilityConfig(retry=RetryPolicy(max_attempts=RELIABILITY_ATTEMPTS, sleep_fn=no_sleep))


def reliability_fid(extractor, reliability=None, device=None, **kwargs):
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    return FrechetInceptionDistance(feature=extractor, normalize=True, reliability=reliability, device=device,
                                    **kwargs)


def fid_updates(metric, batches) -> None:
    """The batches in turn, real and fake alternately, the first real."""
    for i, imgs in enumerate(batches):
        metric.update(imgs, real=i % 2 == 0)


def tensor_states(metric) -> dict:
    """Copies of a metric's tensor states."""
    return {k: v.clone() for k, v in metric._state.items() if isinstance(v, torch.Tensor)}


def state_spread(got: dict, want: dict) -> dict:
    """Each state's largest absolute difference, in float64."""
    return {k: float((got[k].double() - want[k].double()).abs().max()) for k in want}


def within_spread(got: dict, want: dict, spread: dict) -> bool:
    """Bit for bit where the card repeated itself bit for bit, else within its spread."""
    return all(torch.equal(got[k], want[k]) if spread[k] == 0 else
               float((got[k].double() - want[k].double()).abs().max()) <= spread[k] for k in want)


@contextlib.contextmanager
def injected(metric, fail_on: int, times: int = 1, exc_factory=None):
    """``inject_dispatch_fault`` on ``update`` with the retry warnings silenced."""
    import warnings

    from torchmetrics_tpu_torch.reliability import inject_dispatch_fault, make_transient_error

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with inject_dispatch_fault(metric, fail_on=fail_on, times=times, tag="update",
                                   exc_factory=exc_factory or make_transient_error) as hook:
            yield hook


def retried_fid_run(metric, batches) -> dict:
    """The updates with a transient fault on the first attempt of update
    ``RELIABILITY_FAIL_ON``: the retry must recover it, once."""
    with injected(metric, RELIABILITY_FAIL_ON) as hook:
        fid_updates(metric, batches)
    if hook.raised != 1 or hook.calls != len(batches) + 1 or metric.update_count != len(batches):
        raise AssertionError(f"reliability: {hook.raised} faults raised over {hook.calls} attempts, "
                             f"update count {metric.update_count}")
    return {"faults": hook.raised, "attempts": hook.calls}


def exhausted_budget(metric, batches) -> dict:
    """Two updates, then a third whose every attempt fails: it raises
    ``TransientRuntimeError`` after ``RELIABILITY_ATTEMPTS`` attempts and leaves the
    states of the second bit for bit; a fourth update then works."""
    from torchmetrics_tpu_torch.utilities.exceptions import TransientRuntimeError

    fid_updates(metric, batches[:2])
    before = tensor_states(metric)
    with injected(metric, 1, times=RELIABILITY_ATTEMPTS + 1) as hook:
        try:
            metric.update(batches[2], real=True)
        except TransientRuntimeError:
            pass
        else:
            raise AssertionError("reliability: an update whose every attempt failed returned")
    rolled_back = states_equal(tensor_states(metric), before)
    count = metric.update_count
    if hook.calls != RELIABILITY_ATTEMPTS or not rolled_back or count != 2:
        raise AssertionError(f"reliability: the exhausted budget took {hook.calls} attempts, rolled back "
                             f"{rolled_back}, left update count {count}")
    metric.update(batches[3], real=False)
    if metric.update_count != 3:
        raise AssertionError("reliability: the update after an exhausted budget did not count")
    return {"attempts": hook.calls, "rolled_back": rolled_back, "update_count_after_failure": count,
            "update_count_after_next": metric.update_count}


def deterministic_attempts(metric, bad_batch) -> dict:
    """A batch the trunk cannot take: the error classifies deterministic, takes one
    attempt, and leaves the states and the count as they were."""
    from torchmetrics_tpu_torch.reliability import DETERMINISTIC, classify_exception

    before, count = tensor_states(metric), metric.update_count
    with injected(metric, 99) as hook:
        try:
            metric.update(bad_batch, real=True)
        except Exception as exc:  # noqa: BLE001 -- the classifier decides
            error = exc
        else:
            raise AssertionError("reliability: a wrong-shaped batch was accepted")
    verdict = classify_exception(error)
    if verdict != DETERMINISTIC or hook.calls != 1 or metric.update_count != count \
            or not states_equal(tensor_states(metric), before):
        raise AssertionError(f"reliability: {type(error).__name__} classified {verdict} took {hook.calls} attempts")
    return {"error": type(error).__name__, "verdict": verdict, "attempts": hook.calls}


def kernel_error_verdicts(build_log: str) -> dict:
    """The verdicts of sepconv7's launch error and of a failed build carrying this run's
    own nvcc log: both deterministic, so no retry can hide a kernel or build fault."""
    from torchmetrics_tpu_torch.reliability import DETERMINISTIC, classify_exception

    texts = {f"launch_error_{rc}": f"sepconv7: kernel launch failed with CUDA error {rc}" for rc in (1, 2, 700, 719)}
    texts["build_error"] = f"nvcc failed on torchmetrics_tpu_torch/csrc/sepconv7.cu:\n{build_log}"
    verdicts = {name: classify_exception(RuntimeError(text)) for name, text in texts.items()}
    if any(v != DETERMINISTIC for v in verdicts.values()):
        raise AssertionError(f"reliability: a kernel error would be retried: {verdicts}")
    return verdicts


def sync_collection(fid_source, preds, target, gather, device=None):
    """``{fid, acc}`` with ``gather`` as their ``dist_sync_fn`` and the retry policy:
    FID holds ``fid_source``'s states, the accuracy one update of the main path's rows."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    fid = reliability_fid(fid_source.inception, retry_config(), device, dist_sync_fn=gather)
    fid_source.persistent(True)
    fid.load_state_dict(fid_source.state_dict())
    acc = MulticlassAccuracy(5, average="micro", validate_args=False, dist_sync_fn=gather,
                             reliability=retry_config(), device=device)
    acc.update(preds, target)
    return MetricCollection({"fid": fid, "acc": acc}, device=device)


def retried_sync(build, **sync_kwargs) -> dict:
    """A sync through ``FlakyGather`` over the real gather, whose first call fails, must
    give the unfaulted sync's states bit for bit; then, with one of FID's sums poisoned,
    the validated sync raises ``StateCorruptionError`` and every member keeps its local
    states. ``build(gather)`` makes the collection."""
    import warnings

    from torchmetrics_tpu_torch.parallel.sync import gather_all_arrays
    from torchmetrics_tpu_torch.reliability import FlakyGather, poison_state_leaf
    from torchmetrics_tpu_torch.utilities.exceptions import StateCorruptionError

    clean = build(gather_all_arrays)
    clean.sync(**sync_kwargs)
    want = {name: dict(m._state) for name, m in clean.items(keep_base=True)}
    flaky = FlakyGather(inner=gather_all_arrays, fail_times=1)
    coll = build(flaky)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        coll.sync(**sync_kwargs)
    recovered = all(states_equal(m._state, want[name]) for name, m in coll.items(keep_base=True))
    if flaky.failures != 1 or not recovered:
        raise AssertionError(f"reliability: the flaky sync failed {flaky.failures} times, recovered {recovered}")
    coll.unsync()
    poison_state_leaf(coll["fid"], POISONED_LEAF)
    local = {name: dict(m._state) for name, m in coll.items(keep_base=True)}
    try:
        coll.sync(**sync_kwargs)
    except StateCorruptionError:
        pass
    else:
        raise AssertionError("reliability: a poisoned state passed the validated sync")
    kept = all(not m._is_synced and all(m._state[k] is v for k, v in local[name].items())
               for name, m in coll.items(keep_base=True))
    if not kept:
        raise AssertionError("reliability: a member adopted a synced state after the guard raised")
    return {"gather_calls": flaky.calls, "gather_failures": flaky.failures, "recovered_bitwise": recovered,
            "poisoned_leaf": POISONED_LEAF, "local_states_kept": kept}


def plot_value_checks(values: dict) -> dict:
    """``_to_np`` of each value in float32 and bfloat16 equals ``.float().cpu().numpy()``,
    and ``Metric.plot`` without matplotlib raises the JAX package's text (matplotlib is
    never imported). ``values`` maps a name to ``(metric, value)``."""
    from torchmetrics_tpu_torch.utilities import plot as port_plot

    checked = {}
    for name, (metric, value) in values.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = value.to(dtype)
            got, want = port_plot._to_np(x), x.float().cpu().numpy()
            if got.dtype != want.dtype or not np.array_equal(got, want, equal_nan=True):
                raise AssertionError(f"reliability: _to_np of {name} in {dtype} is not its host float32 copy")
        available, port_plot._MATPLOTLIB_AVAILABLE = port_plot._MATPLOTLIB_AVAILABLE, False
        try:
            metric.plot(value)
        except ModuleNotFoundError as exc:
            message = str(exc)
        else:
            message = None
        finally:
            port_plot._MATPLOTLIB_AVAILABLE = available
        if message != PLOT_ERROR_TEXT:
            raise AssertionError(f"reliability: {name}.plot without matplotlib raised {message!r}")
        checked[name] = list(x.shape)
    return {"values": checked, "matplotlib_available": port_plot._MATPLOTLIB_AVAILABLE}


def reliability_phase(card: str) -> int:
    """FID's update under a ``RetryPolicy`` through the bf16 trunk (sepconv7's 26
    launches a forward) at batch 128: the card repeats an uninterrupted run, a retried
    run equals it, an exhausted budget rolls back, a deterministic error takes one
    attempt; then a retried sync through ``FlakyGather`` over NCCL in a world of one, the
    sync guard, the costs and the plot values. Returns the sepconv7 launches of the
    retried run, the path's count."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance, InceptionV3Features
    from torchmetrics_tpu_torch.kernels.sepconv import KERNEL, sepconv7

    started = time.perf_counter()
    # He-scaled seeded weights: the default init's features are nearly constant, and FID
    # between them sits at float64's cancellation floor
    extractor = InceptionV3Features.from_numpy_params(he_scaled(InceptionV3Features._random_params(0)),
                                                      compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(18)
    # real images uniform, fake ones (the odd updates) squared: two distributions
    batches = [torch.rand((RELIABILITY_BATCH, 3, 299, 299), generator=gen, device="cuda") ** (1 + i % 2)
               for i in range(RELIABILITY_UPDATES)]
    runs = []
    for _ in range(2):  # the card against itself first
        plain = reliability_fid(extractor)
        fid_updates(plain, batches)
        runs.append(plain)
    torch.cuda.synchronize()
    reference = tensor_states(runs[0])
    spread = state_spread(tensor_states(runs[1]), reference)
    repeats = all(torch.equal(runs[1]._state[k], v) for k, v in reference.items())
    spread_cause = None if repeats else (
        "the card's uninterrupted runs differ: cuDNN may pick other convolution algorithms between runs "
        f"(torch.backends.cudnn.deterministic={torch.backends.cudnn.deterministic}, "
        f"benchmark={torch.backends.cudnn.benchmark}); the retried run is held to this spread")
    want_value = runs[0].compute()

    retried = reliability_fid(extractor, retry_config())
    torch.cuda.synchronize()
    sepconv7.launches = 0
    fault = retried_fid_run(retried, batches)
    torch.cuda.synchronize()
    launches = sepconv7.launches
    if launches != SEPCONV_PER_FORWARD * RELIABILITY_UPDATES:
        raise AssertionError(f"reliability: {launches} sepconv7 launches over {RELIABILITY_UPDATES} retried updates")
    got_states = tensor_states(retried)
    if not within_spread(got_states, reference, spread):
        raise AssertionError(f"reliability: the retried run's states differ from the uninterrupted run's: "
                             f"{state_spread(got_states, reference)} beyond {spread}")
    got_value = retried.compute()
    value_equal = torch.equal(got_value, want_value)
    if repeats and not value_equal:
        raise AssertionError(f"reliability: retried FID {float(got_value)} against {float(want_value)}")

    exhausted = exhausted_budget(reliability_fid(extractor, retry_config()), batches)
    deterministic = deterministic_attempts(reliability_fid(extractor, retry_config()),
                                           torch.rand((RELIABILITY_BATCH, 4, 299, 299), generator=gen, device="cuda"))
    verdicts = kernel_error_verdicts(KERNEL.build_log)

    # costs: an update with and without the policy, the backup's clones, the launch calls
    builds = {"none": reliability_fid(extractor), "policy": reliability_fid(extractor, retry_config())}
    update_ms = {}
    for key, metric in builds.items():
        update_ms[key] = median_ms(lambda m=metric: (m.update(batches[1], real=False), torch.cuda.synchronize()),
                                   iters=RELIABILITY_TIMED)
    states = [v for v in builds["policy"]._state.values() if isinstance(v, torch.Tensor)]
    clone_bytes = sum(v.numel() * v.element_size() for v in states)
    clone_ms = cuda_ms(lambda: [v.clone() for v in states], iters=20)
    clone_bound_ms = 2 * clone_bytes / PEAK_BYTES_PER_S * 1e3  # each byte read once and written once
    calls = {}
    as_built = FrechetInceptionDistance(feature=extractor, normalize=True)  # no keyword, as fid_phase builds it
    for key, metric in (("as_fid_phase_builds_it", as_built), *builds.items()):
        events = profile_step(f"reliability_fid_update_{key}", lambda m=metric: m.update(batches[1], real=False))
        calls[key] = {"launch_calls": launch_calls(events), "memcpy_calls": launch_calls(events, "Memcpy")}
    if calls["none"] != calls["as_fid_phase_builds_it"]:
        raise AssertionError(f"reliability: an update with reliability=None made other calls: {calls}")
    extra_calls = {k: calls["policy"][k] - calls["none"][k] for k in calls["none"]}
    if extra_calls["launch_calls"] + extra_calls["memcpy_calls"] != len(states):
        raise AssertionError(f"reliability: the policy's backup made {extra_calls} calls for {len(states)} states")

    preds = torch.randn((RELIABILITY_ACC_BATCH, 5), generator=gen, device="cuda")
    target = torch.randint(0, 5, (RELIABILITY_ACC_BATCH,), generator=gen, device="cuda")
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_reliability_")
    torch.cuda.set_device(0)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        def build(gather):
            return sync_collection(runs[0], preds, target, gather)

        sync = retried_sync(build, distributed_available=lambda: True)
        coll = build(None)
        reads = host_reads(lambda: coll.sync(distributed_available=lambda: True))
        coll.unsync()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)

    confmat = MulticlassConfusionMatrix(5, normalize="true", validate_args=False)
    confmat.update(preds, target)
    plot = plot_value_checks({"fid": (runs[0], want_value), "confusion_matrix": (confmat, confmat.compute())})
    emit({"phase": "reliability", "batch": RELIABILITY_BATCH, "updates": RELIABILITY_UPDATES, "trunk": "bfloat16",
          "card_repeats_bitwise": repeats, "card_spread": spread, "spread_cause": spread_cause,
          "retried": {**fault, "fail_on": RELIABILITY_FAIL_ON, "states_equal": within_spread(got_states, reference, spread),
                      "states_bitwise": states_equal(got_states, reference), "fid": float(got_value),
                      "fid_uninterrupted": float(want_value), "fid_bitwise": value_equal},
          "sepconv7_launches": launches, "exhausted": exhausted, "deterministic": deterministic,
          "kernel_error_verdicts": verdicts,
          "update_ms": update_ms, "clone_bytes_per_update": clone_bytes, "clone_ms": clone_ms,
          "clone_bound_ms": clone_bound_ms, "calls_per_update": calls, "policy_extra_calls": extra_calls,
          "sync": {**sync, "host_reads_validated_sync": reads}, "plot": plot,
          "seconds": time.perf_counter() - started, "card": card})
    return launches


# ---------------------------------------------------------------------------
# the observability plane: FID's update, the main path and its sync under a session

OBS_BATCH = 128
OBS_UPDATES = 4
OBS_MAIN_BATCH = 65536
OBS_MAIN_UPDATES = 20
OBS_FEATURES = 2048
FID_UPDATE_SPAN = "FrechetInceptionDistance.update"
# the trunk's spatial sizes: the stem's convs in order from 299x299, then each block's input
STEM_SIZES = {"stem1": 299, "stem2": 149, "stem3": 147, "stem4": 73, "stem5": 73}
BLOCK_SIZES = {"mixed_a": 35, "mixed_b": 35, "mixed_c": 17, "mixed_d": 17, "mixed_e": 8}


def conv_flops(conv, size: int, batch: int) -> int:
    """``2·B·O·C·kh·kw·Ho·Wo`` of one ``BasicConv2d`` on a ``size`` x ``size`` input:
    "VALID" convs (stride 1 or 2) shrink the plane, "SAME" stride-1 convs keep it."""
    o, c, kh, kw = conv.w.shape
    valid = conv.padding == 0
    ho = (size - kh) // conv.stride + 1 if valid else size
    wo = (size - kw) // conv.stride + 1 if valid else size
    return 2 * batch * o * c * kh * kw * ho * wo


def trunk_flops(extractor, batch: int) -> int:
    """Multiply-adds times two of every conv of one InceptionV3 trunk forward at
    ``batch`` 299x299 images, from the conv shapes alone: the 26 separable convs that
    ``sepconv7`` runs and the rest that ``F.conv2d`` runs. Every conv of a block takes
    the block's input plane (a strided conv shrinks its own output only)."""
    total = sum(conv_flops(extractor.stem[name], size, batch) for name, size in STEM_SIZES.items())
    for name, block in extractor.blocks.items():
        size = BLOCK_SIZES[name.rstrip("0123456789")]
        total += sum(conv_flops(conv, size, batch) for conv in block.c.values())
    return total


def fid_update_flops(extractor, batch: int, features: int = OBS_FEATURES) -> int:
    """One FID update's matmul and conv flops: the trunk's convs and the ``f.T @ f``
    covariance product (``2·B·F·F``), the ops ``FlopCounterMode`` counts."""
    return trunk_flops(extractor, batch) + 2 * batch * features * features


def launches_inside_spans(events, span: str, kernel: str) -> dict:
    """Where the launches of the kernels named ``kernel`` fall in a ``torch.profiler``
    trace: each device event whose name holds ``kernel`` is matched to its host launch
    call (the same correlation id) and that call to the host ranges named ``span``.
    Returns the kernels, how many launches lie inside a span, and the kernels per span."""
    from torch.autograd import DeviceType

    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CPU and e.name == span)
    launch_of = {e.id: e for e in events if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and kernel in e.name]
    per_span = [0] * len(ranges)
    inside = 0
    for k in kernels:
        launch = launch_of.get(k.id)
        if launch is None:
            continue
        for i, (begin, end) in enumerate(ranges):
            if begin <= launch.time_range.start and launch.time_range.end <= end:
                per_span[i] += 1
                inside += 1
                break
    return {"kernels": len(kernels), "inside": inside, "spans": len(ranges), "per_span": per_span}


def traced(step, tries: int = 4, want=None, all_threads: bool = False) -> list:
    """``step`` once under ``torch.profiler`` after ``PROFILE_LEAD_LAUNCHES`` lead
    launches and a pause (a trace can lose the device events of its first launches);
    taken again, up to ``tries`` times, until ``want(events)`` holds. Returns the
    trace's events. ``all_threads`` records the host events of every thread (a
    background sync's collectives), not only the caller's."""
    from torch.profiler import ProfilerActivity, profile

    extra = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        extra["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    lead = torch.zeros(1, device="cuda")
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **extra) as prof:
            for _ in range(PROFILE_LEAD_LAUNCHES):
                lead.add_(1)
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
            step()
            torch.cuda.synchronize()
        events = list(prof.events())
        if want is None or want(events):
            break
    return events


def collectives_of(events) -> dict:
    from torch.autograd import DeviceType

    return count_collective_ops(e.name for e in events if e.device_type == DeviceType.CPU)


def captured_metadata_rows(call) -> list:
    """The metadata rows the coalesced sync hands to its transport while ``call`` runs."""
    from torchmetrics_tpu_torch.parallel import coalesce

    rows, original = [], coalesce._gather_metadata

    def capture(gather, meta, process_group, real):
        rows.append(np.array(meta, copy=True))
        return original(gather, meta, process_group, real)

    coalesce._gather_metadata = capture
    try:
        call()
    finally:
        coalesce._gather_metadata = original
    return rows


def cpu_metadata_row(states, reductions, counters_vector, hist_vector):
    """The row the port's encoder builds on the CPU from copies of ``states`` and the
    given counter and histogram vectors."""
    from torchmetrics_tpu_torch.parallel import coalesce

    cpu = [{k: [t.cpu() for t in v] if isinstance(v, list) else v.cpu() for k, v in s.items()} for s in states]
    return coalesce._encode_metadata(coalesce._prepare_leaves(cpu, reductions), counters_vector, hist_vector)


def obs_collection(device=None, members=("acc", "f1", "confmat")):
    """The main path's ``{acc, f1, confmat}`` with compute groups, or some of it."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import classification as tc

    build = {
        "acc": lambda: tc.MulticlassAccuracy(5, average="micro", validate_args=False, device=device),
        "f1": lambda: tc.MulticlassF1Score(5, validate_args=False, device=device),
        "confmat": lambda: tc.MulticlassConfusionMatrix(5, validate_args=False, device=device),
    }
    return MetricCollection({name: build[name]() for name in members}, compute_groups=True, device=device)


def timed_updates(coll, batches) -> list:
    """Host ms of each update, the card synchronised around it."""
    times = []
    for preds, target in batches:
        torch.cuda.synchronize()
        start = time.perf_counter()
        coll.update(preds, target)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return times


def trace_report(path: str) -> dict:
    """``tools/trace_report.py --json`` on a JSONL trace, as a user runs it."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "trace_report.py")
    out = subprocess.run([sys.executable, tool, path, "--json"], capture_output=True, text=True, check=True,
                         timeout=120)
    return json.loads(out.stdout)


def observability_phase(card: str) -> int:
    """FID's update through the bf16 trunk (He-scaled seeded weights, B=128, 4 updates)
    under ``telemetry_session(TelemetryConfig(block_until_ready=True,
    cost_accounting=True))``: the counters, each update's recorded duration beside its
    time by CUDA events, the cost record's flops beside the trunk's conv count and the
    covariance product, every sepconv7 launch of a traced run inside its update's
    profiler range, and the states equal bit for bit to a run without a session. Then
    the main path's collection ``{acc, f1, confmat}`` at batch 65536: update ms with
    telemetry off, on and on with blocking timing, launch calls off and on, updates
    under ``set_sync_debug_mode("error")`` with the session on, ``telemetry_summary()``;
    its coalesced sync in an NCCL group of one: ``sync_collectives`` against the
    profiler's NCCL count, ``sync_payload_bytes`` against the payload shipped, the
    metadata row against the CPU encoder's, and the fleet rollups. The phase's JSONL
    trace goes through ``tools/trace_report.py``. Returns the sepconv7 launches of the
    session's run, the path's count."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from torchmetrics_tpu_torch import observability as obs
    from torchmetrics_tpu_torch.image import InceptionV3Features
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7

    started = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_observability_")
    trace_path = os.path.join(workdir, "trace.jsonl")

    def session(**kwargs):
        return obs.telemetry_session(obs.TelemetryConfig(
            sinks=(obs.JSONLSink(trace_path), obs.RingBufferSink(4096)), **kwargs))

    extractor = InceptionV3Features.from_numpy_params(he_scaled(InceptionV3Features._random_params(0)),
                                                      compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(19)
    batches = [torch.rand((OBS_BATCH, 3, 299, 299), generator=gen, device="cuda") ** (1 + i % 2)
               for i in range(OBS_UPDATES)]
    plain = reliability_fid(extractor)
    fid_updates(plain, batches)
    torch.cuda.synchronize()

    fid = reliability_fid(extractor)
    event_ms = []
    torch.cuda.synchronize()
    sepconv7.launches = 0
    with session(block_until_ready=True, cost_accounting=True) as rec:
        for i, imgs in enumerate(batches):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fid.update(imgs, real=i % 2 == 0)
            end.record()
            end.synchronize()
            event_ms.append(start.elapsed_time(end))
        snap = rec.counters.snapshot()
        costs = rec.cost_snapshot()
        recorded_ms = [e.duration_s * 1e3 for e in rec.events_of("dispatch")]
    torch.cuda.synchronize()
    launches = sepconv7.launches
    counts = {k: snap[k] for k in ("dispatches", "jit_compiles", "jit_cache_hits", "d2h_readbacks", "retraces")}
    if counts != {"dispatches": OBS_UPDATES, "jit_compiles": 1, "jit_cache_hits": OBS_UPDATES - 1,
                  "d2h_readbacks": 0, "retraces": 0}:
        raise AssertionError(f"observability: FID's counters under a session are {counts}")
    if launches != SEPCONV_PER_FORWARD * OBS_UPDATES:
        raise AssertionError(f"observability: {launches} sepconv7 launches over {OBS_UPDATES} updates")
    if len(recorded_ms) != OBS_UPDATES or any(r < 0.9 * e for r, e in zip(recorded_ms, event_ms)):
        raise AssertionError(f"observability: blocking durations {recorded_ms} ms against CUDA events {event_ms} ms")
    ((key, sigs),) = costs.items()
    ((signature, cost),) = sigs.items()
    want_flops = fid_update_flops(extractor, OBS_BATCH)
    if not cost["available"] or cost["flops"] != want_flops:
        raise AssertionError(f"observability: the cost record of {key} holds {cost}, {want_flops} flops derived")
    bitwise = all(torch.equal(v, plain._state[k]) for k, v in tensor_states(fid).items())
    repeats = None
    if not bitwise:  # is the card itself repeating? (see the reliability phase)
        again = reliability_fid(extractor)
        fid_updates(again, batches)
        repeats = all(torch.equal(v, plain._state[k]) for k, v in tensor_states(again).items())
        if repeats:
            raise AssertionError("observability: a session changed FID's states")

    span_fid = reliability_fid(extractor)
    with session():
        events = traced(lambda: fid_updates(span_fid, batches),
                        want=lambda ev: launches_inside_spans(ev, FID_UPDATE_SPAN, "sepconv7")["kernels"]
                        == SEPCONV_PER_FORWARD * OBS_UPDATES)
    spans = launches_inside_spans(events, FID_UPDATE_SPAN, "sepconv7")
    if spans["kernels"] != SEPCONV_PER_FORWARD * OBS_UPDATES or spans["inside"] != spans["kernels"] \
            or spans["per_span"] != [SEPCONV_PER_FORWARD] * OBS_UPDATES:
        raise AssertionError(f"observability: sepconv7 launches against the update spans: {spans}")

    # the main path: the {acc, f1, confmat} collection with compute groups
    rows = [(torch.randn((OBS_MAIN_BATCH, 5), generator=gen, device="cuda"),
             torch.randint(0, 5, (OBS_MAIN_BATCH,), generator=gen, device="cuda")) for _ in range(OBS_MAIN_UPDATES)]
    coll = obs_collection()
    coll.update(*rows[0])  # derives the groups (an allclose read), outside the timed runs
    update_ms = {"off": [], "on": [], "on_blocking": []}
    for _ in range(2):  # off, on, blocking, twice over: the card's drift spreads over all three
        update_ms["off"] += timed_updates(coll, rows)
        with session():
            update_ms["on"] += timed_updates(coll, rows)
        with session(block_until_ready=True):
            update_ms["on_blocking"] += timed_updates(coll, rows)
    update_ms = {k: median(v) for k, v in update_ms.items()}
    calls = {"off": launch_calls(profile_step("observability_update_off", lambda: coll.update(*rows[1])))}
    with session():
        calls["on"] = launch_calls(profile_step("observability_update_on", lambda: coll.update(*rows[1])))
    if calls["on"] != calls["off"]:
        raise AssertionError(f"observability: a session changed the launch calls of an update: {calls}")
    # the confusion matrix's bincount reads the card once an update on its own: telemetry
    # must add no read to it, and the stat-score members must run under "error" mode
    reads = {"off": host_reads(lambda: coll.update(*rows[3]))}
    with session():  # a fresh session: its first update harvests the cost too
        reads["on"] = host_reads(lambda: coll.update(*rows[3]))
    if reads["on"] != reads["off"]:
        raise AssertionError(f"observability: a session changed the host reads of an update: {reads}")
    stat_scores = obs_collection(members=("acc", "f1"))
    stat_scores.update(*rows[0])  # derives the groups
    with session():  # fresh again: the harvest runs under "error" mode too
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for preds, target in rows[:3]:
                stat_scores.update(preds, target)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    with session():
        for preds, target in rows[:3]:
            coll.update(preds, target)
        summary = coll.telemetry_summary()
    fused = {name: info.get("fused_into") for name, info in summary["members"].items()}
    if fused != {"acc": None, "f1": "acc", "confmat": None} or summary["members"]["acc"]["dispatches"] != 3:
        raise AssertionError(f"observability: telemetry_summary's members are {summary['members']}")

    # the coalesced sync in an NCCL group of one
    states, reductions = distinct_states(coll)
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_observability_nccl_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with session() as rec:
            coll.update(*rows[2])
            before = rec.counters.snapshot()
            vectors = (rec.counters.counts_vector(), rec.histograms.fleet_vector())
            holder = {}
            metadata = captured_metadata_rows(lambda: holder.setdefault(
                "events", traced(lambda: coll.sync(distributed_available=lambda: True))))
            after = rec.counters.snapshot()
            traced_sync = collectives_of(holder["events"])
            want_row = cpu_metadata_row(states, reductions, *vectors)
            meta_bytes = want_row.nbytes
            # the row is metadata: the payload counter holds the states' bytes, as in the JAX package
            payload = shipped_bytes(states, reductions) - meta_bytes
            sync = {"collectives": after["sync_collectives"] - before["sync_collectives"], "traced": traced_sync,
                    "payload_bytes": after["sync_payload_bytes"] - before["sync_payload_bytes"],
                    "shipped_payload_bytes": payload, "metadata_row_bytes": meta_bytes,
                    "metadata_row_equal": len(metadata) == 1 and np.array_equal(metadata[0], want_row),
                    "gathers_coalesced": after["gathers_coalesced"] - before["gathers_coalesced"]}
            if sync["collectives"] != traced_sync.get("by_name", {}).get("nccl:all_gather", 0) \
                    or sync["collectives"] != traced_sync["total"] or sync["payload_bytes"] != payload \
                    or not sync["metadata_row_equal"]:
                raise AssertionError(f"observability: the sync's records against its trace: {sync}")
            rollups = {}
            for label, call in (("gather_counters", obs.gather_counters), ("gather_histograms", obs.gather_histograms),
                                ("gather_counters_fresh", lambda: obs.gather_counters(prefer_sync_rows=False))):
                got = {}
                rollups[label] = collectives_of(traced(lambda c=call: got.setdefault("value", c())))
                value = got["value"]
                rollups[label].update({"ranks": value.ranks} if hasattr(value, "ranks") else {"kinds": len(value)})
            if rollups["gather_counters"]["total"] or rollups["gather_histograms"]["total"] \
                    or rollups["gather_counters_fresh"]["total"] != 1:
                raise AssertionError(f"observability: the fleet rollups launched {rollups}")
            coll.unsync()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    report = trace_report(trace_path)
    shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "observability", "batch": OBS_BATCH, "updates": OBS_UPDATES, "trunk": "bfloat16",
          "fid": {"counters": counts, "recorded_ms": recorded_ms, "cuda_event_ms": event_ms,
                  "cost": {"key": key, "signature": signature, **cost}, "flops_derived": want_flops,
                  "sepconv7_launches": launches, "spans": spans, "states_bitwise": bitwise,
                  "card_repeats_bitwise": repeats},
          "main_path": {"batch": OBS_MAIN_BATCH, "updates": OBS_MAIN_UPDATES, "update_ms": update_ms,
                        "launch_calls_per_update": calls, "host_reads_per_update": reads,
                        "sync_debug_error_updates": {"members": ["acc", "f1"], "updates": 3},
                        "groups": group_sets(coll), "summary_members": summary["members"]},
          "sync": sync, "rollups": rollups,
          "trace_report": {"rows": len(report.get("rows", [])), "keys": sorted(report)},
          "seconds": time.perf_counter() - started, "card": card})
    return launches


# ---------------------------------------------------------------------------
# the AOT warm-start plane

AOT_CHILD_FLAG = "--aot-child"
AOT_BATCH = 65536
AOT_UPDATES = 16
AOT_MEMBERS = ("acc", "f1", "confmat")
AOT_TAGS = ("update", "forward")
AOT_CODECS = ["aoti", "torch_export"]
AOT_CORRUPT_MEMBER = "confmat"
AOT_CHILD_WALL_S = 240
# "warm" and "corrupt" boot with the plane on the cache ("corrupt" takes no timings:
# it runs beside the parent's FID work), "cold" with none; "window" boots the streaming
# phase's windowed accuracy on the cache; "serve" boots the serving phase's engine with
# ServingConfig(aot_cache_dir=...) (a first boot writes through, a second loads)
AOT_CHILD_MODES = ("warm", "cold", "corrupt", "window", "serve")
AOT_SEED = 53
MAPEVAL_ATOL = 1e-6  # the loaded evaluator against the eager one
MAPEVAL_CHILD_FLAG = "--mapeval-child"
MAPEVAL_STATES = ("det_rows", "gt_rows", "det_n", "gt_n", "img_n")
MAPEVAL_CHILD_WALL_S = 600
# the phase's budget, its compiles included: reported beside its seconds (a slower host
# compiles slower; the checks, not the clock, decide the phase)
AOT_PHASE_LIMIT_S = 180


def aot_rows(updates: int = AOT_UPDATES, batch: int = AOT_BATCH, device: str = "cuda") -> list:
    """The phase's seeded batches of the main path: (logits, labels) at 5 classes."""
    gen = torch.Generator(device=device).manual_seed(AOT_SEED)
    return [(torch.randn((batch, 5), generator=gen, device=device),
             torch.randint(0, 5, (batch,), generator=gen, device=device)) for _ in range(updates)]


def aot_states(coll) -> dict:
    """Every member's tensor states as lists (a child prints them, the parent compares)."""
    return {name: {k: v.cpu().tolist() for k, v in metric._state.items()} for name, metric in coll.items()}


def parse_aot_child(argv: list):
    """``--aot-child CACHE_DIR MODE`` → ``(cache_dir, mode)``; None for other argv."""
    if argv[1:2] != [AOT_CHILD_FLAG]:
        return None
    if len(argv) != 4 or argv[3] not in AOT_CHILD_MODES:
        raise SystemExit(f"usage: chip_smoke.py {AOT_CHILD_FLAG} CACHE_DIR {'|'.join(AOT_CHILD_MODES)}")
    return argv[2], argv[3]


def aot_child(cache_dir: str, mode: str) -> int:
    """A fresh interpreter's boot: the main path's collection, with the plane on
    ``cache_dir`` ("warm", "corrupt") or none ("cold"), takes the phase's 16 batches
    under a telemetry session; prints a RESULT line with the counters, the loads, the
    time to the first update, steady update ms and launch calls, and the states. The
    modules a first load and a first cost harvest import (Inductor's, the flop counter)
    are imported first and timed apart: about 9 s of Python, the same for every boot."""
    if mode == "serve":
        result = serve_child(cache_dir)
        print("RESULT" + json.dumps({**result, "first_update_done_unix": time.time()}), flush=True)
        return 0
    clock = time.perf_counter()
    import torch._inductor.package  # noqa: F401
    import torch.utils.flop_counter  # noqa: F401

    from torchmetrics_tpu_torch import aot
    from torchmetrics_tpu_torch import observability as obs
    from torchmetrics_tpu_torch.parallel.mesh import runtime_fingerprint

    imports_s = time.perf_counter() - clock
    plane = aot.enable(cache_dir) if mode != "cold" else None
    rows = aot_rows()
    if mode == "window":
        from torchmetrics_tpu_torch.streaming import SlidingWindow

        coll = SlidingWindow(obs_collection(members=("acc",))["acc"], STREAM_WINDOW)
    else:
        coll = obs_collection()
    torch.cuda.synchronize()
    with obs.telemetry_session() as rec:
        start = time.perf_counter()
        coll.update(*rows[0])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - start) * 1e3
        first_done_unix = time.time()
        for preds, target in rows[1:]:
            coll.update(preds, target)
        torch.cuda.synchronize()
        snap = rec.counters.snapshot()
        loads = [{**e.payload, "metric": e.metric, "ms": e.duration_s * 1e3} for e in rec.events_of("aot_load")]
    states = {k: v.cpu().tolist() for k, v in coll._wstate.items()} if mode == "window" else aot_states(coll)
    steady_ms = calls = None
    if mode in ("warm", "cold"):
        steady_ms = median(timed_updates(coll, rows[1:9]))
        calls = launch_calls(profile_step(f"aot_update_{mode}", lambda: coll.update(*rows[1])))
    print("RESULT" + json.dumps({
        "mode": mode, "imports_s": imports_s, "first_update_ms": first_ms, "first_update_done_unix": first_done_unix,
        "runtime": runtime_fingerprint(),
        "counters": {k: snap[k] for k in ("dispatches", "jit_compiles", "jit_cache_hits", "aot_cache_hits",
                                          "aot_cache_misses", "aot_deserialize_us")},
        "plane": dict(plane.stats) if plane is not None else None, "loads": loads,
        "steady_update_ms": steady_ms, "launch_calls_per_update": calls, "states": states}), flush=True)
    return 0


def start_aot_child(cache_dir: str, mode: str):
    """Start this script with ``--aot-child``; :func:`finish_aot_child` takes its result."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), AOT_CHILD_FLAG, cache_dir, mode],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, mode, time.time()


def run_aot_child(cache_dir: str, mode: str) -> dict:
    return finish_aot_child(start_aot_child(cache_dir, mode))


def finish_aot_child(started) -> dict:
    """The RESULT of a child from :func:`start_aot_child`; a child that fails or outlives
    ``AOT_CHILD_WALL_S`` fails the phase."""
    proc, mode, started_unix = started
    try:
        text, _ = proc.communicate(timeout=AOT_CHILD_WALL_S)
    finally:
        proc.kill()
        proc.wait()
    lines = [line for line in text.splitlines() if line.startswith("RESULT")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"aot: the {mode} child failed (exit {proc.returncode}): {text[-3000:]}")
    result = json.loads(lines[-1][len("RESULT"):])
    # from the interpreter's start (imports, the card's context, the batches) to the
    # first update's end: what a freshly booted process waits for
    result["boot_to_first_update_s"] = result.pop("first_update_done_unix") - started_unix
    return result


def state_differences(got: dict, want: dict) -> dict:
    """``member.state`` → (got, want) for each state of ``aot_states`` that differs."""
    return {f"{name}.{key}": (got.get(name, {}).get(key), value)
            for name, states in want.items() for key, value in states.items()
            if got.get(name, {}).get(key) != value}


def reconciled(counters: dict) -> bool:
    return counters["jit_compiles"] + counters["jit_cache_hits"] + counters["aot_cache_hits"] \
        == counters["dispatches"]


def flip_byte(path: str) -> None:
    """One byte in the middle of a cache entry, inverted."""
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0xFF]))


def aot_fid(cache_dir: str) -> dict:
    """FID (bf16 trunk, He-scaled seeded weights, batch 128, 4 updates) with the plane
    on ``cache_dir``: uncacheable at ``precompile``, every update eager with its 26
    sepconv7 launches inside its profiler range, the counters reconciled on the eager
    side, the states those of a run without the plane."""
    from torchmetrics_tpu_torch import aot
    from torchmetrics_tpu_torch import observability as obs
    from torchmetrics_tpu_torch.image import InceptionV3Features
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7

    extractor = InceptionV3Features.from_numpy_params(he_scaled(InceptionV3Features._random_params(0)),
                                                      compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(AOT_SEED)
    batches = [torch.rand((OBS_BATCH, 3, 299, 299), generator=gen, device="cuda") ** (1 + i % 2)
               for i in range(OBS_UPDATES)]
    plain = reliability_fid(extractor)
    fid_updates(plain, batches)
    aot.enable(cache_dir)
    try:
        fid = reliability_fid(extractor)
        fid_report = fid.precompile(batches[0], real=True)["update"]
        if fid_report["status"] != "skipped" or "uncacheable" not in fid_report["reason"]:
            raise AssertionError(f"aot: FID's precompile row is {fid_report}")
        torch.cuda.synchronize()
        sepconv7.launches = 0
        with obs.telemetry_session() as rec:
            fid_updates(fid, batches)
            torch.cuda.synchronize()
            fid_counters = {k: rec.counters.snapshot()[k] for k in ("dispatches", "jit_compiles", "jit_cache_hits",
                                                                    "aot_cache_hits", "aot_cache_misses")}
        launches = sepconv7.launches
        span_fid = reliability_fid(extractor)
        events = traced(lambda: fid_updates(span_fid, batches),
                        want=lambda ev: launches_inside_spans(ev, FID_UPDATE_SPAN, "sepconv7")["kernels"]
                        == SEPCONV_PER_FORWARD * OBS_UPDATES)
    finally:
        aot.disable()
    if launches != SEPCONV_PER_FORWARD * OBS_UPDATES:
        raise AssertionError(f"aot: {launches} sepconv7 launches over {OBS_UPDATES} FID updates under the plane")
    if fid_counters != {"dispatches": OBS_UPDATES, "jit_compiles": 1, "jit_cache_hits": OBS_UPDATES - 1,
                        "aot_cache_hits": 0, "aot_cache_misses": 0}:
        raise AssertionError(f"aot: FID's counters under the plane are {fid_counters}")
    spans = launches_inside_spans(events, FID_UPDATE_SPAN, "sepconv7")
    if spans["kernels"] != SEPCONV_PER_FORWARD * OBS_UPDATES or spans["inside"] != spans["kernels"] \
            or spans["per_span"] != [SEPCONV_PER_FORWARD] * OBS_UPDATES:
        raise AssertionError(f"aot: sepconv7 launches against the update spans: {spans}")
    bitwise = all(torch.equal(v, plain._state[k]) for k, v in tensor_states(fid).items())
    repeats = None
    if not bitwise:  # is the card itself repeating? (see the reliability phase)
        again = reliability_fid(extractor)
        fid_updates(again, batches)
        repeats = all(torch.equal(v, plain._state[k]) for k, v in tensor_states(again).items())
        if repeats:
            raise AssertionError("aot: the plane changed FID's states")

    return {"precompile": fid_report, "counters": fid_counters, "sepconv7_launches": launches, "spans": spans,
            "states_bitwise": bitwise, "card_repeats_bitwise": repeats}


def mapeval_child(cache_dir: str) -> int:
    """A fresh interpreter that precompiles the device mAP evaluator at the map_device
    phase's geometry into ``cache_dir`` (the program reads only the state's shapes, so
    an empty metric will do) and prints its report row: the compile (about 90-160 s,
    most of it AOTInductor's) overlaps the phases that run meanwhile."""
    from torchmetrics_tpu_torch.detection import DeviceMeanAveragePrecision

    clock = time.perf_counter()
    metric = DeviceMeanAveragePrecision(capacity=DEVICE_MAP_CAPACITY, num_classes=COCO_CLASSES,
                                        gt_group_cap=GT_GROUP_CAP)
    row = metric.precompile(cache_dir=cache_dir)["mapeval"]
    row["seconds"] = time.perf_counter() - clock
    from torchmetrics_tpu_torch.parallel.mesh import runtime_fingerprint

    row["runtime"] = runtime_fingerprint()
    from torchmetrics_tpu_torch.aot import keys

    row["key"] = keys.cache_key(metric, "mapeval", {k: metric._state[k] for k in MAPEVAL_STATES}, ((), {}))
    print("RESULT" + json.dumps(row), flush=True)
    return 0


def start_mapeval(metric, result) -> dict:
    """The map_device phase's metric and eager result, with a ``--mapeval-child``
    precompiling its program into a fresh cache; :func:`aot_mapeval` takes both."""
    import tempfile

    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_mapeval_")
    import atexit

    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), MAPEVAL_CHILD_FLAG, cache_dir],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(proc.kill)  # a phase that fails before the aot phase must not leave it running
    return {"metric": metric, "result": result, "cache_dir": cache_dir, "child": proc}


def aot_mapeval(device_map: dict) -> dict:
    """The device mAP evaluator's program for the map_device phase's metric (COCO scale,
    capacity 524,288): written with both codecs by the child, and the loaded
    (``"aoti"``) ``compute()`` within ``MAPEVAL_ATOL`` of the eager one, timed beside
    it."""
    from torchmetrics_tpu_torch import aot

    metric, eager, cache_dir, proc = (device_map[k] for k in ("metric", "result", "cache_dir", "child"))
    try:
        text, _ = proc.communicate(timeout=MAPEVAL_CHILD_WALL_S)
    finally:
        proc.kill()
        proc.wait()
    lines = [line for line in text.splitlines() if line.startswith("RESULT")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"aot: the mapeval child failed (exit {proc.returncode}): {text[-3000:]}")
    row = json.loads(lines[-1][len("RESULT"):])
    if row["status"] != "written" or row["codecs"] != AOT_CODECS:
        raise AssertionError(f"aot: the mapeval row is {row}")

    def compute_once():
        metric._computed = None
        out = metric.compute()
        torch.cuda.synchronize()
        return out

    eager_ms = median_ms(compute_once, iters=3)
    plane = aot.enable(cache_dir)
    try:
        loaded = compute_once()
        slot = metric.__dict__["_aot_memo"]
        codecs = [entry.codec for key, entry in slot.items() if key[0] == "mapeval" and entry.compiled is not None]
        loaded_ms = median_ms(compute_once, iters=3)
    finally:
        aot.disable()
    diff = max(float((loaded[k].double() - eager[k].double()).abs().max()) for k in eager if eager[k].numel())
    shutil.rmtree(cache_dir, ignore_errors=True)
    if codecs != ["aoti"] or diff > MAPEVAL_ATOL or set(loaded) != set(eager):
        from torchmetrics_tpu_torch.aot import keys
        from torchmetrics_tpu_torch.parallel.mesh import runtime_fingerprint

        key = keys.cache_key(metric, "mapeval", {k: metric._state[k] for k in MAPEVAL_STATES}, ((), {}))
        raise AssertionError(f"aot: the loaded mapeval ({codecs}) is {diff} from the eager compute; plane "
                             f"{plane.stats}, key {key} against the child's {row['key']}")
    return {**{k: row.get(k) for k in ("status", "codecs", "compile_s", "export_s", "bytes", "seconds")},
            "loaded_codec": codecs[0], "max_diff": diff, "limit": MAPEVAL_ATOL,
            "compute_ms_eager": eager_ms, "compute_ms_loaded": loaded_ms}


def aot_phase(card: str, device_map=None) -> int:
    """The AOT warm-start plane on the main path and under FID (see phase 54 above);
    ``device_map`` is the map_device phase's metric and its eager result (made here from
    the phase's dataset when None). Returns the sepconv7 launches of FID's updates under
    the plane, the path's count."""
    if device_map is None:
        metric, _ = device_map_metric(*coco_scale_dataset(np.random.default_rng(6), COCO_IMAGES))
        device_map = start_mapeval(metric, metric.compute())
    import tempfile

    from torchmetrics_tpu_torch import aot
    from torchmetrics_tpu_torch.parallel.mesh import runtime_fingerprint

    started = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_aot_")
    cache_dir = os.path.join(workdir, "cache")
    rows = aot_rows()
    eager = obs_collection()
    for preds, target in rows:
        eager.update(preds, target)
    want = aot_states(eager)

    # cold: every member, both tags, both codecs
    plane = aot.enable(cache_dir)
    try:
        clock = time.perf_counter()
        report = obs_collection().precompile(*rows[0], tags=AOT_TAGS)
        precompile_s = time.perf_counter() - clock
    finally:
        aot.disable()
    written = {name: {tag: {k: report[name][tag].get(k) for k in ("status", "codecs", "compile_s", "export_s", "bytes",
                                                                  "error")}
                      for tag in AOT_TAGS} for name in AOT_MEMBERS}
    if any(row["status"] != "written" or row["codecs"] != AOT_CODECS for member in written.values()
           for row in member.values()):
        raise AssertionError(f"aot: the precompile did not write both codecs of every program: {written}")
    if plane.stats["writes"] != len(AOT_MEMBERS) * len(AOT_TAGS):
        raise AssertionError(f"aot: the plane wrote {plane.stats}")

    # warm and cold boots in fresh interpreters
    boots = {mode: run_aot_child(cache_dir, mode) for mode in ("warm", "cold")}
    warm, cold = boots["warm"], boots["cold"]
    members = len(AOT_MEMBERS)
    if warm["counters"]["aot_cache_hits"] != members or warm["counters"]["jit_compiles"] != 0 \
            or warm["counters"]["aot_cache_misses"] != 0 or not reconciled(warm["counters"]):
        raise AssertionError(f"aot: the warm boot's counters are {warm['counters']} (its runtime "
                             f"{warm['runtime']}, this process's {runtime_fingerprint()})")
    if len(warm["loads"]) != members or any(load["codec"] != "aoti" for load in warm["loads"]):
        raise AssertionError(f"aot: the warm boot's loads are {warm['loads']}")
    differ = {mode: state_differences(boot["states"], want) for mode, boot in boots.items()}
    if any(differ.values()):
        raise AssertionError(f"aot: boots whose states differ from the eager states: {differ}")

    # one flipped byte: that member misses and runs eagerly, the rest load (this boot runs
    # beside the FID part below and takes no timings)
    flip_byte(os.path.join(cache_dir, report[AOT_CORRUPT_MEMBER]["update"]["entry"] + ".aot"))
    corrupt_boot = start_aot_child(cache_dir, "corrupt")

    # the kernel under the plane: FID is uncacheable and runs eagerly, every launch counted
    try:
        fid = aot_fid(cache_dir)
    except BaseException:
        corrupt_boot[0].kill()
        corrupt_boot[0].wait()
        raise
    corrupt = finish_aot_child(corrupt_boot)
    counters = corrupt["counters"]
    if counters["aot_cache_misses"] != 1 or corrupt["plane"]["corrupt"] != 1 or counters["jit_compiles"] != 1 \
            or counters["aot_cache_hits"] != members - 1 or not reconciled(counters) or corrupt["states"] != want:
        raise AssertionError(f"aot: the corrupt boot gave {counters}, plane {corrupt['plane']}, state differences "
                             f"{state_differences(corrupt['states'], want)}")

    # the device mAP evaluator's program (compiled by the child the map_device phase started)
    mapeval = aot_mapeval(device_map)

    shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - started
    boot_line = lambda b: {k: b[k] for k in ("imports_s", "first_update_ms", "boot_to_first_update_s",  # noqa: E731
                                             "counters", "plane", "loads", "steady_update_ms",
                                             "launch_calls_per_update")}
    emit({"phase": "aot", "batch": AOT_BATCH, "updates": AOT_UPDATES, "precompile_s": precompile_s,
          "programs": written, "warm": boot_line(warm), "cold": boot_line(cold), "corrupt": boot_line(corrupt),
          "states_bitwise": True,
          "fid": fid,
          "mapeval": mapeval, "seconds": seconds, "limit_s": AOT_PHASE_LIMIT_S,
          "within_limit": seconds <= AOT_PHASE_LIMIT_S, "card": card})
    return fid["sepconv7_launches"]


STREAM_CLASSES = 5
STREAM_BATCH = 65536
STREAM_WINDOW = 64
STREAM_UPDATES = 200
STREAM_CPU_WINDOW = 4
STREAM_CPU_UPDATES = 12
STREAM_FID_WINDOW = 4
STREAM_FID_UPDATES = 10  # two rotations of the dual pair
STREAM_FID_HALFLIFE = 4
STREAM_RTOL, STREAM_ATOL = 1e-5, 1e-6  # the JAX package's window oracle (tests/test_streaming.py)
STREAM_RATIO_ATOL = 1e-6  # counts are held bit for bit, ratios within this
STREAM_LATENCY = (3000, 1024, 1000)  # updates, values an update, window: depth 16 of panes of 63
STREAM_EXACT_UPDATES = 2500  # the same at pane=1: exact per-update sliding
STREAM_RING_WINDOW = 8
STREAM_RING_UPDATES = 20
STREAM_DRIFT = (200, 100, 4096)  # updates, the update after which the label noise steps up, batch
STREAM_DRIFT_WINDOWS = (50, 10)  # reference block, test window (and evaluation cadence)
STREAM_DRIFT_THRESHOLD = 0.1
STREAM_DRIFT_ACCURACY = (0.9, 0.6)  # the share of clean labels before and after the step
STREAM_OVERLAP_UPDATES = 8
STREAM_PHASE_LIMIT_S = 90
STREAM_SEED = 55
STREAM_FID_SPAN = "FrechetInceptionDistance.wdual"


def stream_rows(n: int, batch: int = STREAM_BATCH, seed: int = STREAM_SEED, device: str = "cuda") -> list:
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn((batch, STREAM_CLASSES), generator=gen, device=device),
             torch.randint(0, STREAM_CLASSES, (batch,), generator=gen, device=device)) for _ in range(n)]


def stream_members(device=None) -> dict:
    """The main path's three members, each alone (a window wraps one metric)."""
    return {name: metric for name, metric in obs_collection(device=device).items(keep_base=True)}


def hold_window(label: str, window, factory, batches, bitwise_states: bool = True) -> dict:
    """The window-parity oracle: the window's value equals a fresh metric's fed the
    trailing ``covered_updates()`` batches; its folded states equal that metric's, bit
    for bit (counts) or within the oracle's tolerance (float sums)."""
    covered = window.covered_updates()
    fresh = factory()
    for args in batches[len(batches) - covered:] if covered else []:
        fresh.update(*args) if isinstance(args, tuple) else fresh.update(args)
    got, want = window.window_state(), fresh._state
    worst = 0.0
    for key, value in want.items():
        a, b = got[key], value
        if isinstance(b, list):
            a, b = torch.cat([t.reshape(-1) for t in a]), torch.cat([t.reshape(-1) for t in b])
        if bitwise_states:
            if not torch.equal(a.to(b.dtype), b):
                raise AssertionError(f"streaming: {label}'s window state {key} differs from the trailing batches'")
        else:
            spread = (a.double() - b.double()).abs()
            bound = STREAM_ATOL + STREAM_RTOL * b.double().abs()
            if bool((spread > bound).any()):
                raise AssertionError(f"streaming: {label}'s window state {key} is {float(spread.max())} off")
            worst = max(worst, float(spread.max()))
    value_diff = max((float((x.double() - y.double()).abs().max()) for x, y in
                      zip(tree_leaves(window.compute()).values(), tree_leaves(fresh.compute()).values())), default=0.0)
    if value_diff > (STREAM_RATIO_ATOL if bitwise_states else STREAM_ATOL + STREAM_RTOL):
        raise AssertionError(f"streaming: {label}'s value is {value_diff} from the trailing batches'")
    return {"covered": covered, "states_bitwise": bitwise_states, "state_max_diff": worst, "value_max_diff": value_diff}


def stream_updates(window, batches) -> list:
    times = []
    for args in batches:
        torch.cuda.synchronize()
        start = time.perf_counter()
        window.update(*args) if isinstance(args, tuple) else window.update(args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return times


def stream_main_path(card: str) -> dict:
    """{acc, f1, confmat}, each in SlidingWindow(window=64) (the dual tier), 200 updates
    at 65,536 x 5: the oracle on the card, a 12-update prefix at window 4 against the
    CPU port, update ms, launch calls and host reads windowed against plain."""
    from torchmetrics_tpu_torch.streaming import SlidingWindow

    rows = stream_rows(STREAM_UPDATES)
    out = {}
    for name in ("acc", "f1", "confmat"):
        window = SlidingWindow(stream_members()[name], STREAM_WINDOW)
        if window.tier != "dual":
            raise AssertionError(f"streaming: {name} took the {window.tier} tier")
        times = stream_updates(window, rows)
        out[name] = {"oracle": hold_window(name, window, lambda n=name: stream_members()[n], rows),
                     "update_ms": median(times[1:]), "state_bytes": window.state_memory()["total_bytes"]}
        plain = stream_members()[name]
        plain.update(*rows[0])
        out[name]["plain_update_ms"] = median_ms(lambda: plain.update(*rows[1]), iters=20)
        out[name]["launch_calls"] = launch_calls(profile_step(f"streaming_{name}_wdual", lambda: window.update(*rows[2])))
        out[name]["plain_launch_calls"] = launch_calls(profile_step(f"streaming_{name}_update",
                                                                    lambda: plain.update(*rows[2])))
        reads = {"windowed": host_reads(lambda: window.update(*rows[3])), "plain": host_reads(lambda: plain.update(*rows[3]))}
        if reads["windowed"] != reads["plain"]:
            raise AssertionError(f"streaming: {name}'s windowed update reads the host {reads}")
        out[name]["host_reads"] = reads
        # the CPU port on a prefix: the same batches, window 4
        cpu, card_w = (SlidingWindow(stream_members(device=d)[name], STREAM_CPU_WINDOW) for d in ("cpu", None))
        for preds, target in rows[:STREAM_CPU_UPDATES]:
            cpu.update(preds.cpu(), target.cpu())
            card_w.update(preds, target)
        for key, value in cpu.window_state().items():
            if not torch.equal(card_w.window_state()[key].cpu(), value):
                raise AssertionError(f"streaming: {name}'s window state {key} differs from the CPU port's")
        diff = max(float((a.double().cpu() - b.double()).abs().max()) for a, b in
                   zip(tree_leaves(card_w.compute()).values(), tree_leaves(cpu.compute()).values()))
        if diff > STREAM_RATIO_ATOL:
            raise AssertionError(f"streaming: {name}'s value is {diff} from the CPU port's")
        out[name]["cpu_prefix"] = {"updates": STREAM_CPU_UPDATES, "window": STREAM_CPU_WINDOW,
                                   "states_bitwise": True, "value_diff": diff}
    # {acc, f1}: windowed updates read nothing at all
    stat_scores = [SlidingWindow(stream_members()[n], STREAM_WINDOW) for n in ("acc", "f1")]
    for w in stat_scores:
        w.update(*rows[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for preds, target in rows[1:4]:
            for w in stat_scores:
                w.update(preds, target)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out["acc_f1_sync_debug_error"] = "passed"
    return out


def stream_fid(extractor) -> dict:
    """FID in SlidingWindow(window=4) over 10 updates at batch 128 (two rotations): 26
    sepconv7 launches inside each windowed update's range, the oracle within the JAX
    package's tolerance; ExponentialDecay(FID, halflife=4) on the same batches against
    the closed form in float64 on the host."""
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7
    from torchmetrics_tpu_torch.streaming import ExponentialDecay, SlidingWindow

    gen = torch.Generator(device="cuda").manual_seed(STREAM_SEED)
    batches = [(torch.rand((OBS_BATCH, 3, 299, 299), generator=gen, device="cuda") ** (1 + i % 2),)
               for i in range(STREAM_FID_UPDATES)]
    reals = [i % 2 == 0 for i in range(STREAM_FID_UPDATES)]

    def feed(metric, items=None):
        for i, (imgs,) in enumerate(items if items is not None else batches):
            metric.update(imgs, real=reals[i] if items is None else i % 2 == 0)

    window = SlidingWindow(reliability_fid(extractor), STREAM_FID_WINDOW)
    torch.cuda.synchronize()
    sepconv7.launches = 0
    start = time.perf_counter()
    feed(window)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = sepconv7.launches
    if launches != SEPCONV_PER_FORWARD * STREAM_FID_UPDATES:
        raise AssertionError(f"streaming: {launches} sepconv7 launches over {STREAM_FID_UPDATES} windowed FID updates")
    covered = window.covered_updates()
    fresh = reliability_fid(extractor)
    first = STREAM_FID_UPDATES - covered
    for i in range(first, STREAM_FID_UPDATES):
        fresh.update(batches[i][0], real=reals[i])
    worst = 0.0
    for key, want in fresh._state.items():
        got = window.window_state()[key]
        spread = (got.double() - want.double()).abs()
        if bool((spread > STREAM_ATOL + STREAM_RTOL * want.double().abs()).any()):
            raise AssertionError(f"streaming: windowed FID's {key} is {float(spread.max())} off the trailing batches'")
        worst = max(worst, float(spread.max()))
    span_window = SlidingWindow(reliability_fid(extractor), STREAM_FID_WINDOW)
    events = traced(lambda: feed(span_window),
                    want=lambda ev: launches_inside_spans(ev, STREAM_FID_SPAN, "sepconv7")["kernels"] == launches)
    spans = launches_inside_spans(events, STREAM_FID_SPAN, "sepconv7")
    if spans["inside"] != launches or spans["per_span"] != [SEPCONV_PER_FORWARD] * STREAM_FID_UPDATES:
        raise AssertionError(f"streaming: sepconv7 launches against the windowed update spans: {spans}")
    # the decay's closed form: s_n = sum_i d^(n-1-i) x_i over each side's batch states
    decayed = ExponentialDecay(reliability_fid(extractor), halflife=STREAM_FID_HALFLIFE)
    feed(decayed)
    base = decayed.base_metric
    closed = {k: np.zeros(tuple(v.shape), np.float64) for k, v in decayed._dstate.items()}
    weight = 0.0
    for i, (imgs,) in enumerate(batches):
        for k in closed:
            closed[k] *= decayed.decay
        weight = weight * decayed.decay + 1.0
        for k, v in base._batch_state(imgs, real=reals[i]).items():
            closed[k] += v.double().cpu().numpy()
    decay_worst = 0.0
    for k, want in closed.items():
        if k.startswith("__"):
            want = np.float64(weight)
        got = decayed._dstate[k].double().cpu().numpy()
        rel = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
        if rel > STREAM_RTOL:
            raise AssertionError(f"streaming: ExponentialDecay(FID)'s {k} is {rel} relative off its closed form")
        decay_worst = max(decay_worst, rel)
    return {"updates": STREAM_FID_UPDATES, "window": STREAM_FID_WINDOW, "covered": covered,
            "sepconv7_launches": launches, "spans": spans, "seconds": seconds, "state_max_diff": worst,
            "decay": {"halflife": STREAM_FID_HALFLIFE, "max_relative_diff": decay_worst, "limit": STREAM_RTOL},
            "state_bytes": window.state_memory()["total_bytes"]}


def stream_tiers() -> dict:
    """The two-stack tier on per-batch latencies (Max and Min, window 1000 of 16 panes of
    63, and exact at pane 1), the ring on Pearson (a custom merge) over the weather
    batches and on CatMetric (list states), each held to the oracle."""
    from torchmetrics_tpu_torch.aggregation import CatMetric, MaxMetric, MinMetric
    from torchmetrics_tpu_torch.regression import PearsonCorrCoef
    from torchmetrics_tpu_torch.streaming import SlidingWindow

    updates, width, window_len = STREAM_LATENCY
    gen = torch.Generator(device="cuda").manual_seed(STREAM_SEED + 1)
    latencies = [torch.rand((width,), generator=gen, device="cuda").exp_() for _ in range(updates)]
    out = {}
    for label, cls, pane, n in (("max", MaxMetric, None, updates), ("min", MinMetric, None, updates),
                                ("max_exact", MaxMetric, 1, STREAM_EXACT_UPDATES),
                                ("min_exact", MinMetric, 1, STREAM_EXACT_UPDATES)):
        window = SlidingWindow(cls(), window_len, pane=pane)
        times = stream_updates(window, latencies[:n])
        out[label] = {"tier": window.tier, "pane": window.pane, "depth": window.depth, "updates": n,
                      "flips": max(0, (n // window.pane - 1) // window.depth),
                      "update_ms": median(times), "oracle": hold_window(label, window, cls, latencies[:n]),
                      "state_bytes": window.state_memory()["total_bytes"]}
    forecast, truth = weather_inputs()
    weather = [(forecast[i], truth[i]) for i in range(STREAM_RING_UPDATES)]
    pearson = lambda: PearsonCorrCoef(num_outputs=4)  # noqa: E731
    window = SlidingWindow(pearson(), STREAM_RING_WINDOW)
    times = stream_updates(window, weather)
    out["pearson"] = {"tier": window.tier, "update_ms": median(times),
                      "oracle": hold_window("pearson", window, pearson, weather),
                      "state_bytes": window.state_memory()["total_bytes"]}
    values = [(torch.arange(16, device="cuda", dtype=torch.float32) + 100 * i,) for i in range(STREAM_RING_UPDATES)]
    window = SlidingWindow(CatMetric(), STREAM_RING_WINDOW)
    stream_updates(window, values)
    out["cat"] = {"tier": window.tier, "oracle": hold_window("cat", window, CatMetric, values),
                  "live_buckets": sum(b is not None for b in window._append_ring),
                  "state_bytes": window.state_memory()["total_bytes"]}
    if out["cat"]["live_buckets"] != STREAM_RING_WINDOW:
        raise AssertionError(f"streaming: the cat ring holds {out['cat']['live_buckets']} buckets")
    return out


def stream_drift() -> dict:
    """DriftMonitor on windowed accuracy over a stream whose label noise steps up after
    update 100 of 200: no breach before the step, a breach after it, in the session's
    ``drift(acc)`` SLO and in an ``alert`` event."""
    from torchmetrics_tpu_torch import observability as obs
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.streaming import DriftMonitor

    updates, step_at, batch = STREAM_DRIFT
    reference, test = STREAM_DRIFT_WINDOWS
    gen = torch.Generator(device="cuda").manual_seed(STREAM_SEED + 2)
    rules = (obs.SloRule(name="acc_drift", expr=f"drift('acc') > {STREAM_DRIFT_THRESHOLD}", window=60.0,
                         cooldown=0.0, severity="critical"),)
    breaches = {"before": 0, "after": 0}
    with obs.telemetry_session(obs.TelemetryConfig(slo_rules=rules, slo_eval_on_sync=False)) as rec:
        monitor = DriftMonitor(MulticlassAccuracy(STREAM_CLASSES, average="micro", validate_args=False),
                               reference_window=reference, test_window=test, threshold=STREAM_DRIFT_THRESHOLD,
                               name="acc", eval_every=test)
        slo_breach = False
        for i in range(updates):
            target = torch.randint(0, STREAM_CLASSES, (batch,), generator=gen, device="cuda")
            clean = torch.rand((batch,), generator=gen, device="cuda") < STREAM_DRIFT_ACCURACY[i >= step_at]
            noisy = torch.randint(0, STREAM_CLASSES, (batch,), generator=gen, device="cuda")
            preds = torch.where(clean, target, noisy)
            before = len(monitor.history)
            monitor.update(preds, target)
            if len(monitor.history) > before and monitor.breached:
                breaches["before" if i < step_at else "after"] += 1
                if any(a["rule"] == "acc_drift" and a["kind"] == "breach" for a in rec.evaluate_slos()):
                    slo_breach = True
        alerts = [e for e in rec.events_of("alert") if e.tag == "drift"]
        snap = rec.counters.snapshot()
    if breaches["before"] or not breaches["after"] or not slo_breach or not alerts:
        raise AssertionError(f"streaming: drift breaches {breaches}, SLO breach {slo_breach}, {len(alerts)} alerts")
    return {"breaches": breaches, "evaluations": snap["drift_evals"], "slo_breach": slo_breach,
            "alerts": len(alerts), "scores": [round(h["score"], 6) for h in monitor.history]}


def stream_collection(extractor, fid_batches, rows, gather=None):
    """``{acc, f1, confmat}`` and FID without compute groups (each member updated alone
    during the overlap), fed the same batches."""
    from torchmetrics_tpu_torch import MetricCollection

    members = stream_members()
    members["fid"] = reliability_fid(extractor)
    coll = MetricCollection(members, compute_groups=False)
    for preds, target in rows[:4]:
        for name in ("acc", "f1", "confmat"):
            coll[name].update(preds, target)
    for i, imgs in enumerate(fid_batches):
        coll["fid"].update(imgs, real=i % 2 == 0)
    return coll


def stream_async(extractor) -> dict:
    """``MetricCollection.sync(async_=True)`` over ``{acc, f1, confmat}`` and FID's states
    in an NCCL group of one, 8 updates during the overlap: commit equal to a blocking
    sync bit for bit, unsync the live states with the overlap's updates, the traced
    ``nccl:all_gather`` count as ``collective_counts`` predicts; a ``FlakyGather`` whose
    first call fails commits nothing without a policy and recovers under one."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from torchmetrics_tpu_torch.parallel.sync import gather_all_arrays
    from torchmetrics_tpu_torch.reliability import FlakyGather, ReliabilityConfig, RetryPolicy
    from torchmetrics_tpu_torch.utilities.exceptions import TransientRuntimeError

    gen = torch.Generator(device="cuda").manual_seed(STREAM_SEED + 3)
    fid_batches = [torch.rand((OBS_BATCH, 3, 299, 299), generator=gen, device="cuda") ** (1 + i % 2) for i in range(2)]
    rows = stream_rows(4 + STREAM_OVERLAP_UPDATES, seed=STREAM_SEED + 4)
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_streaming_nccl_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        blocking = stream_collection(extractor, fid_batches, rows)
        blocking.sync(distributed_available=lambda: True)
        want = {name: dict(m._state) for name, m in blocking.items(keep_base=True)}
        live = stream_collection(extractor, fid_batches, rows)
        for preds, target in rows[4:]:
            for name in ("acc", "f1", "confmat"):
                live[name].update(preds, target)
        coll = stream_collection(extractor, fid_batches, rows)
        states, reductions = distinct_states(coll)
        predicted = expected_collectives(states, reductions)["sync_coalesced"]
        holder = {}

        def overlapped():
            handle = coll.sync(async_=True, distributed_available=lambda: True)
            for preds, target in rows[4:]:
                for name in ("acc", "f1", "confmat"):
                    coll[name].update(preds, target)
            handle.commit()
            holder["handle"] = handle

        traced_sync = collectives_of(traced(overlapped, all_threads=True))
        handle = holder["handle"]
        committed = all(states_equal(m._state, want[name]) for name, m in coll.items(keep_base=True))
        coll.unsync()
        restored = all(states_equal(m._state, live[name]._state) for name, m in coll.items(keep_base=True))
        if not (handle.committed and committed and restored):
            raise AssertionError(f"streaming: async commit equal {committed}, unsync restored {restored}")
        if traced_sync.get("by_name", {}).get("nccl:all_gather", 0) != predicted:
            raise AssertionError(f"streaming: the async sync traced {traced_sync}, {predicted} predicted")
        # a gather whose first call fails: nothing commits without a policy, a retry recovers
        flaky_coll = stream_collection(extractor, fid_batches, rows)
        before = {name: dict(m._state) for name, m in flaky_coll.items(keep_base=True)}
        failing = flaky_coll.sync(async_=True, distributed_available=lambda: True,
                                  dist_sync_fn=FlakyGather(inner=gather_all_arrays, fail_times=1))
        try:
            failing.commit()
        except TransientRuntimeError:
            pass
        else:
            raise AssertionError("streaming: a failed async gather committed")
        kept = all(not m._is_synced and states_equal(m._state, before[name])
                   for name, m in flaky_coll.items(keep_base=True))
        for m in flaky_coll.values():
            m._reliability = ReliabilityConfig(retry=RetryPolicy(max_attempts=3, backoff_base=0.001))
        flaky = FlakyGather(inner=gather_all_arrays, fail_times=1)
        flaky_coll.sync(async_=True, distributed_available=lambda: True, dist_sync_fn=flaky).commit()
        recovered = all(states_equal(m._state, want[name]) for name, m in flaky_coll.items(keep_base=True))
        if not kept or not recovered or flaky.failures != 1:
            raise AssertionError(f"streaming: flaky async sync kept {kept}, recovered {recovered}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    return {"overlap_pct": handle.overlap_pct, "gather_s": handle.gather_s, "wait_s": handle.wait_s,
            "overlap_updates": STREAM_OVERLAP_UPDATES, "collectives_traced": traced_sync,
            "collectives_predicted": predicted, "commit_bitwise": committed, "unsync_restored": restored,
            "flaky": {"failed_commit_kept_states": kept, "retried_bitwise": recovered}}


def start_window_boot() -> dict:
    """``precompile(tags=("wdual",))`` of windowed accuracy writes both codecs, then a
    fresh interpreter (``--aot-child ... window``) starts on the cache; it boots beside
    the phase's later parts and :func:`finish_window_boot` takes its result."""
    import tempfile

    from torchmetrics_tpu_torch.streaming import SlidingWindow

    workdir = tempfile.mkdtemp(prefix="chip_smoke_streaming_aot_")
    cache_dir = os.path.join(workdir, "cache")
    rows = aot_rows()
    eager = SlidingWindow(stream_members()["acc"], STREAM_WINDOW)
    for preds, target in rows:
        eager.update(preds, target)
    clock = time.perf_counter()
    row = SlidingWindow(stream_members()["acc"], STREAM_WINDOW).precompile(*rows[0], tags=("wdual",),
                                                                           cache_dir=cache_dir)["wdual"]
    precompile_s = time.perf_counter() - clock
    if row["status"] != "written" or row["codecs"] != AOT_CODECS:
        raise AssertionError(f"streaming: the wdual precompile row is {row}")
    return {"workdir": workdir, "row": row, "precompile_s": precompile_s, "child": start_aot_child(cache_dir, "window"),
            "want": {k: v.cpu().tolist() for k, v in eager._wstate.items()}}


def finish_window_boot(boot: dict) -> dict:
    """The window boot's result: one ``"aoti"`` load, no compile, and its window states
    after 16 batches equal the eager ones bit for bit."""
    child = finish_aot_child(boot["child"])
    shutil.rmtree(boot["workdir"], ignore_errors=True)
    want = boot["want"]
    if child["counters"]["aot_cache_hits"] != 1 or child["counters"]["jit_compiles"] != 0 \
            or [load["codec"] for load in child["loads"]] != ["aoti"] or child["states"] != want:
        raise AssertionError(f"streaming: the window boot gave {child['counters']}, loads {child['loads']}, "
                             f"states equal {child['states'] == want}")
    return {"precompile_s": boot["precompile_s"], "row": {k: boot["row"].get(k) for k in ("status", "codecs", "bytes")},
            "boot": {k: child[k] for k in ("imports_s", "first_update_ms", "boot_to_first_update_s", "counters")},
            "states_bitwise": True}


def streaming_phase(card: str) -> int:
    """The streaming plane (phase 55). Returns the sepconv7 launches of FID's windowed
    updates, the path's count."""
    from torchmetrics_tpu_torch.image import InceptionV3Features

    started = time.perf_counter()
    clock = [("start", started)]
    main_path = stream_main_path(card)
    clock.append(("main_path", time.perf_counter()))
    boot = start_window_boot()  # the window's fresh interpreter boots beside the parts below
    clock.append(("warm_start_precompile", time.perf_counter()))
    try:
        extractor = InceptionV3Features.from_numpy_params(he_scaled(InceptionV3Features._random_params(0)),
                                                          compute_dtype="bfloat16")
        fid = stream_fid(extractor)
        clock.append(("fid", time.perf_counter()))
        tiers = stream_tiers()
        clock.append(("tiers", time.perf_counter()))
        drift = stream_drift()
        clock.append(("drift", time.perf_counter()))
        async_sync = stream_async(extractor)
        clock.append(("async", time.perf_counter()))
    except BaseException:
        boot["child"][0].kill()
        boot["child"][0].wait()
        raise
    warm = finish_window_boot(boot)
    clock.append(("warm_start_boot", time.perf_counter()))
    seconds = time.perf_counter() - started
    emit({"phase": "streaming", "main_path": main_path, "fid": fid, "tiers": tiers, "drift": drift,
          "async_sync": async_sync, "warm_start": warm, "parts_s": clock_seconds(clock), "seconds": seconds,
          "limit_s": STREAM_PHASE_LIMIT_S, "within_limit": seconds <= STREAM_PHASE_LIMIT_S, "card": card})
    return fid["sepconv7_launches"]


# ---------------------------------------------------------------------------
# the serving plane (slice 22): ServingEngine on the card

SERVE_TENANTS = 8000  # tools/serve_demo.py's spill-churn line: --tenants 8000 --capacity 2048
SERVE_CAPACITY = 2048
SERVE_MEGABATCH = 512
SERVE_ROUNDS = 4
SERVE_ROWS = 32  # events per tenant batch
SERVE_CLASSES = 10
SERVE_SEED = 57
SERVE_CHECK_TENANTS = 256  # seeded tenants held against standalone CPU metrics, bit for bit
SERVE_NAIVE_TENANTS = 512  # the naive loop: one standalone metric per tenant
SERVE_PROBE_MEGABATCHES = (64, 512)  # launch calls per dispatch must be equal at both
SERVE_CONFMAT_TENANTS = 2048  # the confusion matrix on a prefix of the same traffic
SERVE_CONFMAT_ROUNDS = 2
SERVE_WINDOW = 64
SERVE_WINDOW_TENANTS = 4
SERVE_WINDOW_UPDATES = 130  # two dual-tier rotations
SERVE_QUARANTINE_MEGABATCH = 64
SERVE_QUARANTINE_TENANT = 7
SERVE_JOURNAL_TENANTS = 1024
SERVE_JOURNAL_ROUNDS = 3
SERVE_FID_CAPACITY = 4
SERVE_FID_TENANTS = 6  # more tenants than slots: they spill
SERVE_FID_ROUNDS = 3
SERVE_FID_IMAGES = 32  # per tenant batch: 128 images per dispatch
# a tenant's FID rows against a standalone FID fed the same batches on the card: the
# megabatch runs the trunk at batch 128 where the standalone runs 32, and its bf16
# activations round differently (H100 80GB HBM3, 700 W: 1.7e-4-3.5e-4 relative L2 a
# state); bit for bit where the trunk is batch-invariant, else within this relative L2
# per state. A fault that hands a tenant another tenant's rows must read above it: the
# phase holds every tenant against the next tenant's standalone FID too (2.5e-3-5.2e-3 on
# the same card) and fails unless each such reading exceeds the limit, which sits near
# the geometric middle of the two
SERVE_FID_RTOL = 1e-3
SERVE_WARM_TENANTS = 512  # the warm-boot children's traffic: one full megabatch
SERVE_PHASE_LIMIT_S = 75


def serve_traffic(tenants: int = SERVE_TENANTS, rounds: int = SERVE_ROUNDS, rows: int = SERVE_ROWS,
                  classes: int = SERVE_CLASSES, seed: int = SERVE_SEED):
    """The demo's traffic from a seed, on the host as a metric service receives it:
    ``(rounds, tenants, rows, classes)`` float32 logits and ``(rounds, tenants, rows)``
    int32 labels."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((rounds, tenants, rows, classes), dtype=np.float32)
    labels = rng.integers(0, classes, (rounds, tenants, rows), dtype=np.int32)
    return logits, labels


def serve_accuracy(device=None, classes: int = SERVE_CLASSES):
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    return MulticlassAccuracy(classes, average="micro", validate_args=False, device=device)


def serve_confmat(device=None, classes: int = SERVE_CLASSES):
    from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix

    return MulticlassConfusionMatrix(classes, validate_args=False, device=device)


def serve_feed(engine, logits, labels, tenants=None, rounds=None) -> float:
    """Round after round, every tenant's batch through ``engine.update``, then a flush;
    returns the host seconds (the card synchronised at the end)."""
    rounds = range(logits.shape[0]) if rounds is None else rounds
    tenants = range(logits.shape[1]) if tenants is None else tenants
    start = time.perf_counter()
    for r in rounds:
        for t in tenants:
            engine.update(t, logits[r, t], labels[r, t])
    engine.flush()
    engine.block_until_ready()
    return time.perf_counter() - start


def serve_hold(label: str, engine, make_reference, logits, labels, tenants, rounds=None) -> int:
    """Each tenant's rows (resident or spilled) against a standalone metric made by
    ``make_reference`` fed the same batches: every state bit for bit. Returns how many
    of the held tenants were spilled."""
    rounds = range(logits.shape[0]) if rounds is None else rounds
    spilled = 0
    for t in tenants:
        ref = make_reference()
        for r in rounds:
            ref.update(torch.from_numpy(logits[r, t]).to(ref.device), torch.from_numpy(labels[r, t]).to(ref.device))
        state = engine._tenant_state(engine._tenants[t])
        spilled += engine._tenants[t].spilled is not None
        for key, want in ref._state.items():
            if not torch.equal(state[key].cpu().to(want.dtype), want.cpu()):
                raise AssertionError(f"serving: {label} tenant {t}'s {key} differs from a standalone metric's")
    return spilled


def serve_probe_engine(make, megabatch: int, logits, labels):
    """An engine of ``megabatch`` slots with one megabatch of distinct tenants queued
    (admitted, not dispatched): its ``flush()`` is exactly one dispatch."""
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    engine = ServingEngine(make(), ServingConfig(capacity=megabatch, megabatch_size=megabatch, auto_flush=False))
    for t in range(megabatch):
        engine.update(t, logits[0, t], labels[0, t])
    return engine


def serve_launch_calls(label: str, make, logits, labels) -> dict:
    """Launch calls of one dispatch at each probe size (after one warm dispatch of the
    same engine); they must not depend on the size."""
    calls = {}
    for m in SERVE_PROBE_MEGABATCHES:
        engine = serve_probe_engine(make, m, logits, labels)
        engine.flush()
        for t in range(m):
            engine.update(t, logits[1, t], labels[1, t])
        events = profile_step(f"serving_{label}_vupdate_{m}", engine.flush)
        calls[m] = {"kernels": launch_calls(events), "copies": launch_calls(events, "Memcpy")}
    if len({c["kernels"] for c in calls.values()}) != 1:
        raise AssertionError(f"serving: {label}'s launch calls per dispatch depend on the megabatch size: {calls}")
    return calls


def serve_churn(card: str) -> dict:
    """The demo's spill churn at full width: 8,000 tenants, 4 rounds, capacity 2,048,
    megabatches of 512; tenants/s against the naive loop; 256 seeded tenants (spilled
    ones among them) against standalone CPU metrics bit for bit; launch calls per
    dispatch at 64 and 512 rows."""
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    logits, labels = serve_traffic()
    engine = ServingEngine(serve_accuracy(), ServingConfig(capacity=SERVE_CAPACITY, megabatch_size=SERVE_MEGABATCH))
    seconds = serve_feed(engine, logits, labels)
    summary = engine.summary()
    checked = np.random.default_rng(SERVE_SEED).choice(SERVE_TENANTS, SERVE_CHECK_TENANTS, replace=False)
    spilled = serve_hold("accuracy", engine, lambda: serve_accuracy(device="cpu"), logits, labels, checked)
    if not spilled:
        raise AssertionError("serving: no spilled tenant among the held ones")
    naive = {t: serve_accuracy() for t in range(SERVE_NAIVE_TENANTS)}
    torch.cuda.synchronize()
    start = time.perf_counter()
    for r in range(SERVE_ROUNDS):
        for t, metric in naive.items():
            metric.update(torch.from_numpy(logits[r, t]).cuda(), torch.from_numpy(labels[r, t]).cuda())
    torch.cuda.synchronize()
    naive_s = time.perf_counter() - start
    calls = serve_launch_calls("accuracy", serve_accuracy, logits, labels)
    return {"tenants": SERVE_TENANTS, "rounds": SERVE_ROUNDS, "capacity": SERVE_CAPACITY,
            "megabatch": SERVE_MEGABATCH, "seconds": seconds,
            "tenants_per_s": SERVE_TENANTS * SERVE_ROUNDS / seconds,
            "naive_tenants_per_s": SERVE_NAIVE_TENANTS * SERVE_ROUNDS / naive_s,
            **{k: summary[k] for k in ("dispatches", "padded_rows", "spills", "readmissions", "tenant_spill_us",
                                        "tenants_per_dispatch")},
            "held_tenants": SERVE_CHECK_TENANTS, "held_spilled": spilled, "states_bitwise": True,
            "launch_calls_per_dispatch": calls, "resident_bytes": engine.memory()["resident_bytes"]}, logits, labels


def serve_confmat_part(logits, labels) -> dict:
    """MulticlassConfusionMatrix tenants on a prefix of the traffic: the batched count
    (one count for the whole megabatch), states bit for bit against the CPU, launch
    calls per dispatch equal at 64 and 512 rows."""
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    engine = ServingEngine(serve_confmat(), ServingConfig(capacity=SERVE_CAPACITY, megabatch_size=SERVE_MEGABATCH))
    seconds = serve_feed(engine, logits, labels, tenants=range(SERVE_CONFMAT_TENANTS),
                         rounds=range(SERVE_CONFMAT_ROUNDS))
    held = np.random.default_rng(SERVE_SEED + 1).choice(SERVE_CONFMAT_TENANTS, 64, replace=False)
    serve_hold("confmat", engine, lambda: serve_confmat(device="cpu"), logits, labels, held,
               rounds=range(SERVE_CONFMAT_ROUNDS))
    return {"tenants": SERVE_CONFMAT_TENANTS, "rounds": SERVE_CONFMAT_ROUNDS, "seconds": seconds,
            "held_tenants": len(held), "states_bitwise": True,
            "launch_calls_per_dispatch": serve_launch_calls("confmat", serve_confmat, logits, labels)}


def serve_window_part(logits, labels, device=None, updates: int = SERVE_WINDOW_UPDATES,
                      window: int = SERVE_WINDOW) -> dict:
    """Windowed tenants (dual tier): each tenant's window rows against a standalone
    ``SlidingWindow`` fed the same batches, bit for bit; ``compute_all`` through
    ``vcompute`` against per-tenant ``compute``."""
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine
    from torchmetrics_tpu_torch.streaming import SlidingWindow

    engine = ServingEngine(serve_accuracy(device=device), ServingConfig(capacity=2 * SERVE_WINDOW_TENANTS,
                                                                        megabatch_size=SERVE_WINDOW_TENANTS,
                                                                        window=window))
    refs = {t: SlidingWindow(serve_accuracy(device=device), window) for t in range(SERVE_WINDOW_TENANTS)}
    for i in range(updates):
        r, block = i % logits.shape[0], i // logits.shape[0]
        for t in range(SERVE_WINDOW_TENANTS):
            tenant = t + SERVE_WINDOW_TENANTS * block  # a fresh batch per update
            engine.update(t, logits[r, tenant], labels[r, tenant])
            refs[t].update(torch.from_numpy(logits[r, tenant]).to(refs[t].device),
                           torch.from_numpy(labels[r, tenant]).to(refs[t].device))
    engine.flush()
    values = engine.compute_all()
    for t, ref in refs.items():
        state = engine._tenant_state(engine._tenants[t])
        for key, want in ref._wstate.items():
            if not torch.equal(state[key], want):
                raise AssertionError(f"serving: windowed tenant {t}'s {key} differs from a SlidingWindow's")
        if engine.covered_updates(t) != ref.covered_updates():
            raise AssertionError(f"serving: windowed tenant {t} covers {engine.covered_updates(t)} updates")
        if not torch.equal(values[t], engine.compute(t)) or not torch.equal(engine.compute(t), ref.compute()):
            raise AssertionError(f"serving: windowed tenant {t}'s compute_all, compute and the window's differ")
    summary = engine.summary()
    return {"window": window, "tier": summary["window_tier"], "tenants": SERVE_WINDOW_TENANTS, "updates": updates,
            "rotations": summary["window_rotations"], "covered": engine.covered_updates(0),
            "vcompute_used": engine._vcompute_ok, "states_bitwise": True}


def serve_quarantine_part(logits, labels, device=None, megabatch: int = SERVE_QUARANTINE_MEGABATCH) -> dict:
    """``on_error="quarantine"`` with ``_fault_hook`` raising whenever one tenant is in
    the megabatch: only that tenant is quarantined, its peers equal a clean run bit for
    bit."""
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    config = lambda: ServingConfig(capacity=megabatch, megabatch_size=megabatch, on_error="quarantine",
                                   auto_flush=False)  # noqa: E731
    faulty, clean = ServingEngine(serve_accuracy(device=device), config()), ServingEngine(serve_accuracy(device=device),
                                                                                         config())

    def hook(tenant_ids):
        if SERVE_QUARANTINE_TENANT in tenant_ids:
            raise RuntimeError("injected tenant fault")

    faulty._fault_hook = hook
    for engine in (faulty, clean):
        for t in range(megabatch):
            engine.update(t, logits[0, t], labels[0, t])
        engine.flush()
    roster = faulty.tenants()
    quarantined = [t for t, row in roster.items() if row["quarantined"]]
    if quarantined != [SERVE_QUARANTINE_TENANT]:
        raise AssertionError(f"serving: quarantined tenants {quarantined}")
    for t in range(megabatch):
        if t == SERVE_QUARANTINE_TENANT:
            continue
        got, want = faulty._tenant_state(faulty._tenants[t]), clean._tenant_state(clean._tenants[t])
        if not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"serving: quarantine peer {t} differs from the clean run")
    return {"megabatch": megabatch, "quarantined": quarantined, "peers_bitwise": megabatch - 1,
            "dispatches": faulty.stats["dispatches"]}


def serve_durability_part(logits, labels, device=None, tenants: int = SERVE_JOURNAL_TENANTS,
                          rounds: int = SERVE_JOURNAL_ROUNDS) -> dict:
    """A journaled run with a snapshot after its first round; a fresh engine restores
    the snapshot and replays the journal (exactly once by sequence number): every
    tenant equals the uninterrupted engine bit for bit."""
    import tempfile

    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine, TrafficJournal

    workdir = tempfile.mkdtemp(prefix="chip_smoke_serving_durability_")
    try:
        config = lambda: ServingConfig(capacity=SERVE_CAPACITY, megabatch_size=SERVE_MEGABATCH,  # noqa: E731
                                       journal=os.path.join(workdir, "journal"))
        primary = ServingEngine(serve_accuracy(device=device), config())
        retained, snap = {}, None
        start = time.perf_counter()
        for r in range(rounds):
            for t in range(tenants):
                primary.update(t, logits[r, t], labels[r, t])
                retained[primary._applied_seq] = (logits[r, t], labels[r, t])
            if r == 0:
                snap_start = time.perf_counter()
                snap = primary.snapshot(os.path.join(workdir, "snaps"))
                snap["seconds"] = time.perf_counter() - snap_start
        primary.flush()
        primary.close()
        feed_s = time.perf_counter() - start - snap["seconds"]
        standby = ServingEngine(serve_accuracy(device=device), config())
        start = time.perf_counter()
        standby.restore(os.path.join(workdir, "snaps"))
        records = TrafficJournal.read(os.path.join(workdir, "journal"))
        replayed = standby.replay_journal(records, lambda rec: (retained[rec.seq], {}))
        standby.flush()
        recover_s = time.perf_counter() - start
        for t in range(tenants):
            got, want = standby._tenant_state(standby._tenants[t]), primary._tenant_state(primary._tenants[t])
            if not all(torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"serving: restored tenant {t} differs from the uninterrupted engine")
        if standby.replay_journal(records, lambda rec: (retained[rec.seq], {})) != 0:
            raise AssertionError("serving: a second replay applied records")
        standby.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"tenants": tenants, "rounds": rounds, "snapshot_bytes": snap["bytes"], "snapshot_s": snap["seconds"],
            "journal_records": len(records), "replayed": replayed, "restore_replay_s": recover_s,
            "fsync_every": primary.config.journal_fsync_every, "journaled_feed_s": feed_s, "states_bitwise": True}


def serve_fid_engine(extractor, codec: str):
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    return ServingEngine(reliability_fid(extractor), ServingConfig(capacity=SERVE_FID_CAPACITY,
                                                                   megabatch_size=SERVE_FID_CAPACITY,
                                                                   spill_codec=codec))


def serve_fid_images(device=None, tenants: int = SERVE_FID_TENANTS):
    """Every FID tenant batch, ``(rounds, tenants, images, 3, 299, 299)`` uint8 from a
    seed on the card; each update takes its batch as [0, 1] floats (the template's
    ``normalize=True`` quantizes them back to uint8 levels)."""
    gen = torch.Generator(device=device or "cuda").manual_seed(SERVE_SEED + 2)
    return torch.randint(0, 256, (SERVE_FID_ROUNDS, tenants, SERVE_FID_IMAGES, 3, 299, 299),
                         generator=gen, device=device or "cuda", dtype=torch.uint8)


def spill_bound_checker(engine) -> list:
    """Wrap ``engine._spill`` so that every spill's decoded rows are held against the
    exact rows they encode: within ``range/510`` per element (int8; the single-block
    bound covers every block). Returns the list it appends each spill's worst ratio to."""
    from torchmetrics_tpu_torch.parallel import quantize

    ratios = []
    spill = engine._spill

    def checked(t, cls):
        raw = {name: cls.stacked[name][t.slot].double().cpu() for name in engine._row_defaults}
        spill(t, cls)
        decoded = quantize.decode_spill_state(t.spilled["state"])
        for name, exact in raw.items():
            got = torch.from_numpy(np.asarray(decoded[name], np.float64))
            bound = float(exact.max() - exact.min()) / 510.0 if exact.numel() else 0.0
            err = float((got - exact).abs().max()) if exact.numel() else 0.0
            if err > bound * (1 + 1e-6) + 1e-12:
                raise AssertionError(f"serving: an int8 spill of {name} is {err} off, bound {bound}")
            ratios.append(err / bound if bound else 0.0)

    engine._spill = checked
    return ratios


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def fid_tenant_hold(states: list, refs: list, rtol: float = SERVE_FID_RTOL) -> dict:
    """Tenant ``t``'s FID states against ``refs[t]``, a standalone FID fed the same
    batches: integer states equal, float states within ``rtol`` relative L2 (bit for bit
    where they are). Each tenant is also read against the next tenant's reference, as a
    fault that hands a tenant another's rows would read: every such float reading must
    exceed ``rtol``, or the limit could not tell that fault apart."""
    worst, cross, bitwise = {}, {}, True
    for t, (state, ref) in enumerate(zip(states, refs)):
        other = refs[(t + 1) % len(refs)]
        for key, want in ref.items():
            got = state[key]
            if not want.is_floating_point():
                if not torch.equal(got, want):
                    raise AssertionError(f"serving: FID tenant {t}'s {key} differs from a standalone FID")
                continue
            cross[key] = min(cross.get(key, math.inf), rel_l2(got, other[key]))
            if torch.equal(got, want):
                worst.setdefault(key, 0.0)
                continue
            bitwise = False
            worst[key] = max(worst.get(key, 0.0), rel_l2(got, want))
    if any(v > rtol for v in worst.values()) or any(v <= rtol for v in cross.values()):
        raise AssertionError(f"serving: FID tenants read {worst} relative L2 off their standalone FIDs and {cross} "
                             f"off another tenant's, against the limit {rtol}")
    return {"states_bitwise": bitwise, "rel_l2": worst, "cross_tenant_rel_l2": cross}


def trunk_route_ms(extractor, x: torch.Tensor, pairs: int = 20) -> dict:
    """The trunk's forward on ``x`` ([0, 1] floats) with its 26 sepconv7 convs called
    directly, as the trunk calls them outside ``vmap``, and through the ``torch.library``
    op ``sepconv7_rows``, the serving engine's route: the op's dispatch cost. ``pairs``
    pairs after a warm-up of each, the first of a pair alternating; each route's median
    and quartiles (ms) and the pairs the op won."""
    from torchmetrics_tpu_torch.image import _extractors

    direct = _extractors.sepconv7
    routes = ("sepconv7", "sepconv7_rows")

    def forward(route: str) -> float:
        _extractors.sepconv7 = getattr(_extractors, route)
        torch.cuda.synchronize()
        start = time.perf_counter()
        extractor(x, normalize=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    times = {route: [] for route in routes}
    try:
        for route in routes:
            forward(route)
        for i in range(pairs):
            for route in routes if i % 2 == 0 else routes[::-1]:
                times[route].append(forward(route))
    finally:
        _extractors.sepconv7 = direct
    out = {route: {"median": median(t), "quartiles": [float(np.percentile(t, 25)), float(np.percentile(t, 75))]}
           for route, t in times.items()}
    out["op_wins"] = sum(b < a for a, b in zip(*times.values()))
    out["pairs"] = pairs
    return out


def serve_fid_part(card: str, extractor) -> tuple:
    """FID tenants behind the bf16 trunk (He-scaled seeded weights): capacity 4,
    megabatches of 4 tenants x 32 images (128 a dispatch), 6 tenants over 3 rounds, so
    they spill. Exactly 26 sepconv7 launches a dispatch; each tenant of a ``"none"``
    codec run against a standalone FID fed the same batches on the card; every int8 spill
    within ``range/510``; spill bytes with ``"int8"`` against ``"none"``."""
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7

    images = serve_fid_images()
    engines = {codec: serve_fid_engine(extractor, codec) for codec in ("none", "int8")}
    ratios = spill_bound_checker(engines["int8"])
    launches, per_dispatch, dispatch_ms = 0, [], []
    for codec, engine in engines.items():
        for r in range(SERVE_FID_ROUNDS):
            for t in range(SERVE_FID_TENANTS):
                before = engine.stats["dispatches"]
                torch.cuda.synchronize()
                sepconv7.launches = 0
                start = time.perf_counter()
                engine.update(t, images[r, t].float() / 255, r % 2 == 0)
                if engine.stats["dispatches"] > before:
                    torch.cuda.synchronize()
                    per_dispatch.append(sepconv7.launches)
                    dispatch_ms.append((time.perf_counter() - start) * 1e3)
                    if codec == "int8":
                        launches += sepconv7.launches
        torch.cuda.synchronize()
        sepconv7.launches = 0
        engine.flush()
        if engine.stats["dispatches"] and sepconv7.launches:
            per_dispatch.append(sepconv7.launches)
            if codec == "int8":
                launches += sepconv7.launches
    if set(per_dispatch) != {SEPCONV_PER_FORWARD}:
        raise AssertionError(f"serving: FID dispatches launched sepconv7 {per_dispatch} times")
    if not ratios:
        raise AssertionError("serving: no FID tenant spilled")
    exact = engines["none"]
    refs = []
    for t in range(SERVE_FID_TENANTS):
        ref = reliability_fid(extractor)
        for r in range(SERVE_FID_ROUNDS):
            ref.update(images[r, t].float() / 255, real=r % 2 == 0)
        refs.append(ref._state)
    held = fid_tenant_hold([exact._tenant_state(exact._tenants[t]) for t in range(SERVE_FID_TENANTS)], refs)
    memory = {codec: engine.memory()["spilled_host_bytes"] for codec, engine in engines.items()}
    return {"capacity": SERVE_FID_CAPACITY, "tenants": SERVE_FID_TENANTS, "rounds": SERVE_FID_ROUNDS,
            "images_per_dispatch": SERVE_FID_CAPACITY * SERVE_FID_IMAGES,
            "sepconv7_per_dispatch": SEPCONV_PER_FORWARD, "dispatches": engines["int8"].stats["dispatches"],
            "dispatch_ms": median(dispatch_ms) if dispatch_ms else None,
            **held, "rtol": SERVE_FID_RTOL,
            "int8_spills": len(ratios), "int8_worst_of_bound": max(ratios),
            "spilled_host_bytes": memory, "spill_bytes_saved": engines["int8"].stats["spill_bytes_saved"]}, launches


def serve_child(cache_dir: str) -> dict:
    """One boot of ``ServingConfig(aot_cache_dir=..., write_on_miss=True)`` (a fresh
    interpreter): the first megabatch of the demo's traffic under a telemetry session;
    the first dispatch's ms (from its dispatch record, so a cold boot's write-through
    compile, which follows it, is apart), the counters, the plane and the states. The
    modules a load and a write import are imported first and timed apart, as the other
    boots' are."""
    clock = time.perf_counter()
    import torch._inductor.package  # noqa: F401
    import torch.utils.flop_counter  # noqa: F401

    imports_s = time.perf_counter() - clock
    from torchmetrics_tpu_torch import aot
    from torchmetrics_tpu_torch import observability as obs
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    logits, labels = serve_traffic(tenants=SERVE_WARM_TENANTS, rounds=1)
    with obs.telemetry_session() as rec:
        engine = ServingEngine(serve_accuracy(), ServingConfig(capacity=SERVE_CAPACITY, megabatch_size=SERVE_MEGABATCH,
                                                               aot_cache_dir=cache_dir, write_on_miss=True))
        start = time.perf_counter()
        serve_feed(engine, logits, labels)
        feed_s = time.perf_counter() - start
        snap = rec.counters.snapshot()
        dispatches = [e.duration_s * 1e3 for e in rec.events_of("dispatch") if e.tag == "vupdate"]
    states = {str(t): {k: v.cpu().tolist() for k, v in engine._tenant_state(engine._tenants[t]).items()}
              for t in range(0, SERVE_WARM_TENANTS, 37)}
    plane = dict(aot.active_plane().stats)
    aot.disable()
    return {"first_dispatch_ms": dispatches[0] if dispatches else None, "feed_s": feed_s, "plane": plane,
            "imports_s": imports_s,
            "counters": {k: snap[k] for k in ("dispatches", "jit_compiles", "jit_cache_hits", "aot_cache_hits",
                                              "aot_cache_misses")}, "states": states}


def start_serving_boot() -> tuple:
    """The serving phase's first (cold) boot, a fresh interpreter on an empty cache; it
    may start phases ahead of the serving phase (``main`` starts it beside the streaming
    phase), and :func:`serving_phase` takes its result."""
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chip_smoke_serving_aot_")
    return workdir, start_aot_child(os.path.join(workdir, "cache"), "serve")


def serving_phase(card: str, boot=None) -> int:
    """The serving plane (phase 56). Returns the sepconv7 launches of the FID tenants'
    int8 engine, the path's count. ``boot`` is the cold boot :func:`start_serving_boot`
    started; without one the phase starts it."""
    from torchmetrics_tpu_torch.image import InceptionV3Features

    started = time.perf_counter()
    clock = [("start", started)]
    workdir, cold = boot if boot is not None else start_serving_boot()
    cache_dir = os.path.join(workdir, "cache")
    warm = None
    try:
        churn, logits, labels = serve_churn(card)
        clock.append(("churn", time.perf_counter()))
        cold_result = finish_aot_child(cold)
        warm = start_aot_child(cache_dir, "serve")  # the second boot runs beside the parts below
        clock.append(("cold_boot_wait", time.perf_counter()))
        confmat = serve_confmat_part(logits, labels)
        clock.append(("confmat", time.perf_counter()))
        window = serve_window_part(logits, labels)
        clock.append(("window", time.perf_counter()))
        quarantine = serve_quarantine_part(logits, labels)
        clock.append(("quarantine", time.perf_counter()))
        durability = serve_durability_part(logits, labels)
        clock.append(("durability", time.perf_counter()))
        extractor = InceptionV3Features.from_numpy_params(he_scaled(InceptionV3Features._random_params(0)),
                                                          compute_dtype="bfloat16")
        fid, launches = serve_fid_part(card, extractor)
        clock.append(("fid", time.perf_counter()))
        warm_result = finish_aot_child(warm)
        clock.append(("warm_boot_wait", time.perf_counter()))
        fid["trunk_b32_ms"] = trunk_route_ms(extractor, serve_fid_images()[0, 0].float() / 255)
        clock.append(("trunk_routes", time.perf_counter()))
    except BaseException:
        for child in (cold, warm):
            if child is not None:
                child[0].kill()
                child[0].wait()
        raise
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if warm_result["counters"]["aot_cache_hits"] < 1 or warm_result["counters"]["aot_cache_misses"] != 0 \
            or warm_result["states"] != cold_result["states"] or cold_result["plane"]["writes"] < 1:
        raise AssertionError(f"serving: the warm boot gave {warm_result['counters']} (cold wrote "
                             f"{cold_result['plane']}), states equal {warm_result['states'] == cold_result['states']}")
    boots = {name: {k: result[k] for k in ("first_dispatch_ms", "feed_s", "imports_s", "counters", "plane",
                                           "boot_to_first_update_s")}
             for name, result in (("cold", cold_result), ("warm", warm_result))}
    seconds = time.perf_counter() - started
    emit({"phase": "serving", "churn": churn, "confmat": confmat, "window": window, "quarantine": quarantine,
          "durability": durability, "warm_boot": {**boots, "states_bitwise": True}, "fid": fid,
          "parts_s": clock_seconds(clock), "seconds": seconds, "limit_s": SERVE_PHASE_LIMIT_S,
          "within_limit": seconds <= SERVE_PHASE_LIMIT_S, "card": card})
    return launches


# ---------------------------------------------------------------------------
# the quantized sync plane (slice 22): two gloo ranks on the card

QUANT_CODECS = ("bf16", "int8")
QUANT_FEEDBACK_SYNCS = 8
QUANT_SERVE_TENANTS = 256
QUANT_PHASE_LIMIT_S = 50
QUANT_STATE_EPS = 1e-6  # the float32 rounding of a dequantized sum on top of the analytic bound


def quant_collection(inputs: dict, device=None):
    """The phase's states: ``{acc, f1, confmat}`` at 65,536 rows, FID at 2,048 features
    from a fixed projection (no trunk) and a ``MeanMetric``."""
    from torchmetrics_tpu_torch import MeanMetric, MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix, MulticlassF1Score
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    return MetricCollection({
        "acc": MulticlassAccuracy(5, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(5, average="macro", validate_args=False, device=device),
        "confmat": MulticlassConfusionMatrix(5, validate_args=False, device=device),
        "fid": FrechetInceptionDistance(feature=ProjectionFeatures(inputs["weight"]), device=device),
        "mean": MeanMetric(device=device)}, compute_groups=False, device=device)


def update_quant(coll, inputs: dict, rank: int, world: int) -> None:
    rows = rank_slices(TWO_RANK_BATCH, rank, world)
    for name in ("acc", "f1", "confmat"):
        coll[name].update(inputs["preds"][rows], inputs["target"][rows])
    images = rank_slices(TWO_RANK_IMAGES, rank, world)
    coll["fid"].update(inputs["real"][images], real=True)
    coll["fid"].update(inputs["fake"][images], real=False)
    coll["mean"].update(inputs["values"][rank_slices(TWO_RANK_CAT, rank, world)])


def quant_bound(codec: str, value: torch.Tensor) -> float:
    """The per-element error bound of one rank's leaf under ``codec`` (the single-block
    int8 bound covers every block; bf16 rounds to 8 mantissa bits)."""
    x = value.double().reshape(-1)
    if x.numel() == 0:
        return 0.0
    return float(x.max() - x.min()) / 510.0 if codec == "int8" else float(x.abs().max()) * 2.0 ** -8


def quant_sync_once(states, reductions, sync_config=None, gather=None) -> tuple:
    """One coalesced sync of ``states`` under a telemetry session: the synced states,
    the collectives (as recorded, and the ``torch.distributed.all_gather`` calls traced
    around the sync), the bytes put on the wire and the quant event."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch import observability as obs
    from torchmetrics_tpu_torch.parallel import coalesce

    traced = []
    all_gather = dist.all_gather

    def counted(*args, **kwargs):
        traced.append(1)
        return all_gather(*args, **kwargs)

    dist.all_gather = counted
    try:
        with obs.telemetry_session() as rec:
            out = coalesce.coalesced_process_sync([dict(s) for s in states], reductions, sync_config=sync_config,
                                                  dist_sync_fn=gather)
            snap = rec.counters.snapshot()
            quant = [e.payload for e in rec.events_of("quant")]
            events = {kind: [dict(e.payload) for e in rec.events_of(kind)] for kind in ("degraded_sync", "rank_rejoin")}
    finally:
        dist.all_gather = all_gather
    return out, {"collectives": snap["sync_collectives"], "all_gathers": len(traced),
                 "quantized_buckets": snap["quantized_buckets"],
                 "bytes_saved": snap["sync_bytes_saved"], "quant": quant[0] if quant else None, "events": events}


def quant_values(rank: int, world: int) -> dict:
    """One rank of the quantized-sync phase (gloo, world 2): exact against bf16 and int8
    buckets, error feedback over 8 syncs, a degraded sync and its rejoin, the async
    handle and the serving engine's ``sync_async``."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.parallel import AsyncSyncHandle, SyncConfig, coalesce, quantized_payload_model
    from torchmetrics_tpu_torch.parallel.sync import gather_all_arrays
    from torchmetrics_tpu_torch.reliability import DeadRank
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    inputs = two_rank_inputs()
    coll = quant_collection(inputs)
    update_quant(coll, inputs, rank, world)
    states = [dict(m._state) for m in coll.values()]
    reductions = [dict(m._reductions) for m in coll.values()]
    names = list(coll.keys())

    def peers_bound(codec, value) -> float:
        local = torch.tensor([quant_bound(codec, value)], dtype=torch.float64)
        rows = [torch.zeros_like(local) for _ in range(world)]
        dist.all_gather(rows, local)
        return float(sum(r.item() for r in rows))

    exact, exact_stats = quant_sync_once(states, reductions)
    out = {"exact_collectives": exact_stats["collectives"], "exact_all_gathers": exact_stats["all_gathers"],
           "codecs": {}}
    for codec in QUANT_CODECS:
        synced, stats = quant_sync_once(states, reductions, SyncConfig(codec=codec))
        worst = {}
        for i, name in enumerate(names):
            for key, want in exact[i].items():
                got = synced[i][key]
                if not want.is_floating_point():
                    if not torch.equal(got, want):
                        raise AssertionError(f"quantized_sync {codec}: {name}.{key} is not bit for bit")
                    continue
                bound = peers_bound(codec, states[i][key]) + QUANT_STATE_EPS
                err = float((got.double() - want.double()).abs().max())
                if err > bound:
                    raise AssertionError(f"quantized_sync {codec}: {name}.{key} is {err} off, bound {bound}")
                worst[f"{name}.{key}"] = err / bound
        if (stats["collectives"], stats["all_gathers"]) != (exact_stats["collectives"], exact_stats["all_gathers"]):
            raise AssertionError(f"quantized_sync {codec}: {stats['collectives']} collectives recorded and "
                                 f"{stats['all_gathers']} all_gathers traced, exact {exact_stats['collectives']} "
                                 f"and {exact_stats['all_gathers']}")
        out["codecs"][codec] = {"model": quantized_payload_model(states, reductions, SyncConfig(codec=codec),
                                                                 world=world),
                                "measured": stats["quant"], "collectives": stats["collectives"],
                                "all_gathers": stats["all_gathers"],
                                "worst_of_bound": worst}
    # error feedback: 8 syncs of the same states, the summed drift within one step
    cfg = SyncConfig(codec="int8")
    fid = names.index("fid")
    cum = {k: torch.zeros_like(v, dtype=torch.float64) for k, v in exact[fid].items() if v.is_floating_point()}
    for _ in range(QUANT_FEEDBACK_SYNCS):
        synced, _ = quant_sync_once(states, reductions, cfg)
        for k in cum:
            cum[k] += synced[fid][k].double()
    drift = {}
    for k, total in cum.items():
        step = peers_bound("int8", states[fid][k]) + QUANT_STATE_EPS * QUANT_FEEDBACK_SYNCS
        d = float((total - QUANT_FEEDBACK_SYNCS * exact[fid][k].double()).abs().max())
        if d > step:
            raise AssertionError(f"quantized_sync: {QUANT_FEEDBACK_SYNCS} syncs of fid.{k} drift {d}, step {step}")
        drift[k] = d / step
    out["feedback"] = {"syncs": QUANT_FEEDBACK_SYNCS, "drift_of_step": drift, "residual_norm": cfg.residual_norm()}
    # a degraded sync: rank 1's rows tombstoned twice, then it rejoins with a new epoch
    coalesce.clear_dead_ranks()
    dead = DeadRank(inner=gather_all_arrays, world=world, rank=1)
    _, first = quant_sync_once(states, reductions, gather=dead)
    _, second = quant_sync_once(states, reductions, gather=dead)
    ledger = coalesce.dead_ranks()
    epoch = coalesce.bump_liveness_epoch() if rank == 1 else coalesce.liveness_epoch()
    dead.revive()
    rejoined, third = quant_sync_once(states, reductions, gather=dead)
    out["degraded"] = {"ledger": {str(k): v for k, v in ledger.items()}, "after_rejoin": coalesce.dead_ranks(),
                       "degraded_events": len(first["events"]["degraded_sync"]) + len(second["events"]["degraded_sync"]),
                       "rejoin_events": third["events"]["rank_rejoin"], "epoch": epoch,
                       "rejoined_bitwise": all(torch.equal(rejoined[i][k], exact[i][k])
                                               for i in range(len(states)) for k in exact[i])}
    # async: the handle's quantized commit equals the blocking quantized sync
    blocking, _ = quant_sync_once(states, reductions, SyncConfig(codec="int8"))
    handle = AsyncSyncHandle([dict(s) for s in states], reductions, sync_config=SyncConfig(codec="int8"))
    committed = handle.commit()
    out["async_bitwise"] = all(torch.equal(committed[i][k], blocking[i][k]) for i in range(len(states))
                               for k in blocking[i])
    engine = ServingEngine(serve_accuracy(), ServingConfig(capacity=QUANT_SERVE_TENANTS, megabatch_size=64))
    logits, labels = serve_traffic(tenants=QUANT_SERVE_TENANTS, rounds=world, seed=SERVE_SEED + 3)
    serve_feed(engine, logits, labels, rounds=[rank])
    frozen = [dict(cls.stacked) for cls in engine._classes.values()]
    reds = [{**{k: "sum" for k in ("tp", "fp", "tn", "fn")}, "__tenant_n": "sum"}]
    engine_blocking, _ = quant_sync_once([{k: v.clone() for k, v in s.items()} for s in frozen], reds,
                                         SyncConfig(codec="int8"))
    (stack,) = engine.sync_async(sync_config=SyncConfig(codec="int8")).commit().values()
    out["engine_async_bitwise"] = all(torch.equal(stack[k], engine_blocking[0][k]) for k in stack)
    out["engine_tenant_rows"] = float(stack["__tenant_n"][:QUANT_SERVE_TENANTS].sum())
    return out


def quant_nccl_of_one() -> dict:
    """In an NCCL group of one: a ``SyncConfig`` sync of the same states ships exact (no
    quantized bucket) and gives the local values bit for bit."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from torchmetrics_tpu_torch.parallel import SyncConfig

    inputs = two_rank_inputs()
    coll = quant_collection(inputs)
    update_quant(coll, inputs, 0, 1)
    local = {name: {k: v.clone() for k, v in m._state.items()} for name, m in coll.items(keep_base=True)}
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_quant_nccl_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from torchmetrics_tpu_torch import observability as obs

        with obs.telemetry_session() as rec:
            coll.sync(distributed_available=lambda: True, sync_config=SyncConfig(codec="int8"))
            snap = rec.counters.snapshot()
        bitwise = all(torch.equal(m._state[k], local[name][k]) for name, m in coll.items(keep_base=True)
                      for k in local[name])
        coll.unsync()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    if not bitwise or snap["quantized_buckets"] or snap["sync_bytes_saved"]:
        raise AssertionError(f"quantized_sync: the NCCL group of one gave bitwise {bitwise}, "
                             f"{snap['quantized_buckets']} quantized buckets")
    return {"bitwise": True, "quantized_buckets": 0, "collectives": snap["sync_collectives"]}


def quantized_sync_phase(card: str, world: int = 2) -> None:
    """The quantized sync plane (phase 57): two gloo ranks on the card, and an NCCL group
    of one beside them."""
    started = time.perf_counter()
    children = start_children("quantized", world)
    try:
        nccl = quant_nccl_of_one()
    except BaseException:
        for proc in children[0]:
            proc.kill()
            proc.wait()
        raise
    results = finish_children(children)
    for result in results:
        degraded = result["degraded"]
        rejoin = degraded["rejoin_events"]
        if degraded["ledger"] != {"1": 2} or degraded["after_rejoin"] or degraded["degraded_events"] != 2 \
                or len(rejoin) != 1 or rejoin[0].get("rank") != 1 or rejoin[0].get("epoch") != 2 \
                or not degraded["rejoined_bitwise"]:
            raise AssertionError(f"quantized_sync rank {result['rank']}: degraded sync {degraded}")
        if not (result["async_bitwise"] and result["engine_async_bitwise"]):
            raise AssertionError(f"quantized_sync rank {result['rank']}: async commits differ from blocking syncs")
        for codec, row in result["codecs"].items():
            if row["model"]["shipped_bytes"] >= row["model"]["exact_bytes"] or row["measured"] is None:
                raise AssertionError(f"quantized_sync {codec}: shipped {row['model']} measured {row['measured']}")
    seconds = time.perf_counter() - started
    emit({"phase": "quantized_sync", "world": world, "backend": "gloo", "tensors": "cuda",
          "ranks": results, "nccl_of_one": nccl, "seconds": seconds, "limit_s": QUANT_PHASE_LIMIT_S,
          "within_limit": seconds <= QUANT_PHASE_LIMIT_S, "card": card})


# ---------------------------------------------------------------------------
# the chaos and fleet planes (slice 23): run_soak, run_fleet_soak and FleetController on
# the card

CHAOS_CHILD_FLAG = "--chaos-child"
SOAK_CHILD_FLAG = "--soak-child"
SOAK_CHILD_WALL_S = 900
SOAK_CHILD_BESIDE = ("aot", "streaming", "serving", "quantized_sync")  # the phases the children run beside
CHAOS_PUBLISHED = ("production_soak", "durable_failover", "fleet_failover")  # bench.py's soak configs
# the serving phase's geometry (8,000 tenants, batches of 32 events over 10 classes, 2,048
# slots, megabatches of 512) under the chaos plane's traffic: 64 events a step, Zipf
# popularity, bursts, a quarter of the slots' worth of tenants churned every 30 steps
CHAOS_SCALE_TRAFFIC = {"seed": 23, "tenants": SERVE_TENANTS, "steps": 120, "base_rate": 64.0,
                       "shape_classes": (SERVE_ROWS,), "num_classes": SERVE_CLASSES, "churn_every": 30,
                       "churn_count": 256}
CHAOS_SCALE_SOAK = {"capacity": SERVE_CAPACITY, "megabatch_size": SERVE_MEGABATCH, "spill_codec": "int8",
                    "sync_codec": "bf16", "max_tenants_per_sec": 320.0}
CHAOS_PHASE_LIMIT_S = 90
CHAOS_PROFILE_STEPS = 4  # the profiled soak's steps (259 events); its dispatches pad to 512 rows all the same
FLEET_HOSTS = 3
FLEET_FID_TENANTS = 9
FLEET_FID_MIGRATED = 2
FLEET_FID_KILLED = "host-1"  # the migration's destination, killed a round later
FLEET_LEASE = {"suspect_after": 2.0, "dead_after": 5.0}  # virtual seconds; the FID fleet ticks 1 s a round
FLEET_PHASE_LIMIT_S = 120
SOAK_BLOCKS = ("counters", "history", "faults", "reconciliation", "state_digest")


def soak_config(name: str, root=None):
    """``bench.py``'s published soak configs as the port's ``SoakConfig``:
    ``production_soak`` (:1318-1347), ``durable_failover`` (:1372-1410) and
    ``fleet_failover`` (:1439-1484); ``"scale"`` is the serving phase's geometry under
    the chaos traffic, and ``"fleet_scale"`` the fleet's schedule on it. ``root`` is the
    durability directory of those that need one."""
    from torchmetrics_tpu_torch.chaos import FaultSchedule, FaultSpec, SoakConfig, TrafficConfig

    fleet_faults = FaultSchedule([FaultSpec(step=40, kind="host_loss", target="host-1"),
                                  FaultSpec(step=80, kind="host_join")])
    if name == "production_soak":
        return SoakConfig(traffic=TrafficConfig(seed=23, tenants=24, steps=120), capacity=8, megabatch_size=4,
                          spill_codec="int8", sync_codec="bf16", max_tenants_per_sec=40.0)
    if name == "durable_failover":
        return SoakConfig(traffic=TrafficConfig(seed=31, tenants=24, steps=120), capacity=8, megabatch_size=4,
                          spill_codec="none", max_tenants_per_sec=40.0, durability_dir=root, snapshot_every=30,
                          failover_at=70, journal_fsync_every=1)
    if name == "fleet_failover":
        return SoakConfig(traffic=TrafficConfig(seed=37, tenants=24, steps=120), faults=fleet_faults, capacity=12,
                          megabatch_size=4, spill_codec="none", durability_dir=root, snapshot_every=20,
                          journal_fsync_every=1, fleet_hosts=FLEET_HOSTS)
    if name == "scale":
        return SoakConfig(traffic=TrafficConfig(**CHAOS_SCALE_TRAFFIC), **CHAOS_SCALE_SOAK)
    if name == "fleet_scale":
        return SoakConfig(traffic=TrafficConfig(**CHAOS_SCALE_TRAFFIC), faults=fleet_faults,
                          capacity=SERVE_CAPACITY, megabatch_size=SERVE_MEGABATCH, spill_codec="none",
                          durability_dir=root, snapshot_every=20, journal_fsync_every=1, fleet_hosts=FLEET_HOSTS)
    raise ValueError(f"no soak config {name!r}")


def run_soak_quietly(config, device=None):
    """``run_soak`` with its SLO-breach and retry warnings silenced (they are the point)."""
    import warnings

    from torchmetrics_tpu_torch.chaos import run_soak

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return run_soak(config, device=device)


def soak_blocks(report) -> dict:
    """The blocks a soak must repeat and the CPU's run must equal (counters, history,
    fault ledger, reconciliation, final state digest), through JSON as the child's
    travel."""
    return json.loads(json.dumps({**{block: getattr(report, block) for block in SOAK_BLOCKS[:-1]},
                                  "state_digest": report.config["state_digest"]}, sort_keys=True))


def hold_soak_blocks(label: str, got: dict, want: dict) -> None:
    """Every block equal; a difference names its block and first keys."""
    for block in SOAK_BLOCKS:
        a, b = got[block], want[block]
        if a == b:
            continue
        if isinstance(a, dict) and isinstance(b, dict):
            keys = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
            raise AssertionError(f"{label}: {block} differs at {keys[:8]}: "
                                 f"{[(k, a.get(k), b.get(k)) for k in keys[:3]]}"[:2000])
        raise AssertionError(f"{label}: {block} differs: {str(a)[:400]} against {str(b)[:400]}")


def check_soak(label: str, report) -> None:
    if report.counters["unrecovered_faults"] != 0 or not report.reconciliation["exact"]:
        raise AssertionError(f"chaos: {label} left {report.counters['unrecovered_faults']} faults unrecovered, "
                             f"reconciliation {report.reconciliation}")


def check_fleet(label: str, report) -> None:
    c = report.counters
    if (c["fleet_failover_parity"], c["migration_parity"], c["failover_rpo_records"], c["double_counted_batches"],
            c["unrecovered_faults"]) != (1.0, 1.0, 0, 0, 0) or not report.reconciliation["exact"]:
        raise AssertionError(f"fleet: {label} gave {c}, reconciliation {report.reconciliation}")


def chaos_child() -> int:
    """``--chaos-child``: the three published soaks on the CPU, the card's reference;
    prints a RESULT line of their blocks."""
    import tempfile

    torch.set_num_threads(2)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_chaos_cpu_")
    try:
        out = {name: soak_blocks(run_soak_quietly(soak_config(name, os.path.join(workdir, name)), device="cpu"))
               for name in CHAOS_PUBLISHED}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("RESULT" + json.dumps(out), flush=True)
    return 0


def soak_child() -> int:
    """``--soak-child``: the chaos and fleet phases' work on the card, in a fresh
    interpreter that runs beside earlier phases; prints a RESULT line of both phases'
    lines, their published soaks' blocks and the FID fleet's sepconv7 launches."""
    card = card_line()
    chaos, chaos_blocks = chaos_card(card)
    fleet, fleet_blocks, launches = fleet_card(card)
    print("RESULT" + json.dumps({"chaos": chaos, "fleet": fleet, "blocks": {**chaos_blocks, **fleet_blocks},
                                 "launches": launches}), flush=True)
    return 0


def start_child(flag: str):
    """Start this script with ``flag`` (``--chaos-child``, ``--soak-child``); it is killed
    at exit if nothing has collected it."""
    import atexit

    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(proc.kill)
    return proc, flag, time.perf_counter()


def finish_child(started) -> tuple:
    """The child's RESULT, its seconds and its other JSON lines (a profile line is
    printed where the child ran it); a child that fails or outlives
    ``SOAK_CHILD_WALL_S`` fails the phase."""
    proc, flag, start = started
    try:
        text, _ = proc.communicate(timeout=SOAK_CHILD_WALL_S)
    finally:
        proc.kill()
        proc.wait()
    lines = [line for line in text.splitlines() if line.startswith("RESULT")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the {flag} child failed (exit {proc.returncode}): {text[-3000:]}")
    emitted = [line for line in text.splitlines() if line.startswith('{"phase"')]
    return json.loads(lines[-1][len("RESULT"):]), time.perf_counter() - start, emitted


def start_soak_children() -> tuple:
    """The chaos and fleet phases' two children: their card work and the CPU's published
    soaks. ``main`` starts them before the aot phase, so they run beside the phases up
    to :func:`chaos_fleet_phases`, which takes their results."""
    return start_child(SOAK_CHILD_FLAG), start_child(CHAOS_CHILD_FLAG)


def chaos_published(workdir: str, device=None) -> dict:
    """``production_soak`` twice and ``durable_failover`` beside its uninterrupted
    reference, on ``device``: the blocks equal run to run, no unrecovered fault, exact
    reconciliation, every kind of the default schedule injected and resolved in the
    ledger (recovered, or the tenant fault quarantined); the failover's state parity and
    degraded-sync parity 1.0, RPO 0 records, and its final digest the reference's."""
    import dataclasses

    from torchmetrics_tpu_torch.chaos import default_fault_schedule

    runs, seconds = [], []
    for _ in range(2):
        start = time.perf_counter()
        runs.append(run_soak_quietly(soak_config("production_soak"), device=device))
        seconds.append(time.perf_counter() - start)
    first = runs[0]
    hold_soak_blocks("chaos: production_soak run to run", soak_blocks(runs[1]), soak_blocks(first))
    check_soak("production_soak", first)
    ledger = {r["kind"]: r["outcome"] for r in first.faults}
    kinds = {s.kind for s in default_fault_schedule(first.config["steps"])}
    if set(ledger) != kinds or any(o not in ("recovered", "quarantined") for o in ledger.values()) \
            or ledger["tenant_fault"] != "quarantined":
        raise AssertionError(f"chaos: production_soak's ledger is {ledger}")
    config = soak_config("durable_failover", os.path.join(workdir, "durable"))
    start = time.perf_counter()
    durable = run_soak_quietly(config, device=device)
    seconds.append(time.perf_counter() - start)
    reference = run_soak_quietly(dataclasses.replace(config, durability_dir=None, snapshot_every=None,
                                                     failover_at=None), device=device)
    check_soak("durable_failover", durable)
    c = durable.counters
    if (c["failovers"], c["failover_state_parity"], c["failover_rpo_records"], c["degraded_sync_parity"]) \
            != (1, 1.0, 0, 1.0) or durable.config["state_digest"] != reference.config["state_digest"]:
        raise AssertionError(f"chaos: durable_failover gave {c}, digest equal to the uninterrupted run: "
                             f"{durable.config['state_digest'] == reference.config['state_digest']}")
    keys = ("events", "admitted", "shed", "shed_rate", "faults_injected", "recovered_faults",
            "quarantined_faults", "unrecovered_faults", "engine_spills", "engine_readmissions")
    return {"production_soak": first, "durable_failover": durable, "summary": {
        "production_soak": {**{k: first.counters[k] for k in keys}, "ledger": ledger,
                            "tenants_per_s": first.timing["tenants_per_sec"],
                            "update_p50_us": first.timing["update_p50_us"],
                            "update_p99_us": first.timing["update_p99_us"], "seconds": seconds[:2],
                            "run_to_run_equal": True},
        "durable_failover": {**{k: c[k] for k in ("replayed_records", "journal_records", "journal_fsyncs",
                                                  "snapshots", "failover_rpo_records", "failover_state_parity",
                                                  "degraded_sync_parity")},
                             "failover_rto_ms": durable.timing["failover_rto_ms"], "seconds": seconds[2],
                             "digest_equals_uninterrupted": True}}}


def chaos_scale(device=None, traffic=None, soak=None) -> dict:
    """The chaos soak at the serving phase's geometry (``CHAOS_SCALE_TRAFFIC``,
    ``CHAOS_SCALE_SOAK``, the default fault schedule): no unrecovered fault, exact
    reconciliation; its throughput, latencies, shedding and spills."""
    from torchmetrics_tpu_torch.chaos import SoakConfig, TrafficConfig

    config = SoakConfig(traffic=TrafficConfig(**(traffic or CHAOS_SCALE_TRAFFIC)), **(soak or CHAOS_SCALE_SOAK))
    start = time.perf_counter()
    report = run_soak_quietly(config, device=device)
    seconds = time.perf_counter() - start
    check_soak("the scale soak", report)
    c, t = report.counters, report.timing
    return {**{k: c[k] for k in ("events", "admitted", "shed", "shed_rate", "tenants", "epochs", "faults_injected",
                                 "recovered_faults", "quarantined_faults", "unrecovered_faults")},
            **{k: c[f"engine_{k}"] for k in ("dispatches", "tenant_rows", "padded_rows", "spills", "readmissions")},
            "ledger": {r["kind"]: r["outcome"] for r in report.faults},
            "tenants_per_s": t["tenants_per_sec"], "update_p50_us": t["update_p50_us"],
            "update_p99_us": t["update_p99_us"], "elapsed_s": t["elapsed_s"], "seconds": seconds}


def chaos_epoch_profile() -> dict:
    """One megabatch dispatch and one sync epoch of the soak under the profiler
    (``profile_step`` lines ``chaos_megabatch_dispatch`` and ``chaos_sync_epoch``): a
    short ``run_soak`` on the scale soak's geometry, ``CHAOS_PROFILE_STEPS`` steps with no
    fault armed, of which the last ``ServingEngine.dispatch`` range and the last
    ``soak.sync_epoch`` range (the closing epoch) are read."""
    import dataclasses

    from torchmetrics_tpu_torch.chaos import FaultSchedule
    from torchmetrics_tpu_torch.chaos.soak import SYNC_EPOCH_RANGE
    from torchmetrics_tpu_torch.serving.engine import DISPATCH_RANGE

    scale = soak_config("scale")
    config = dataclasses.replace(scale, traffic=dataclasses.replace(scale.traffic, steps=CHAOS_PROFILE_STEPS),
                                 faults=FaultSchedule([]))
    out = {}
    for label, within in (("chaos_megabatch_dispatch", DISPATCH_RANGE), ("chaos_sync_epoch", SYNC_EPOCH_RANGE)):
        events = profile_step(label, lambda: run_soak_quietly(config), within=within)
        out[label] = {"launch_calls": launch_calls(events), "copies": launch_calls(events, "Memcpy")}
    return out


def chaos_card(card: str) -> tuple:
    """The chaos phase's work on the card: the published soaks, the soak at the serving
    geometry and its two profiles. Returns the phase's line and the published soaks'
    blocks."""
    import tempfile

    started = time.perf_counter()
    clock = [("start", started)]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    try:
        published = chaos_published(workdir)
        clock.append(("published", time.perf_counter()))
        scale = chaos_scale()
        clock.append(("scale", time.perf_counter()))
        profiled = chaos_epoch_profile()
        clock.append(("profiles", time.perf_counter()))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - started
    line = {"phase": "chaos", **published["summary"], "scale": scale, "scale_profiles": profiled,
            "parts_s": clock_seconds(clock), "seconds": seconds, "limit_s": CHAOS_PHASE_LIMIT_S,
            "within_limit": seconds <= CHAOS_PHASE_LIMIT_S, "card": card}
    return line, {name: soak_blocks(published[name]) for name in ("production_soak", "durable_failover")}


def fleet_soak(config, label: str, device=None) -> tuple:
    """One fleet soak, its parity gates held; its failovers' RTO and its migrations'
    time from the report's ``timing``."""
    start = time.perf_counter()
    report = run_soak_quietly(config, device=device)
    seconds = time.perf_counter() - start
    check_fleet(label, report)
    c = report.counters
    return report, {**{k: c[k] for k in ("events", "admitted", "tenants", "hosts_joined", "host_failovers",
                                          "adopted_tenants", "tenant_migrations", "parked_batches",
                                          "replayed_records", "snapshots", "journal_fsyncs", "fleet_failover_parity",
                                          "migration_parity", "failover_rpo_records", "double_counted_batches")},
                    "rto_ms": report.timing["failover_rto_ms"], "migration_us": report.timing["migration_us"],
                    "seconds": seconds}


def hold_migrated(before: dict, after: dict, out: dict) -> None:
    """Each migrated tenant's digest after its move equal to the one before it."""
    changed = [t for t in before if after[t] != before[t]]
    if changed or out["parity_failures"] or out["moved"] != len(before):
        raise AssertionError(f"fleet: migrated tenants {changed} changed their digests ({out})")


def fleet_fid_part(make_fid, images: torch.Tensor, workdir: str) -> tuple:
    """FID tenants behind a ``FleetController`` of ``FLEET_HOSTS`` hosts (capacity and
    megabatch ``SERVE_FID_CAPACITY``, the journal fsyncing every record) on a virtual
    clock. ``images`` is ``(rounds, tenants, n, 3, H, W)`` uint8; each round serves every
    tenant's batch ([0, 1] floats, real on even rounds) and ticks the clock a second.
    After the first round ``FLEET_FID_MIGRATED`` tenants migrate onto
    ``FLEET_FID_KILLED``; after the second that host dies and the clock runs past its
    lease, so the survivors adopt its tenants from its snapshot and journal tail. Each
    migrated tenant's digest is equal before and after its move; every tenant is held by
    :func:`fid_tenant_hold` against an uninterrupted engine fed the same batches.
    Returns the part's line and the sepconv7 launches of the fleet's run."""
    from torchmetrics_tpu_torch.fleet import FleetController, LeaseConfig, tenant_state_digest
    from torchmetrics_tpu_torch.kernels.sepconv import sepconv7
    from torchmetrics_tpu_torch.serving import ServingConfig, ServingEngine

    rounds, tenants = images.shape[:2]
    config = ServingConfig(capacity=SERVE_FID_CAPACITY, megabatch_size=SERVE_FID_CAPACITY, journal_fsync_every=1)
    clock = {"t": 0.0}
    fleet = FleetController(make_fid, os.path.join(workdir, "fid_fleet"), hosts=FLEET_HOSTS, serving=config,
                            lease=LeaseConfig(**FLEET_LEASE), clock=lambda: clock["t"])
    cuda = images.is_cuda
    line = {"hosts": FLEET_HOSTS, "tenants": tenants, "rounds": rounds, "images_per_batch": images.shape[2]}
    try:
        if cuda:
            torch.cuda.synchronize()
        sepconv7.launches = 0
        start = time.perf_counter()
        for r in range(rounds):
            for t in range(tenants):
                fleet.serve(t, images[r, t].float() / 255, r % 2 == 0)
            clock["t"] += 1.0
            fleet.heartbeat_all()
            if r == 0:
                owners = fleet.tenants()
                movers = sorted(t for t, h in owners.items() if h != FLEET_FID_KILLED)[:FLEET_FID_MIGRATED]
                before = {t: tenant_state_digest(fleet.engines()[owners[t]], t) for t in movers}
                moved_at = time.perf_counter()
                out = fleet.migrate(movers, FLEET_FID_KILLED)
                line["migrate_s"] = time.perf_counter() - moved_at
                hold_migrated(before, {t: tenant_state_digest(fleet.engines()[FLEET_FID_KILLED], t)
                                       for t in movers}, out)
                line.update(migrated=movers, migrated_from=sorted({owners[t] for t in movers}))
            if r == 1:
                line["killed_tenants"] = sorted(t for t, h in fleet.tenants().items() if h == FLEET_FID_KILLED)
                fleet.kill_host(FLEET_FID_KILLED)
                failed, ticks = [], 0
                while not failed:
                    clock["t"] += 1.0
                    fleet.heartbeat_all()
                    killed_at = time.perf_counter()
                    failed = fleet.poll()
                    ticks += 1
                line.update(failover_s=time.perf_counter() - killed_at, lease_ticks=ticks)
        fleet.flush()
        if cuda:
            torch.cuda.synchronize()
        launches = sepconv7.launches
        line["seconds"] = time.perf_counter() - start
        owners, engines = fleet.tenants(), fleet.engines()
        states = [{k: v for k, v in engines[owners[t]].state_dict(t).items() if not k.startswith("_")}
                  for t in range(tenants)]
        line.update(stats={k: fleet.stats[k] for k in ("migrated_tenants", "failovers", "adopted_tenants",
                                                          "failover_replayed", "rpo_records", "served")},
                    owners={str(t): owners[t] for t in range(tenants)})
    finally:
        fleet.close()
    if line["stats"]["rpo_records"] != 0 or line["stats"]["failovers"] != 1 or not line["killed_tenants"]:
        raise AssertionError(f"fleet: the FID fleet's failover gave {line['stats']}")
    reference = ServingEngine(make_fid(), ServingConfig(capacity=SERVE_FID_CAPACITY,
                                                        megabatch_size=SERVE_FID_CAPACITY))
    for r in range(rounds):
        for t in range(tenants):
            reference.update(t, images[r, t].float() / 255, r % 2 == 0)
    refs = [{k: v for k, v in reference.state_dict(t).items() if not k.startswith("_")} for t in range(tenants)]
    line.update(fid_tenant_hold(states, refs), rtol=SERVE_FID_RTOL, sepconv7_launches=launches)
    return line, launches


def fleet_card(card: str) -> tuple:
    """The fleet phase's work on the card: the published fleet soak twice, the fleet
    soak at the serving geometry and the FID fleet. Returns the phase's line, the
    published soak's blocks and the FID fleet's sepconv7 launches."""
    import tempfile

    from torchmetrics_tpu_torch.image import InceptionV3Features

    started = time.perf_counter()
    clock = [("start", started)]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        runs = [fleet_soak(soak_config("fleet_failover", os.path.join(workdir, f"published_{i}")), "fleet_failover")
                for i in range(2)]
        hold_soak_blocks("fleet: fleet_failover run to run", soak_blocks(runs[1][0]), soak_blocks(runs[0][0]))
        clock.append(("published", time.perf_counter()))
        _, scale = fleet_soak(soak_config("fleet_scale", os.path.join(workdir, "scale")), "the scale fleet")
        clock.append(("scale", time.perf_counter()))
        extractor = InceptionV3Features.from_numpy_params(he_scaled(InceptionV3Features._random_params(0)),
                                                          compute_dtype="bfloat16")
        fid, launches = fleet_fid_part(lambda: reliability_fid(extractor), serve_fid_images(tenants=FLEET_FID_TENANTS),
                                       workdir)
        clock.append(("fid", time.perf_counter()))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if launches == 0 or launches % SEPCONV_PER_FORWARD:
        raise AssertionError(f"fleet: the FID fleet launched sepconv7 {launches} times")
    seconds = time.perf_counter() - started
    line = {"phase": "fleet", "fleet_failover": {**runs[0][1], "seconds": [run[1]["seconds"] for run in runs],
                                                 "run_to_run_equal": True},
            "scale": scale, "fid": fid, "parts_s": clock_seconds(clock), "seconds": seconds,
            "limit_s": FLEET_PHASE_LIMIT_S, "within_limit": seconds <= FLEET_PHASE_LIMIT_S, "card": card}
    return line, {"fleet_failover": soak_blocks(runs[0][0])}, launches


def chaos_fleet_phases(card: str, children=None) -> int:
    """The chaos and fleet planes (phases 58 and 59): their card work from the
    ``--soak-child`` (:func:`chaos_card`, :func:`fleet_card`), every published soak's
    blocks held against the CPU's from the ``--chaos-child``. ``children`` are
    :func:`start_soak_children`'s (the phases start them without). Returns the FID
    fleet's sepconv7 launches, the path's count."""
    children = children if children is not None else start_soak_children()
    started = time.perf_counter()
    try:
        result, card_s, emitted = finish_child(children[0])
        cpu, cpu_s, _ = finish_child(children[1])
    finally:
        for proc, _, _ in children:
            proc.kill()
            proc.wait()
    for line in emitted:
        print(line, flush=True)
    for name in CHAOS_PUBLISHED:
        hold_soak_blocks(f"{name} on the card against the CPU", result["blocks"][name], cpu[name])
    children_s = {"card_child_s": card_s, "cpu_child_s": cpu_s, "waited_s": time.perf_counter() - started,
                  "beside": list(SOAK_CHILD_BESIDE)}
    emit({**result["chaos"], "blocks_equal_cpu": True, **children_s})
    result["fleet"]["fleet_failover"]["blocks_equal_cpu"] = True
    emit({**result["fleet"], **children_s})
    return result["launches"]

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
# of val2017's 5,000: the JAX algorithm takes ~0.3 s an image, read twice (64 before the
# streaming phase, 32 in updates of 16 before the whole script took 1,122 s with the
# serving phases, over its 1,080 s aim); two updates, so the second folds into the states
PANOPTIC_IMAGES = 16
PANOPTIC_BATCH = 8
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
    # torch's one-off notice that the debug mode is a prototype names "synchronizing"
    # operations too; it is no read
    return sum(1 for w in caught if "synchroniz" in str(w.message) and "prototype" not in str(w.message))


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


# ---------------------------------------------------------------------------
# image quality, 3-D SSIM and pan-sharpening (slice 14)
# ---------------------------------------------------------------------------

DIV2K_IMAGES = 100  # DIV2K's validation set: 100 high-resolution images
DIV2K_SHAPE = (1356, 2040)  # one size for all: DIV2K's images are 2040 wide, 1356 its common height
DIV2K_BATCH = 4
DIV2K_CPU_IMAGES = 2  # the CPU port reads the first update's first 2 images
IMAGE_UNITS = 32  # card against CPU: float32 rounding units (2**-24) of a value's magnitude, at least 1
UNIT = 2.0**-24
SSIM_PEAK_LIMIT = 6 * 10**9  # an SSIM or MS-SSIM update's bytes beyond what the card held
NO_HOST_READ = ("psnr", "ssim", "ms_ssim", "uqi", "tv")
TF32_PROOF = ("ssim", "ms_ssim", "uqi", "vif")
BRATS_MRI_VOLUMES = 16
BRATS_MRI_BATCH = 2
BRATS_MRI_CROP = (96, 96, 64)  # the CPU port's central crop of the first volume
BRATS_MRI_INTENSITY = (400.0, 200.0, 650.0, 900.0)  # T1ce-like: background, necrotic, oedema, enhancing
BRATS_MS_BETAS = (0.0448, 0.2856, 0.3001, 0.2363)  # five scales need 155 // 16 > 10: the default's first four
SEPARABLE_MIN_SPEEDUP = 3.0
PAN_REDUCED = (20, 8, 256)  # WorldView-3 reduced-resolution test set: samples, bands, fused size (ms a quarter)
PAN_FULL = (20, 8, 512)  # full resolution: fused 512, ms 128, pan 512
PAN_RATIO = 4
PAN_BATCH = 4
PAN_CPU_SAMPLES = 4
D_LAMBDA_PEAK_LIMIT = 6 * 10**9  # D_lambda's compute beyond its states: its band pairs go in chunks
# card against CPU, in float32 rounding units of the magnitude (at least 1): 121-tap UQI maps
# averaged (a UQI mean within 121 units; D_lambda and D_s difference two, QNR four); SAM's
# arccos multiplies the cosine's few units by 1 / sin(angle), about 30 at these angles
PAN_UNITS = {"sam": 256, "ergas": 32, "scc": 32, "uqi": 121, "d_lambda": 242, "d_s": 242, "d_s_pan_lr": 242,
             "qnr": 484}


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """The Y channel (BT.601) of an RGB batch, ``(B, 1, H, W)``: PSNR-B's grayscale input."""
    weights = torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype, device=rgb.device).reshape(1, 3, 1, 1)
    return (rgb * weights).sum(1, keepdim=True)


def div2k_batch(gen: torch.Generator, n: int, shape=DIV2K_SHAPE, device: str = "cuda"):
    """(preds, target) of ``n`` RGB float32 images in [0, 1], as a x4 super-resolution model's
    evaluation sees them: smooth random targets (bicubic upsampling of a 1/16-scale field
    plus a finer 1/4-scale layer), and predictions that are the targets blurred (3 x 3
    box), with noise (std 0.01) and 8 x 8 block offsets (std 0.01)."""
    fn = torch.nn.functional
    h, w = shape
    coarse = torch.rand(n, 3, h // 16 + 2, w // 16 + 2, generator=gen, device=device)
    fine = torch.rand(n, 3, h // 4 + 1, w // 4 + 1, generator=gen, device=device)
    target = (0.8 * fn.interpolate(coarse, size=shape, mode="bicubic", align_corners=False)
              + 0.2 * fn.interpolate(fine, size=shape, mode="bilinear", align_corners=False)).clamp(0, 1)
    blurred = fn.avg_pool2d(fn.pad(target, (1, 1, 1, 1), mode="replicate"), 3, stride=1)
    blocks = torch.randn(n, 3, -(-h // 8), -(-w // 8), generator=gen, device=device)
    blocks = blocks.repeat_interleave(8, 2).repeat_interleave(8, 3)[..., :h, :w]
    noise = torch.randn(target.shape, generator=gen, device=device)
    return (blurred + 0.01 * noise + 0.01 * blocks).clamp(0, 1).contiguous(), target.contiguous()


def image_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch import image as im

    return {"psnr": im.PeakSignalNoiseRatio(data_range=1.0, device=device),
            "psnr_per_image": im.PeakSignalNoiseRatio(data_range=1.0, dim=(1, 2, 3), reduction="none", device=device),
            "ssim": im.StructuralSimilarityIndexMeasure(data_range=1.0, device=device),
            "ms_ssim": im.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=device),
            "uqi": im.UniversalImageQualityIndex(device=device),
            "vif": im.VisualInformationFidelity(device=device),
            "tv": im.TotalVariation(device=device),
            "rmse_sw": im.RootMeanSquaredErrorUsingSlidingWindow(window_size=8, device=device),
            "rase": im.RelativeAverageSpectralError(device=device),
            "psnrb": im.PeakSignalNoiseRatioWithBlockedEffect(data_range=1.0, device=device)}


def image_args(name: str, preds: torch.Tensor, target: torch.Tensor) -> tuple:
    """A metric's update arguments: TV reads the predictions, PSNR-B their Y channel."""
    if name == "tv":
        return (preds,)
    if name == "psnrb":
        return luma(preds), luma(target)
    return preds, target


def image_values(preds: torch.Tensor, target: torch.Tensor, names=None) -> dict:
    """Every image metric's per-image values (``names`` only, where given), through the
    port's functions: UQI's map mean, RMSE-SW (window 8), RASE and PSNR-B an image at a
    time, TV of the predictions; and the gradients' ``(dy, dx)``."""
    from torchmetrics_tpu_torch.functional import image as fi
    from torchmetrics_tpu_torch.functional.image.uqi import _uqi_map

    def each(fn):
        return torch.stack([fn(p[None], t[None]) for p, t in zip(preds, target)])

    makers = {
        "psnr": lambda: fi.peak_signal_noise_ratio(preds, target, 1.0, dim=(1, 2, 3), reduction="none"),
        "ssim": lambda: fi.structural_similarity_index_measure(preds, target, data_range=1.0, reduction="none"),
        "ms_ssim": lambda: fi.multiscale_structural_similarity_index_measure(preds, target, data_range=1.0,
                                                                             reduction="none"),
        "uqi": lambda: _uqi_map(preds, target).flatten(1).mean(1, dtype=torch.float64).to(torch.float32),
        "vif": lambda: fi.visual_information_fidelity(preds, target, reduction="none"),
        "tv": lambda: fi.total_variation(preds, reduction="none"),
        "rmse_sw": lambda: each(lambda p, t: fi.root_mean_squared_error_using_sliding_window(p, t, 8)),
        "rase": lambda: each(fi.relative_average_spectral_error),
        "psnrb": lambda: each(lambda p, t: fi.peak_signal_noise_ratio_with_blocked_effect(luma(p), luma(t), 1.0)),
        "gradients": lambda: torch.stack(fi.image_gradients(preds)),
    }
    return {name: make() for name, make in makers.items() if names is None or name in names}


def units_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` in float32 rounding units of ``max(|want|, 1)``; NaN
    must be in the same places, dtypes and shapes equal (else inf)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return math.inf
    return largest_rel_diff(got, want, floor=1.0) / UNIT


def hold_all(label: str, got: dict, want: dict, measure, limits) -> dict:
    """Every key's difference ``measure(key, got, want)`` against its limit (a number, or
    a dict by key); one error naming every key beyond its limit, with the difference
    and the limit. Returns the differences."""
    worst = {name: measure(name, got[name], value) for name, value in want.items()}
    limit = {name: limits[name] if isinstance(limits, dict) else limits for name in worst}
    beyond = {name: [worst[name], limit[name]] for name in worst if not worst[name] <= limit[name]}
    if beyond:
        raise AssertionError(f"{label}: card against CPU beyond the limits [difference, limit]: {beyond}")
    return worst


def hold_units(label: str, got: dict, want: dict, units) -> dict:
    """Key by key within ``units`` (a number, or a dict by key) rounding units; the
    gradients bit for bit. Returns each key's difference in units."""
    def measure(name, mine, value):
        if name == "gradients":
            return 0.0 if same_bits(mine, value) else math.inf
        return units_diff(mine, value)

    return hold_all(label, got, want, measure, units)


def ieee_then_tf32(call):
    """``call()`` with TF32 off in cuDNN and cuBLAS, then again with both on (the caller's
    settings restored after): the two results."""
    previous = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        results = []
        for allowed in (False, True):
            torch.backends.cudnn.allow_tf32 = allowed
            torch.backends.cuda.matmul.allow_tf32 = allowed
            results.append(call())
        return results
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = previous


def hold_tf32_bits(label: str, call) -> list:
    """The keys of ``call()``'s dict, each the same bits with TF32 allowed as without."""
    ieee, tf32 = ieee_then_tf32(call)
    for name, value in ieee.items():
        if not same_bits(tf32[name], value):
            raise AssertionError(f"{label} {name}: TF32 allowed changes the bits ({units_diff(tf32[name], value)} "
                                 "units)")
    return sorted(ieee)


def no_host_read(call):
    """``call()`` under ``torch.cuda.set_sync_debug_mode("error")``: a host read raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return call()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def central_crop(x: torch.Tensor, size) -> torch.Tensor:
    """The central ``size`` window of the trailing axes."""
    index = [slice(None)] * (x.ndim - len(size))
    index += [slice((n - s) // 2, (n - s) // 2 + s) for n, s in zip(x.shape[-len(size):], size)]
    return x[tuple(index)]


def run_image_updates(metrics: dict, batches, timed: bool = True) -> dict:
    """Every batch into every metric, and ``image_gradients`` of each: name -> update ms
    (median; 0 when not ``timed``)."""
    from torchmetrics_tpu_torch.functional import image_gradients

    clock = synced_ms if timed else (lambda call: (call(), 0.0)[1])
    times = {name: [] for name in [*metrics, "image_gradients"]}
    for preds, target in batches:
        for name, metric in metrics.items():
            times[name].append(clock(lambda: metric.update(*image_args(name, preds, target))))
        times["image_gradients"].append(clock(lambda: image_gradients(preds)))
    return {name: median(t) for name, t in times.items()}


def image_quality_phase(card: str) -> None:
    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(89)
    updates = DIV2K_IMAGES // DIV2K_BATCH
    first = div2k_batch(gen, DIV2K_BATCH)
    clock.append(("inputs", time.perf_counter()))
    metrics = image_metrics()

    def batches():
        yield first
        for _ in range(updates - 1):
            yield div2k_batch(gen, DIV2K_BATCH)

    update_ms = run_image_updates(metrics, batches())
    compute_ms = {name: [synced_ms(lambda: fresh_compute(m)) for _ in range(2)] for name, m in metrics.items()}
    values = {name: fresh_compute(m) for name, m in metrics.items()}
    clock.append(("card", time.perf_counter()))
    for name, value in values.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"image_quality {name}: {summary(value)}")
    if not 0.5 < float(values["ssim"]) < 1.0 or values["psnr_per_image"].shape != (DIV2K_IMAGES,):
        raise AssertionError(f"image_quality: SSIM {float(values['ssim'])}, {values['psnr_per_image'].shape}")
    preds, target = (x[:DIV2K_CPU_IMAGES] for x in first)
    card_values = image_values(preds, target)
    cpu_values = image_values(preds.cpu(), target.cpu())
    clock.append(("cpu", time.perf_counter()))
    worst = hold_units("image_quality", card_values, cpu_values, IMAGE_UNITS)
    tf32 = hold_tf32_bits("image_quality", lambda: image_values(*first, names=TF32_PROOF))
    guarded = image_metrics()
    for name in NO_HOST_READ:
        guarded[name].update(*image_args(name, *first))
        no_host_read(lambda: guarded[name].update(*image_args(name, *first)))
    peaks = {name: update_peak_bytes(image_metrics()[name], image_args(name, *first)) for name in ("ssim", "ms_ssim")}
    if max(peaks.values()) > SSIM_PEAK_LIMIT:
        raise AssertionError(f"image_quality: an update's peak extra bytes {peaks}")
    peaks.update({name: update_peak_bytes(image_metrics()[name], image_args(name, *first))
                  for name in ("uqi", "vif")})
    peaks["rase_compute"] = compute_peak_bytes(metrics["rase"])
    clock.append(("checks", time.perf_counter()))
    emit({"phase": "image_quality", "images": DIV2K_IMAGES, "shape": [3, *DIV2K_SHAPE], "batch": DIV2K_BATCH,
          "updates": updates, "update_ms": update_ms, "compute_ms_first_second": compute_ms,
          "values": {name: summary(v) for name, v in values.items()},
          "cpu_images": DIV2K_CPU_IMAGES, "per_image_units": worst,
          "units_limit": IMAGE_UNITS, "tf32_same_bits": tf32, "no_host_read_updates": list(NO_HOST_READ),
          "update_peak_extra_bytes": peaks, "seconds": clock_seconds(clock), "card": card})
    for name in ("ssim", "ms_ssim", "vif"):
        profile_step(f"image_quality_{name}_update", lambda: guarded.get(name, metrics[name]).update(*first))


def brats_mri(rng, device: str = "cuda", gen=None, shape=BRATS_SHAPE, wt_voxels=BRATS_WT_VOXELS):
    """(preds, target) of one MRI-synthesis pair, ``(1, 240, 240, 155)`` float32 volumes in
    raw intensities: ``brats_volume``'s label maps at T1ce-like levels under a smooth bias
    field; the prediction's labels are the shifted ones, with noise (std 15)."""
    pred_labels, target_labels = brats_volume(rng, shape=shape, device=device, wt_voxels=wt_voxels)
    levels = torch.tensor(BRATS_MRI_INTENSITY, device=device)
    cells = torch.from_numpy(rng.normal(0, 0.05, (1, 1, 4, 4, 3)).astype(np.float32)).to(device)
    bias = 1 + torch.nn.functional.interpolate(cells, size=shape, mode="trilinear", align_corners=False)[0]
    noise = torch.randn((1, *shape), generator=gen, device=device)
    return levels[pred_labels][None] * bias + 15 * noise, levels[target_labels][None] * bias


def separable_conv3d(x: torch.Tensor, sigma: float = 1.5, size: int = 11) -> torch.Tensor:
    """The 11^3 gaussian window as three 1-D passes (33 taps), at full float32 precision."""
    from torchmetrics_tpu_torch.functional.image.utils import _gaussian, conv3d

    g = _gaussian(size, sigma, x.dtype, x.device).reshape(-1)
    c = x.shape[1]
    for shape in ((size, 1, 1), (1, size, 1), (1, 1, size)):
        x = conv3d(x, g.reshape(1, 1, *shape).expand(c, 1, *shape).contiguous(), groups=c)
    return x


def ssim_3d_moments(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """SSIM's stacked, padded moment batch of a 3-D pair (the convolutions' input)."""
    from torchmetrics_tpu_torch.functional.image.utils import reflect_pad_3d

    preds, target = (reflect_pad_3d(x, 5, 5, 5) for x in (preds, target))
    return torch.cat([preds, target, preds * preds, target * target, preds * target])


def image_quality_3d_phase(card: str) -> None:
    from torchmetrics_tpu_torch.functional import image as fi
    from torchmetrics_tpu_torch.functional.image.utils import _gaussian_kernel_3d, conv3d
    from torchmetrics_tpu_torch.image import StructuralSimilarityIndexMeasure

    clock = [("start", time.perf_counter())]
    rng = np.random.default_rng(97)
    gen = torch.Generator(device="cuda").manual_seed(97)
    pairs = [brats_mri(rng, gen=gen) for _ in range(BRATS_MRI_VOLUMES)]
    batches = [tuple(torch.stack(x) for x in zip(*pairs[i:i + BRATS_MRI_BATCH]))
               for i in range(0, BRATS_MRI_VOLUMES, BRATS_MRI_BATCH)]
    del pairs
    clock.append(("inputs", time.perf_counter()))
    metric = StructuralSimilarityIndexMeasure()
    update_ms = [synced_ms(lambda: metric.update(*batch)) for batch in batches]
    compute_ms = [synced_ms(lambda: fresh_compute(metric)) for _ in range(2)]
    ssim = fresh_compute(metric)
    ms_ssim_ms = synced_ms(lambda: fi.multiscale_structural_similarity_index_measure(*batches[0],
                                                                                    betas=BRATS_MS_BETAS))
    ms_ssim = fi.multiscale_structural_similarity_index_measure(*batches[0], betas=BRATS_MS_BETAS, reduction="none")
    if not 0.0 < float(ssim) < 1.0 or not bool(torch.isfinite(ms_ssim).all()):
        raise AssertionError(f"image_quality_3d: SSIM {float(ssim)}, MS-SSIM {ms_ssim.tolist()}")
    clock.append(("card", time.perf_counter()))
    crop = [central_crop(x[:1], BRATS_MRI_CROP) for x in batches[0]]
    card_value = fi.structural_similarity_index_measure(*crop, reduction="none")
    cpu_value = fi.structural_similarity_index_measure(*(x.cpu() for x in crop), reduction="none")
    clock.append(("cpu", time.perf_counter()))
    worst = hold_units("image_quality_3d", {"ssim": card_value}, {"ssim": cpu_value}, IMAGE_UNITS)
    tf32 = hold_tf32_bits("image_quality_3d", lambda: {
        "ssim": fi.structural_similarity_index_measure(*batches[0], reduction="none"),
        "ms_ssim": fi.multiscale_structural_similarity_index_measure(*batches[0], betas=BRATS_MS_BETAS,
                                                                     reduction="none")})
    no_host_read(lambda: metric.update(*batches[0]))
    peak = update_peak_bytes(StructuralSimilarityIndexMeasure(), batches[0])
    if peak > SSIM_PEAK_LIMIT:
        raise AssertionError(f"image_quality_3d: an update's peak extra bytes {peak}")
    # the 11^3 window: directly (the port's form, JAX's sum order) and as three 1-D passes
    moments = ssim_3d_moments(*batches[0])
    kernel = _gaussian_kernel_3d(1, (11, 11, 11), (1.5, 1.5, 1.5), moments.dtype, moments.device)
    direct = conv3d(moments, kernel)
    separable = separable_conv3d(moments)
    forms = {"direct_ms": cuda_ms(lambda: conv3d(moments, kernel), iters=3, warmup=1),
             "separable_ms": cuda_ms(lambda: separable_conv3d(moments), iters=3, warmup=1),
             "max_rel_diff": float(((separable - direct).abs() / direct.abs().clamp(min=1e-30)).max())}
    forms["speedup"] = forms["direct_ms"] / forms["separable_ms"]
    forms["separable_at_least_3x"] = forms["speedup"] >= SEPARABLE_MIN_SPEEDUP
    del moments, direct, separable
    clock.append(("checks", time.perf_counter()))
    emit({"phase": "image_quality_3d", "volumes": BRATS_MRI_VOLUMES, "shape": [1, *BRATS_SHAPE],
          "batch": BRATS_MRI_BATCH, "updates": len(batches), "window": [11, 11, 11], "data_range": None,
          "update_ms": median(update_ms), "update_ms_max": max(update_ms), "compute_ms_first_second": compute_ms,
          "ms_ssim_first_update_ms": ms_ssim_ms, "ms_ssim_betas": list(BRATS_MS_BETAS),
          "values": {"ssim": float(ssim), "ms_ssim": ms_ssim.tolist()}, "cpu_crop": list(BRATS_MRI_CROP),
          "crop_units": worst, "units_limit": IMAGE_UNITS, "tf32_same_bits": tf32, "no_host_read_update": True,
          "update_peak_extra_bytes": peak, "window_forms": forms, "seconds": clock_seconds(clock), "card": card})
    profile_step("image_quality_3d_ssim_update", lambda: metric.update(*batches[0]))


def pan_set(gen: torch.Generator, samples: int, bands: int, size: int, device: str = "cuda") -> dict:
    """A WorldView-3-shaped test set: ``truth`` (smooth random bands, a bicubic 1/8-scale
    field), ``fused`` (truth with noise std 0.02 and a band bias), ``pan`` (the bands' mean,
    repeated to every band), ``ms`` and ``pan_lr`` (truth and pan area-averaged by the
    ratio 4)."""
    fn = torch.nn.functional
    coarse = torch.rand(samples, bands, size // 8 + 2, size // 8 + 2, generator=gen, device=device)
    truth = (0.05 + 0.9 * fn.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)).clamp(0.01, 1)
    bias = 0.02 * torch.randn(samples, bands, 1, 1, generator=gen, device=device)
    fused = (truth + bias + 0.02 * torch.randn(truth.shape, generator=gen, device=device)).clamp(0.01, 1)
    pan = truth.mean(1, keepdim=True).expand(-1, bands, -1, -1).contiguous()
    return {"truth": truth, "fused": fused, "pan": pan, "ms": fn.avg_pool2d(truth, PAN_RATIO),
            "pan_lr": fn.avg_pool2d(pan, PAN_RATIO)}


def pan_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch import image as im

    return {"sam": im.SpectralAngleMapper(device=device),
            "ergas": im.ErrorRelativeGlobalDimensionlessSynthesis(ratio=PAN_RATIO, device=device),
            "scc": im.SpatialCorrelationCoefficient(device=device),
            "uqi": im.UniversalImageQualityIndex(device=device),
            "d_lambda": im.SpectralDistortionIndex(device=device),
            "d_s": im.SpatialDistortionIndex(device=device),
            "d_s_pan_lr": im.SpatialDistortionIndex(device=device),
            "qnr": im.QualityWithNoReference(device=device)}


def pan_args(name: str, reduced: dict, full: dict, rows: slice) -> tuple:
    """A metric's update arguments over ``rows`` of the sets: the reduced set's fused
    images against the truth, the full set's against ``ms`` and ``pan`` (and ``pan_lr``)."""
    if name in ("sam", "ergas", "scc", "uqi"):
        return reduced["fused"][rows], reduced["truth"][rows]
    if name == "d_lambda":
        return full["fused"][rows], full["ms"][rows]
    target = {"ms": full["ms"][rows], "pan": full["pan"][rows]}
    if name == "d_s_pan_lr":
        target["pan_lr"] = full["pan_lr"][rows]
    return full["fused"][rows], target


def pan_values(reduced: dict, full: dict) -> dict:
    """Every index on the sets through the port's functions; QNR from D_lambda and D_s, as
    its compute takes it."""
    from torchmetrics_tpu_torch.functional import image as fi

    fused, truth = reduced["fused"], reduced["truth"]
    out = {"sam": fi.spectral_angle_mapper(fused, truth),
           "ergas": fi.error_relative_global_dimensionless_synthesis(fused, truth, ratio=PAN_RATIO),
           "scc": fi.spatial_correlation_coefficient(fused, truth),
           "uqi": fi.universal_image_quality_index(fused, truth),
           "d_lambda": fi.spectral_distortion_index(full["fused"], full["ms"]),
           "d_s": fi.spatial_distortion_index(full["fused"], full["ms"], full["pan"]),
           "d_s_pan_lr": fi.spatial_distortion_index(full["fused"], full["ms"], full["pan"], full["pan_lr"])}
    out["qnr"] = (1 - out["d_lambda"]) * (1 - out["d_s"])
    return out


def pansharpening_phase(card: str) -> None:
    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(101)
    reduced, full = pan_set(gen, *PAN_REDUCED), pan_set(gen, *PAN_FULL)
    clock.append(("inputs", time.perf_counter()))
    metrics = pan_metrics()
    samples = PAN_REDUCED[0]
    update_ms = {name: median([synced_ms(lambda: m.update(*pan_args(name, reduced, full, slice(i, i + PAN_BATCH))))
                               for i in range(0, samples, PAN_BATCH)]) for name, m in metrics.items()}
    compute_ms = {name: [synced_ms(lambda: fresh_compute(m)) for _ in range(2)] for name, m in metrics.items()}
    values = {name: fresh_compute(m) for name, m in metrics.items()}
    peak = compute_peak_bytes(metrics["d_lambda"])
    if peak > D_LAMBDA_PEAK_LIMIT:
        raise AssertionError(f"pansharpening: D_lambda's compute took {peak} bytes beyond its states")
    for name, value in values.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"pansharpening {name}: {summary(value)}")
    clock.append(("card", time.perf_counter()))
    head = slice(0, PAN_CPU_SAMPLES)
    sets = [{k: v[head] for k, v in s.items()} for s in (reduced, full)]
    card_values = pan_values(*sets)
    cpu_values = pan_values(*({k: v.cpu() for k, v in s.items()} for s in sets))
    clock.append(("cpu", time.perf_counter()))
    worst = hold_units("pansharpening", card_values, cpu_values, PAN_UNITS)
    clock.append(("checks", time.perf_counter()))
    emit({"phase": "pansharpening", "reduced": {"samples": PAN_REDUCED[0], "bands": PAN_REDUCED[1],
                                                "fused": PAN_REDUCED[2], "ms": PAN_REDUCED[2] // PAN_RATIO},
          "full": {"samples": PAN_FULL[0], "bands": PAN_FULL[1], "fused": PAN_FULL[2], "ms": PAN_FULL[2] // PAN_RATIO,
                   "pan": PAN_FULL[2]},
          "batch": PAN_BATCH, "update_ms": update_ms, "compute_ms_first_second": compute_ms,
          "values": {name: summary(v) for name, v in values.items()}, "cpu_samples": PAN_CPU_SAMPLES,
          "cpu_units": worst, "units_limit": PAN_UNITS, "d_lambda_compute_peak_extra_bytes": peak,
          "seconds": clock_seconds(clock), "card": card})
    profile_step("pansharpening_d_lambda_compute", lambda: fresh_compute(metrics["d_lambda"]))
    profile_step("pansharpening_uqi_update", lambda: metrics["uqi"].update(*pan_args("uqi", reduced, full, head)))


LIBRI_MIXTURES = 3000  # Libri2Mix test: 3,000 mixtures of 2 speakers
LIBRI_SAMPLES = 80000  # 5 s at 16 kHz
LIBRI_BATCH = 50
LIBRI_CPU_MIXTURES = 4  # the CPU port reads the first update's first 4 mixtures
WSJ5_SHAPE = (16, 5, 40000)  # WSJ0-5mix-shaped: 16 mixtures of 5 speakers, 5 s at 8 kHz
STFT_N_FFT, STFT_HOP = 512, 128
SDR_TAPS = 512
AUDIO_ULPS = 2  # card against CPU: dB values within 2 float32 spacings of the CPU's value (log10 differs by one)
SDR_DB_ATOL = 1e-6  # card against CPU: SDR in float64 before its float32 rounding
SEPARATION_NO_HOST_READ = ("snr", "si_snr", "si_sdr", "sa_sdr", "c_si_snr", "pit", "pit_permutation_wise")
SDR_HOST_READS = 1  # SDR reads its solver's flags once a call, to raise where scipy raises
REVERB_SHAPE = (16, 8 * 16000)  # REVERB-style utterances: 8 s at 16 kHz
DNS_SHAPE = (32, 10 * 16000)  # DNS-Challenge-style clips: 10 s at 16 kHz
NISQA_SHAPE = (16, 10 * 48000)  # 10 s at 48 kHz
SPEECH_CPU_CLIPS = 2
SPEECH_NO_HOST_READ = ("dnsmos", "nisqa")  # DNSMOS through infer_fns that stay on the card
SPEECH_UNITS = {"srmr": 4, "dnsmos": 2, "nisqa": 64}
# NISQA's published configuration (config/nisqa.yaml of the NISQA repository)
NISQA_PUBLISHED_ARGS = {
    "ms_n_fft": 4096, "ms_hop_length": 0.01, "ms_win_length": 0.02, "ms_n_mels": 48, "ms_fmax": 20000,
    "ms_seg_length": 15, "ms_seg_hop_length": 4, "ms_max_segments": 1300, "cnn_c_out_1": 16, "cnn_c_out_2": 32,
    "cnn_c_out_3": 64, "cnn_kernel_size": (3, 3), "cnn_dropout": 0.2, "cnn_pool_1": [24, 7], "cnn_pool_2": [12, 5],
    "cnn_pool_3": [6, 3], "td_sa_d_model": 64, "td_sa_nhead": 1, "td_sa_num_layers": 2, "td_sa_h": 64,
    "td_sa_dropout": 0.1, "pool_att_h": 128, "pool_att_dropout": 0.1,
}
VMAF_VIDEOS = 8  # 1080p videos of 24 frames, 2 an update
VMAF_SHAPE = (3, 24, 1080, 1920)
VMAF_BATCH = 2
VMAF_CPU_FRAMES = 4  # the CPU port reads the first video's first 4 frames
VMAF_UNITS = 64  # card against CPU: features within 64 float32 rounding units of their magnitude (at least 1)
VMAF_SCORE_ATOL = 1e-3  # and the fused score, on its 0-100 scale
V061_FEATURES = ["VMAF_feature_adm2_score", "VMAF_feature_motion2_score", "VMAF_feature_vif_scale0_score",
                 "VMAF_feature_vif_scale1_score", "VMAF_feature_vif_scale2_score", "VMAF_feature_vif_scale3_score"]


def speech_like(gen: torch.Generator, shape, fs: int, device: str = "cuda") -> torch.Tensor:
    """Speech-like float32 signals: white noise with a spectral tilt (gain 1 / sqrt(1 +
    f / 500 Hz)) under a syllabic envelope (3-6 Hz, squared, so it pauses)."""
    n = shape[-1]
    noise = torch.randn(shape, generator=gen, device=device)
    freqs = torch.fft.rfftfreq(n, 1.0 / fs, device=device)
    tilted = torch.fft.irfft(torch.fft.rfft(noise) / torch.sqrt(1 + freqs / 500.0), n=n)
    rate = 3 + 3 * torch.rand((*shape[:-1], 1), generator=gen, device=device)
    phase = 2 * math.pi * torch.rand((*shape[:-1], 1), generator=gen, device=device)
    t = torch.arange(n, device=device) / fs
    envelope = torch.sin(2 * math.pi * rate * t + phase).clamp(min=0) ** 2
    x = tilted * envelope
    return (0.5 * x / x.abs().amax(-1, keepdim=True)).contiguous()


def libri_mixture(gen: torch.Generator, batch: int, speakers: int = 2, samples: int = LIBRI_SAMPLES,
                  fs: int = 16000, device: str = "cuda"):
    """(preds, target) of a separation system's output: each estimate is its source plus
    20% of the other sources and noise at -26 dB, and half the mixtures come out in
    another speaker order (rolled by one), as PIT must find."""
    target = speech_like(gen, (batch, speakers, samples), fs, device)
    leak = (target.sum(1, keepdim=True) - target) / max(speakers - 1, 1)
    preds = 0.9 * target + 0.2 * leak + 0.05 * torch.randn(target.shape, generator=gen, device=device) * 0.5
    swap = torch.rand(batch, generator=gen, device=device) < 0.5
    preds = torch.where(swap[:, None, None], preds.roll(1, dims=1), preds)
    return preds.contiguous(), target


def stft_pairs(x: torch.Tensor) -> torch.Tensor:
    """(B, spk, T) -> (B, spk, 257, frames, 2): the 512-point STFT (hop 128, Hann) as real
    pairs, C-SI-SNR's input."""
    window = torch.hann_window(STFT_N_FFT, device=x.device)
    spec = torch.stft(x.reshape(-1, x.shape[-1]), STFT_N_FFT, STFT_HOP, window=window, return_complex=True)
    return torch.view_as_real(spec).reshape(*x.shape[:2], *spec.shape[1:], 2).contiguous()


def separation_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch import audio as au
    from torchmetrics_tpu_torch.functional import scale_invariant_signal_noise_ratio

    return {"snr": au.SignalNoiseRatio(device=device), "si_snr": au.ScaleInvariantSignalNoiseRatio(device=device),
            "si_sdr": au.ScaleInvariantSignalDistortionRatio(device=device),
            "sa_sdr": au.SourceAggregatedSignalDistortionRatio(device=device),
            "c_si_snr": au.ComplexScaleInvariantSignalNoiseRatio(device=device),
            "sdr": au.SignalDistortionRatio(filter_length=SDR_TAPS, device=device),
            "pit": au.PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device=device),
            "pit_permutation_wise": au.PermutationInvariantTraining(scale_invariant_signal_noise_ratio,
                                                                    mode="permutation-wise", device=device)}


def separation_args(name: str, preds: torch.Tensor, target: torch.Tensor, spectra) -> tuple:
    return spectra if name == "c_si_snr" else (preds, target)


def separation_values(preds: torch.Tensor, target: torch.Tensor, spectra) -> dict:
    """Each separation metric's per-sample values through the port's functions; PIT's
    best values and permutations; SDR in float64 before its rounding."""
    from torchmetrics_tpu_torch import functional as fn
    from torchmetrics_tpu_torch.functional.audio.sdr import _sdr_solve

    pit = fn.permutation_invariant_training(preds, target, fn.scale_invariant_signal_noise_ratio)
    pit_perm = fn.permutation_invariant_training(preds, target, fn.scale_invariant_signal_noise_ratio,
                                                 mode="permutation-wise")
    sdr_db, info = _sdr_solve(preds, target, SDR_TAPS)
    return {"snr": fn.signal_noise_ratio(preds, target), "si_snr": fn.scale_invariant_signal_noise_ratio(preds, target),
            "si_sdr": fn.scale_invariant_signal_distortion_ratio(preds, target),
            "sa_sdr": fn.source_aggregated_signal_distortion_ratio(preds, target),
            "c_si_snr": fn.complex_scale_invariant_signal_noise_ratio(*spectra),
            "pit": pit[0], "pit_perm": pit[1], "pit_permutation_wise": pit_perm[0], "pit_permutation_wise_perm":
            pit_perm[1], "sdr_float64": sdr_db, "sdr_info": info}


def ulps_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` in float32 spacings at ``want`` (inf where dtypes,
    shapes or NaN places differ)."""
    got, want = got.cpu(), want.cpu()
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got.isnan(), want.isnan()):
        return math.inf
    keep = ~want.isnan()
    magnitude = want[keep].abs()
    spacing = (torch.nextafter(magnitude, torch.full_like(magnitude, math.inf)) - magnitude).double()
    return float(((got[keep].double() - want[keep].double()).abs() / spacing).max()) if bool(keep.any()) else 0.0


def separation_diff(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Permutations and solver flags: 0 where equal, else inf; SDR's float64 dB: the
    largest absolute difference; float32 dB: ``ulps_diff``."""
    if want.dtype == torch.float64:
        return float((got.cpu() - want).abs().max())
    if not want.is_floating_point():
        return 0.0 if same_bits(got, want) else math.inf
    return ulps_diff(got, want)


def hold_separation(label: str, got: dict, want: dict) -> dict:
    """Permutations and solver flags bit for bit, SDR's float64 dB within ``SDR_DB_ATOL``,
    the dB values within ``AUDIO_ULPS``. Returns each key's difference."""
    limits = {name: SDR_DB_ATOL if value.dtype == torch.float64 else AUDIO_ULPS for name, value in want.items()}
    return hold_all(label, got, want, separation_diff, limits)


def sdr_read_cost(metric, preds: torch.Tensor, target: torch.Tensor) -> dict:
    """SDR's one host read a call: counted, its cost as the update's median time against
    the solve alone (which reads nothing), and the raise on a silent target and on NaN
    input, as scipy's, on the card."""
    from torchmetrics_tpu_torch.functional.audio.sdr import _sdr_solve

    reads = host_reads(lambda: metric.update(preds, target))
    if reads != SDR_HOST_READS:
        raise AssertionError(f"audio_separation: an SDR update read the host {reads} times")
    no_host_read(lambda: _sdr_solve(preds, target, SDR_TAPS))
    update = [synced_ms(lambda: metric.update(preds, target)) for _ in range(5)]
    solve = [synced_ms(lambda: _sdr_solve(preds, target, SDR_TAPS)) for _ in range(5)]
    raised = {}
    for case in ("silent_target", "nan_preds"):
        bad_preds, bad_target = preds[:4].clone(), target[:4].clone()
        if case == "silent_target":
            bad_target[2] = 0.0
        else:
            bad_preds[1, 0, 9] = float("nan")
        try:
            metric.update(bad_preds, bad_target)
        except (ValueError, np.linalg.LinAlgError) as err:
            raised[case] = f"{type(err).__name__}: {err}"
    if raised != {"silent_target": "LinAlgError: Singular principal minor",
                  "nan_preds": "ValueError: array must not contain infs or NaNs"}:
        raise AssertionError(f"audio_separation: SDR raised {raised}")
    return {"host_reads": reads, "update_ms": median(update), "solve_ms": median(solve), "raised": raised}


def audio_separation_phase(card: str) -> None:
    from torchmetrics_tpu_torch import audio as au
    from torchmetrics_tpu_torch.functional import permutation_invariant_training, scale_invariant_signal_noise_ratio

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(151)
    updates = LIBRI_MIXTURES // LIBRI_BATCH
    metrics = separation_metrics()
    times = {name: [] for name in metrics}
    first = None
    for step in range(updates):
        preds, target = libri_mixture(gen, LIBRI_BATCH)
        spectra = (stft_pairs(preds), stft_pairs(target))
        if first is None:
            first = (preds, target, spectra)
        for name, metric in metrics.items():
            times[name].append(synced_ms(lambda: metric.update(*separation_args(name, preds, target, spectra))))
    update_ms = {name: {"first": t[0], "median": median(t[1:])} for name, t in times.items()}
    values = {name: fresh_compute(m) for name, m in metrics.items()}
    clock.append(("card", time.perf_counter()))
    for name, value in values.items():
        if not bool(torch.isfinite(value)):
            raise AssertionError(f"audio_separation {name}: {float(value)}")
    # half the mixtures come out in swapped order: SI-SNR pairs the wrong speakers there, PIT does not
    if not 0.0 < float(values["pit"]) < 30.0 or float(values["pit"]) < float(values["si_snr"]):
        raise AssertionError(f"audio_separation: SI-SNR {float(values['si_snr'])}, PIT {float(values['pit'])}")
    preds, target, spectra = first
    head = slice(0, LIBRI_CPU_MIXTURES)
    card_values = separation_values(preds[head], target[head], tuple(s[head] for s in spectra))
    cpu_values = separation_values(preds[head].cpu(), target[head].cpu(), tuple(s[head].cpu() for s in spectra))
    if bool(card_values["sdr_info"].any()):
        raise AssertionError(f"audio_separation: SDR's solver flags {card_values['sdr_info'].tolist()}")
    clock.append(("cpu", time.perf_counter()))
    worst = hold_separation("audio_separation", card_values, cpu_values)
    for name in SEPARATION_NO_HOST_READ:
        no_host_read(lambda: metrics[name].update(*separation_args(name, preds, target, spectra)))
    sdr = sdr_read_cost(metrics["sdr"], preds, target)
    peaks = {name: update_peak_bytes(separation_metrics()[name], separation_args(name, preds, target, spectra))
             for name in ("sdr", "pit", "pit_permutation_wise", "c_si_snr")}
    # Libri3Mix-shaped: one update of 50 mixtures of 3 speakers, no host read either
    three = libri_mixture(gen, LIBRI_BATCH, speakers=3)
    pit3 = {mode: au.PermutationInvariantTraining(scale_invariant_signal_noise_ratio, mode=mode)
            for mode in ("speaker-wise", "permutation-wise")}
    pit3_ms = {mode: synced_ms(lambda: m.update(*three)) for mode, m in pit3.items()}
    for m in pit3.values():
        no_host_read(lambda: m.update(*three))
    three_cpu = tuple(x[:LIBRI_CPU_MIXTURES] for x in three)
    for mode in pit3:
        card_pit = permutation_invariant_training(*three_cpu, scale_invariant_signal_noise_ratio, mode)
        cpu_pit = permutation_invariant_training(*(x.cpu() for x in three_cpu), scale_invariant_signal_noise_ratio,
                                                 mode)
        worst[f"pit3_{mode}"] = hold_separation("audio_separation 3 speakers", {"v": card_pit[0], "v_perm": card_pit[1]},
                                                {"v": cpu_pit[0], "v_perm": cpu_pit[1]})["v"]
    # WSJ0-5mix-shaped: 5 speakers, the Hungarian branch (one host read of the matrix)
    five = libri_mixture(gen, WSJ5_SHAPE[0], speakers=WSJ5_SHAPE[1], samples=WSJ5_SHAPE[2], fs=8000)
    pit5 = au.PermutationInvariantTraining(scale_invariant_signal_noise_ratio)
    pit5.update(*five)
    pit5_ms = synced_ms(lambda: pit5.update(*five))
    pit5_reads = host_reads(lambda: pit5.update(*five))
    card_pit = permutation_invariant_training(*five, scale_invariant_signal_noise_ratio)
    cpu_pit = permutation_invariant_training(*(x.cpu() for x in five), scale_invariant_signal_noise_ratio)
    worst["pit5"] = hold_separation("audio_separation 5 speakers", {"v": card_pit[0], "v_perm": card_pit[1]},
                                    {"v": cpu_pit[0], "v_perm": cpu_pit[1]})["v"]
    clock.append(("checks", time.perf_counter()))
    emit({"phase": "audio_separation", "mixtures": LIBRI_MIXTURES, "speakers": 2, "samples": LIBRI_SAMPLES,
          "batch": LIBRI_BATCH, "updates": updates, "stft": [LIBRI_BATCH, 2, *spectra[0].shape[2:]],
          "sdr_taps": SDR_TAPS, "update_ms": update_ms, "values": {n: float(v) for n, v in values.items()},
          "cpu_mixtures": LIBRI_CPU_MIXTURES, "cpu_ulps_or_db": worst, "ulps_limit": AUDIO_ULPS,
          "sdr_db_limit": SDR_DB_ATOL, "no_host_read_updates": [*SEPARATION_NO_HOST_READ, "pit3 (both modes)"],
          "sdr_flags_read": sdr,
          "update_peak_extra_bytes": peaks, "pit3_update_ms": pit3_ms, "pit5": {
              "shape": list(WSJ5_SHAPE), "update_ms": pit5_ms, "host_reads": pit5_reads,
              "value": float(fresh_compute(pit5))},
          "seconds": clock_seconds(clock), "card": card})
    for name in ("sdr", "pit", "si_snr"):
        profile_step(f"audio_separation_{name}_update",
                     lambda: metrics[name].update(*separation_args(name, preds, target, spectra)))


def reverberant_speech(gen: torch.Generator, shape=REVERB_SHAPE, fs: int = 16000, device: str = "cuda"):
    """REVERB-style utterances: speech-like signals convolved (by FFT) with exponentially
    decaying noise of a reverberation time between 0.3 and 0.9 s, half a second long."""
    clean = speech_like(gen, shape, fs, device)
    taps = fs // 2
    rt60 = 0.3 + 0.6 * torch.rand((shape[0], 1), generator=gen, device=device)
    t = torch.arange(taps, device=device) / fs
    ir = torch.randn((shape[0], taps), generator=gen, device=device) * 10 ** (-3 * t / rt60)
    ir[:, 0] = 1.0
    n = shape[-1] + taps
    wet = torch.fft.irfft(torch.fft.rfft(clean, n=n) * torch.fft.rfft(ir, n=n), n=n)[:, : shape[-1]]
    return (0.5 * wet / wet.abs().amax(-1, keepdim=True)).contiguous()


def host_hilbert_envelope(x: np.ndarray) -> np.ndarray:
    """The JAX package's numpy Hilbert envelope (FFT length a multiple of 16), the host
    side of SRMR's choice of device."""
    t = x.shape[-1]
    n = math.ceil(t / 16) * 16 if t % 16 else t
    h = np.zeros(n)
    h[0] = 1
    if n % 2 == 0:
        h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[1 : (n + 1) // 2] = 2
    return np.abs(np.fft.ifft(np.fft.fft(x, n=n, axis=-1) * h, axis=-1)[..., :t])


class DnsLinearModels:
    """Seeded stand-ins for the two DNSMOS ONNX models, linear maps of their inputs in
    float64 by elementwise products (no matmul, so TF32 cannot touch them): p808 of the
    mel features' mean over frames, sig/bak/ovr of the mean absolute sample."""

    def __init__(self, seed: int, device) -> None:
        gen = torch.Generator().manual_seed(seed)
        self.p808 = (torch.randn(120, generator=gen, dtype=torch.float64) / 12).to(device)
        self.sbo = (1 + torch.rand(3, generator=gen, dtype=torch.float64)).to(device)

    def fns(self):
        return (lambda mel: (mel.to(torch.float64).mean(1) * self.p808.to(mel.device)).sum(-1, keepdim=True) + 3,
                lambda audio: audio.to(torch.float64).abs().mean(1, keepdim=True) * self.sbo.to(audio.device) + 3)


def nisqa_checkpoint(path: str, seed: int = 157) -> None:
    """A checkpoint in the published ``nisqa.tar`` layout at the published widths: the
    port's model from a seed, batch-norm statistics drawn too."""
    from torchmetrics_tpu_torch.functional.audio.nisqa import NISQAModel

    torch.manual_seed(seed)
    model = NISQAModel(NISQA_PUBLISHED_ARGS)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                module.running_mean.normal_(0, 0.2)
                module.running_var.uniform_(0.5, 2.0)
    torch.save({"args": NISQA_PUBLISHED_ARGS, "model_state_dict": model.state_dict()}, path)


def speech_quality_phase(card: str) -> None:
    import tempfile

    from torchmetrics_tpu_torch import audio as au
    from torchmetrics_tpu_torch import functional as fn
    from torchmetrics_tpu_torch.functional.audio import srmr as port_srmr

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(153)
    reverb = reverberant_speech(gen)
    dns = speech_like(gen, DNS_SHAPE, 16000) + 0.02 * torch.randn(DNS_SHAPE, generator=gen, device="cuda")
    nisqa_clips = speech_like(gen, NISQA_SHAPE, 48000)
    clock.append(("inputs", time.perf_counter()))
    models = DnsLinearModels(155, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "nisqa.tar")
        nisqa_checkpoint(ckpt)
        metrics = {"srmr": au.SpeechReverberationModulationEnergyRatio(16000),
                   "dnsmos": au.DeepNoiseSuppressionMeanOpinionScore(16000, False, infer_fns=models.fns()),
                   "nisqa": au.NonIntrusiveSpeechQualityAssessment(48000, checkpoint_path=ckpt)}
        inputs = {"srmr": reverb, "dnsmos": dns, "nisqa": nisqa_clips}
        first_ms, update_ms, peaks, reads = {}, {}, {}, {}
        for name, m in metrics.items():  # SRMR's host filters take seconds an update: three updates each
            first_ms[name] = synced_ms(lambda: m.update(inputs[name]))
            update_ms[name], peaks[name] = peak_extra_bytes(lambda: synced_ms(lambda: m.update(inputs[name])))
            reads[name] = host_reads(lambda: m.update(inputs[name]))
        for name in SPEECH_NO_HOST_READ:  # their features and models stay on the card
            no_host_read(lambda: metrics[name].update(inputs[name]))
        values = {name: fresh_compute(m) for name, m in metrics.items()}
        clock.append(("card", time.perf_counter()))
        head = slice(0, SPEECH_CPU_CLIPS)
        calls = {"srmr": lambda x: fn.speech_reverberation_modulation_energy_ratio(x, 16000),
                 "dnsmos": lambda x: fn.deep_noise_suppression_mean_opinion_score(
                     x, 16000, False, infer_fns=DnsLinearModels(155, x.device).fns()),
                 "nisqa": lambda x: fn.non_intrusive_speech_quality_assessment(x, 48000, checkpoint_path=ckpt)}
        card_values = {name: call(inputs[name][head]) for name, call in calls.items()}
        cpu_values = {name: call(inputs[name][head].cpu()) for name, call in calls.items()}
        clock.append(("cpu", time.perf_counter()))
        worst = hold_units("speech_quality", card_values, cpu_values, SPEECH_UNITS)
        tf32 = hold_tf32_bits("speech_quality", lambda: {"nisqa": calls["nisqa"](nisqa_clips)})
        profile_step("speech_quality_nisqa_update", lambda: metrics["nisqa"].update(nisqa_clips))
        profile_step("speech_quality_dnsmos_update", lambda: metrics["dnsmos"].update(dns))
    for name, value in values.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"speech_quality {name}: {summary(value)}")
    # SRMR's choice of device for its envelope: the same FFTs on the card and on the host
    bands = port_srmr._erb_filterbank(reverb.cpu().double().numpy(), port_srmr._make_erb_filters(
        16000, port_srmr._centre_freqs(16000, 23, 125)))
    card_bands = torch.from_numpy(bands).cuda()
    envelope_ms = {"card": median([synced_ms(lambda: port_srmr._hilbert_envelope(card_bands)) for _ in range(3)])}
    start = time.perf_counter()
    host_env = host_hilbert_envelope(bands)
    envelope_ms["host"] = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    round_trip = port_srmr._hilbert_envelope(torch.from_numpy(bands).cuda()).cpu().numpy()
    envelope_ms["card_with_copies"] = (time.perf_counter() - start) * 1e3
    envelope_diff = float(np.abs(round_trip - host_env).max() / np.abs(host_env).max())
    clock.append(("checks", time.perf_counter()))
    emit({"phase": "speech_quality", "srmr": {"utterances": REVERB_SHAPE[0], "samples": REVERB_SHAPE[1], "fs": 16000},
          "dnsmos": {"clips": DNS_SHAPE[0], "samples": DNS_SHAPE[1], "fs": 16000, "models": "seeded linear maps"},
          "nisqa": {"clips": NISQA_SHAPE[0], "samples": NISQA_SHAPE[1], "fs": 48000,
                    "checkpoint": "published widths, seeded weights"},
          "first_update_ms": first_ms, "update_ms": update_ms, "host_reads": reads,
          "no_host_read_updates": list(SPEECH_NO_HOST_READ),
          "values": {name: summary(v) for name, v in values.items()}, "cpu_clips": SPEECH_CPU_CLIPS,
          "cpu_units": worst, "units_limit": SPEECH_UNITS, "tf32_same_bits": tf32,
          "update_peak_extra_bytes": peaks, "srmr_envelope_ms": envelope_ms,
          "srmr_envelope_card_against_host": envelope_diff, "seconds": clock_seconds(clock), "card": card})


def vmaf_video(gen: torch.Generator, videos: int, shape=VMAF_SHAPE, device: str = "cuda"):
    """(preds, target) RGB float32 videos in [0, 1]: a smooth texture (bicubic upsampling
    of a 1/16-scale field plus a finer 1/4-scale layer) panning 2 pixels a frame; the
    distorted copy blurred (3 x 3 box), noisy (std 0.02) and shifted by one pixel."""
    fn = torch.nn.functional
    channels, frames, h, w = shape
    wide = w + 2 * frames
    coarse = torch.rand(videos, channels, h // 16 + 2, wide // 16 + 2, generator=gen, device=device)
    fine = torch.rand(videos, channels, h // 4 + 1, wide // 4 + 1, generator=gen, device=device)
    plane = (0.8 * fn.interpolate(coarse, size=(h, wide), mode="bicubic", align_corners=False)
             + 0.2 * fn.interpolate(fine, size=(h, wide), mode="bilinear", align_corners=False)).clamp(0, 1)
    target = torch.stack([plane[..., 2 * f: 2 * f + w] for f in range(frames)], dim=2)
    flat = target.transpose(1, 2).reshape(videos * frames, channels, h, w)
    blurred = fn.avg_pool2d(fn.pad(flat, (1, 1, 1, 1), mode="replicate"), 3, stride=1)
    blurred = blurred.reshape(videos, frames, channels, h, w).transpose(1, 2)
    noise = torch.randn(target.shape, generator=gen, device=device)
    preds = (blurred.roll(1, dims=-1) + 0.02 * noise).clamp(0, 1)
    return preds.contiguous(), target.contiguous()


def vmaf_model_blob(seed: int = 0, support_vectors: int = 211) -> dict:
    """A libvmaf-format NuSVR model file: v0.6.1's six features, seeded support vectors
    (v0.6.1 holds 211), rescaling, a polynomial score transform and a clip to [0, 100].
    The coefficients are small enough that the scores land inside the clip."""
    rng = np.random.default_rng(seed)
    n = len(V061_FEATURES)
    return {"model_dict": {
        "feature_names": V061_FEATURES, "norm_type": "linear_rescale",
        "slopes": [0.012, *rng.uniform(0.5, 3.0, n).tolist()], "intercepts": [-0.3, *rng.uniform(-2, 0, n).tolist()],
        "model": {"gamma": 0.04, "rho": -0.4, "sv_coef": rng.uniform(-0.02, 0.02, support_vectors).tolist(),
                  "support_vectors": rng.uniform(-1, 1, (support_vectors, n)).tolist()},
        "score_transform": {"p0": 1.7, "p1": 1.72, "p2": -0.007, "out_gte_in": True},
        "score_clip": [0.0, 100.0],
    }}


def dense_dwt_level(x: torch.Tensor) -> tuple:
    """One db2 level through the JAX package's dense ``(m, n)`` matrices (four float32
    matmuls, TF32 off): the other form of ADM's DWT, timed beside the port's."""
    from torchmetrics_tpu_torch.functional.image.utils import _ieee_float32
    from torchmetrics_tpu_torch.functional.video.vmaf import _dwt_pass

    h, w = x.shape[-2:]
    vlo, vhi = (m[0] for m in _dwt_pass(torch.eye(h, device=x.device)[None], 1))
    hlo, hhi = (m[0] for m in _dwt_pass(torch.eye(w, device=x.device)[None], 1))
    with _ieee_float32():
        lo_r, hi_r = torch.matmul(vlo, x), torch.matmul(vhi, x)
        return (torch.matmul(lo_r, hlo.T), torch.matmul(hi_r, hlo.T), torch.matmul(lo_r, hhi.T),
                torch.matmul(hi_r, hhi.T))


def vmaf_phase(card: str) -> None:
    import json as json_module
    import tempfile

    from torchmetrics_tpu_torch.functional.video import vmaf as port_vmaf
    from torchmetrics_tpu_torch.video import VideoMultiMethodAssessmentFusion

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(159)
    updates = VMAF_VIDEOS // VMAF_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        model_path = os.path.join(tmp, "vmaf_seeded.json")
        with open(model_path, "w") as fh:
            json_module.dump(vmaf_model_blob(), fh)
        metric = VideoMultiMethodAssessmentFusion(features=True, model_path=model_path)
        times, first = [], None
        for _ in range(updates):
            batch = vmaf_video(gen, VMAF_BATCH)
            first = first or batch
            times.append(synced_ms(lambda: metric.update(*batch)))
        compute_ms = [synced_ms(lambda: fresh_compute(metric)) for _ in range(2)]
        values = fresh_compute(metric)
        clock.append(("card", time.perf_counter()))
        for key, value in values.items():
            if value.shape != (VMAF_VIDEOS * VMAF_SHAPE[1],) or not bool(torch.isfinite(value).all()):
                raise AssertionError(f"vmaf {key}: {tuple(value.shape)} {summary(value)}")
        preds, target = first
        head = (slice(0, 1), slice(None), slice(0, VMAF_CPU_FRAMES))
        card_features = port_vmaf.vmaf_features(preds[head], target[head])
        cpu_features = port_vmaf.vmaf_features(preds[head].cpu(), target[head].cpu())
        model = port_vmaf.VmafModel.from_file(model_path)
        scores = {"card": model.predict({n: card_features[port_vmaf._canonical_feature_key(n)]
                                         for n in model.feature_names}),
                  "cpu": model.predict({n: cpu_features[port_vmaf._canonical_feature_key(n)]
                                        for n in model.feature_names})}
        clock.append(("cpu", time.perf_counter()))
        worst = hold_units("vmaf", card_features, cpu_features, VMAF_UNITS)
        score_diff = float((scores["card"].cpu() - scores["cpu"]).abs().max())
        if not score_diff <= VMAF_SCORE_ATOL:
            raise AssertionError(f"vmaf: fused scores {score_diff} apart (limit {VMAF_SCORE_ATOL})")
        tf32 = hold_tf32_bits("vmaf", lambda: port_vmaf.vmaf_features(preds, target))
        peak = update_peak_bytes(metric, first)
        reads = host_reads(lambda: metric.update(*first))
        # ADM's DWT: the port's 4-tap form against the JAX package's dense matrices
        luma = port_vmaf.calculate_luma(target).reshape(-1, *VMAF_SHAPE[2:])
        dwt_ms = {"gather": median([synced_ms(lambda: port_vmaf._dwt2_db2(luma)) for _ in range(3)]),
                  "dense": median([synced_ms(lambda: dense_dwt_level(luma)) for _ in range(3)])}
        scale = 2.8 * float(luma.abs().max())
        dwt_diff = max(float((a - b).abs().max()) / scale for a, b in zip(port_vmaf._dwt2_db2(luma),
                                                                           dense_dwt_level(luma)))
        if not dwt_diff <= 8 * UNIT:
            raise AssertionError(f"vmaf: the two DWT forms {dwt_diff / UNIT} units of their sums apart")
        clock.append(("checks", time.perf_counter()))
        emit({"phase": "vmaf", "videos": VMAF_VIDEOS, "shape": list(VMAF_SHAPE), "batch": VMAF_BATCH,
              "updates": updates, "update_ms": {"first": times[0], "median": median(times[1:])},
              "compute_ms_first_second": compute_ms, "values": {k: summary(v) for k, v in values.items()},
              "cpu_frames": VMAF_CPU_FRAMES, "cpu_units": worst, "units_limit": VMAF_UNITS,
              "fused_score_cpu_diff": score_diff, "tf32_same_bits": tf32, "update_peak_extra_bytes": peak,
              "host_reads": reads, "dwt_level0_ms": dwt_ms, "dwt_forms_units": dwt_diff / UNIT,
              "seconds": clock_seconds(clock), "card": card})
        profile_step("vmaf_update", lambda: metric.update(*first))


WMT14_SEGMENTS = 3003  # WMT14 en-de newstest2014: 3,003 segments, one reference each
WMT14_TOKENS = 27  # mean tokens a segment
LIBRI_UTTERANCES = 2620  # LibriSpeech test-clean
LIBRI_WORDS = 20  # mean words an utterance
LIBRI_EDIT_RATE = 0.05  # seeded substitutions, deletions and insertions: a 5% WER system
SQUAD_QUESTIONS = 10570  # SQuAD v1.1 dev: 1-3 answers a question
CNNDM_SUMMARIES = 11490  # CNN/DailyMail test
CNNDM_WORDS = 56  # mean words of a reference summary (3-4 highlights)
TEXT_BATCH = 64  # segments an update
# depth cuts, made when the whole script took 1,122 s with the serving phases (over its
# 1,080 s aim): the first 1,024 of WMT14's 3,003 segments (EED's and TER's host DP took
# 40 s) and 4,096 of SQuAD's 10,570 questions and CNN/DM's 11,490 summaries (ROUGE's LCS
# tables, 17 s); every update is still timed, and the first 128 segments held on the CPU
TEXT_PHASE_SEGMENTS = {"text_mt": 1024, "text_qa_sum": 4096}
TEXT_CPU_BATCHES = 2  # the CPU port replays the first 128 segments of each corpus
ZIPF_WORDS = 20000  # the corpora's vocabulary, drawn by a Zipf law
ZIPF_EXPONENT = 1.1
MT_EDIT_RATE = 0.3  # a hypothesis: its reference under 30% seeded edits and a block move
TEXT_RTOL = 1e-6  # card against CPU: values; the states bit for bit
GPT2_VOCAB = 50257  # GPT-2's published vocabulary and context
GPT2_CONTEXT = 1024
PPL_WINDOWS = 8  # windows an update: 1.65 GB of float32 logits
WIKITEXT103_TEST_TOKENS = 245569
PPL_UPDATES = 30  # 30 x 8 x 1,024 = 245,760 tokens, WikiText-103 test's 245,569 rounded up to whole windows
PPL_IGNORE = -100
PPL_MARGIN = (8.5, 2.5)  # the target logit's lift over N(0, 1) noise: a perplexity of about 20-40, GPT-2's range
PPL_RTOL = 1e-6  # card against CPU on the first window: float32 sums and the value
PPL_BF16_RTOL = 2.0**-7  # two bfloat16 spacings: each log-probability rounds to bfloat16 first
BERT_BASE = {"hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
             "vocab_size": 30522, "max_position_embeddings": 512}  # bert-base-uncased's published config
BERT_LAYERS = 9  # BERTScore's num_layers for the model
WMT16_PAIRS = 2999  # WMT16 newstest2016, to English
BERT_SCORE_BATCH = 64
BERT_CPU_PAIRS = 64
BERT_ATOL = 1e-5  # card against CPU: float32 BERT sums in other orders (TF32 off), cosines of unit vectors
INFOLM_PAIRS = 256
INFOLM_CPU_PAIRS = 8
INFOLM_RTOL = 1e-4  # card against CPU: logits a few units apart, times 4 (temperature 0.25) before the softmax
VOCASET_SEQUENCES = 16  # VOCASET-sized: 4 s at 60 fps of FLAME's 5,023 vertices
VOCASET_FRAMES = 240
FLAME_VERTICES = 5023
LIP_VERTICES = 254  # a seeded lip region; FLAME's mask is not in the repo
LVE_RTOL = 1e-6
BAPPS_PATCH = 64  # BAPPS 2AFC's patches
LPIPS_BATCH = 50
LPIPS_UPDATES = 20  # 1,000 patch pairs a backbone
LPIPS_NETS = ("alex", "vgg", "squeeze")
FULL_SIZE = 256  # LPIPS as a loss and DISTS at 256 x 256
FULL_BATCH = 32
FULL_UPDATES = 8
LPIPS_GRAD_BATCH = 16
LPIPS_CPU_PAIRS = 2
MODEL_ATOL = 1e-5  # card against CPU: float32 backbone sums in other orders (TF32 off), distances below 1
GRAD_F64_RTOL = 2e-5  # the gradient's relative L2 distance from the card's own float64 backward of the same
# forward (the same max-pool picks): on an H100 the sound backward read 7.4e-7 and cuDNN's TF32 backward 5.1e-4,
# so the limit lies between them, 27 times the one and 1/26 of the other
GRAD_RTOL = 1e-2  # the gradient's relative L2 distance from the CPU port's: max-pool windows of smooth images
# hold near-ties, and each device's rounding routes some windows' gradient to another pixel (a ReLU network's
# input gradient is not continuous), so a few entries differ by their whole size; in float64 the two agree to 1e-14.
# On an H100 it read 4.2e-3, with TF32 in the backward only 4.2e-3 (the picks hide it: GRAD_F64_RTOL catches
# it) and with TF32 in the forward too 5.8e-2
KONIQ_SHAPE = (768, 1024)  # KonIQ-10k's 1024 x 768 images, (H, W)
ARNIQA_BATCH = 8
ARNIQA_UPDATES = 16  # 128 images of KonIQ-10k's 2,015 test images
TOY_Z = 512  # the toy generator takes StyleGAN2's latent and gives its 256 x 256 output
TOY_RES = 256
PPL_SAMPLES = 10000  # the metric's default
PPL_BATCH = 64
PPL_RESIZE = 64
PPL_CPU_SAMPLES = 16
PPL_MEDIAN_RTOL = 5e-2  # PPL against the CPU port, of the median distance: a deep float32 generator on two
# devices, then image pairs 1e-4 apart whose LPIPS is divided by 1e-8 (read 1.9e-2 on an H100)
PAIR_LPIPS_RTOL = 3e-3  # the LPIPS of the card's own image pairs against the CPU port's, relative, before the
# division: the CPU tests' PPL tolerance (read 4.9e-4 on an H100)
CLIP_L14 = {  # openai/clip-vit-large-patch14's published config
    "text_config": {"vocab_size": 49408, "hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
                    "num_attention_heads": 12, "max_position_embeddings": 77, "hidden_act": "quick_gelu",
                    "projection_dim": 768},
    "vision_config": {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24,
                      "num_attention_heads": 16, "image_size": 224, "patch_size": 14, "hidden_act": "quick_gelu",
                      "projection_dim": 768},
    "projection_dim": 768,
}
COCO_SHAPE = (480, 640)  # COCO val2017's typical image, (H, W)
COCO_CAPTIONS = 1024  # val2017 has 5,000 images: cut to 16 updates for the time limit, the host's CLIP
# processor taking about 17 ms an image (90 s for the 5,000 on an H100 host)
CLIP_BATCH = 64
CLIP_CPU_PAIRS = 2
CLIP_FEATURE_RTOL = 1e-4  # of the largest feature: ViT-L/14's 24 float32 layers (TF32 off) on two devices
CLIP_SCORE_ATOL = 1e-3  # of 100 x a cosine
CLIP_IQA_IMAGES = 64  # 4 updates: the host's processor takes about 110 ms an image of 1024 x 768
CLIP_IQA_BATCH = 16
CLIP_IQA_PROMPTS = ("quality", "brightness", "sharpness", ("A crisp photo.", "A hazy photo."))
CLIP_PROB_ATOL = 1e-4  # a sigmoid of 100 x the difference of two cosines


@functools.lru_cache(maxsize=None)
def zipf_vocabulary(size: int = ZIPF_WORDS, seed: int = 1601) -> tuple:
    """``size`` distinct lowercase pseudo-words of two to four syllables, from a seed."""
    rng = np.random.default_rng(seed)
    syllables = [a + b for a in "bcdfghjklmnprstvwz" for b in "aeiou"]
    words, seen = [], set()
    while len(words) < size:
        for n, picks in zip(rng.integers(2, 5, size), rng.integers(0, len(syllables), (size, 4))):
            word = "".join(syllables[i] for i in picks[:n])
            if word not in seen and len(words) < size:
                seen.add(word)
                words.append(word)
    return tuple(words)


def zipf_sampler(vocab: list, exponent: float = ZIPF_EXPONENT):
    """``draw(rng, n)``: ``n`` words by a Zipf law over ``vocab``'s order."""
    cdf = np.cumsum(1.0 / np.arange(1, len(vocab) + 1) ** exponent)
    cdf /= cdf[-1]
    return lambda rng, n: [vocab[i] for i in np.searchsorted(cdf, rng.random(n))]


def segment_lengths(rng, count: int, mean: float, shape: float = 3.0, low: int = 1) -> np.ndarray:
    """Gamma-distributed lengths of mean ``mean`` (a corpus's length profile), at least ``low``."""
    return np.maximum(low, np.round(rng.gamma(shape, mean / shape, count))).astype(int)


def seeded_edits(rng, words: list, rate: float, draw) -> list:
    """Each word substituted, deleted or followed by an inserted word with probability
    ``rate / 3`` each."""
    out = []
    for word, roll in zip(words, rng.random(len(words))):
        if roll < rate / 3:
            out.append(draw(rng, 1)[0])
        elif roll < 2 * rate / 3:
            continue
        elif roll < rate:
            out += [word, draw(rng, 1)[0]]
        else:
            out.append(word)
    return out


def written(words: list, rng) -> str:
    """Words as a written sentence: capitalised, a few commas and numbers, a full stop."""
    words = [str(int(rng.integers(1, 2000))) if rng.random() < 0.02 else w for w in words]
    words = [w + "," if rng.random() < 0.05 else w for w in words]
    return (" ".join(words)[:1].upper() + " ".join(words)[1:] + ".") if words else ""


def mt_corpus(segments: int = WMT14_SEGMENTS, seed: int = 1602) -> tuple:
    """WMT14-shaped translation output: references of about 27 tokens and hypotheses
    under seeded edits, a fifth of them with a block of 2-5 words moved (TER's shifts)."""
    rng = np.random.default_rng(seed)
    draw = zipf_sampler(zipf_vocabulary())
    preds, target = [], []
    for n in segment_lengths(rng, segments, WMT14_TOKENS - 1):
        ref = draw(rng, int(n))
        hyp = seeded_edits(rng, ref, MT_EDIT_RATE, draw)
        if rng.random() < 0.2 and len(hyp) > 6:
            size = int(rng.integers(2, 6))
            start = int(rng.integers(0, len(hyp) - size))
            block, rest = hyp[start:start + size], hyp[:start] + hyp[start + size:]
            at = int(rng.integers(0, len(rest) + 1))
            hyp = rest[:at] + block + rest[at:]
        preds.append(written(hyp, rng))
        target.append([written(ref, rng)])
    return preds, target


def asr_corpus(utterances: int = LIBRI_UTTERANCES, seed: int = 1603) -> tuple:
    """LibriSpeech test-clean-shaped transcripts (lowercase words, about 20 an
    utterance) and a recogniser's output at a 5% seeded edit rate."""
    rng = np.random.default_rng(seed)
    draw = zipf_sampler(zipf_vocabulary())
    refs = [draw(rng, int(n)) for n in segment_lengths(rng, utterances, LIBRI_WORDS, low=2)]
    return [" ".join(seeded_edits(rng, ref, LIBRI_EDIT_RATE, draw)) for ref in refs], [" ".join(r) for r in refs]


def squad_corpus(questions: int = SQUAD_QUESTIONS, seed: int = 1604) -> tuple:
    """SQuAD v1.1 dev-shaped answers: 1-3 gold answers of 1-5 words a question; a
    prediction equal to a gold answer (65%, with case and punctuation changed half of
    the time), overlapping one (25%) or another span (10%)."""
    rng = np.random.default_rng(seed)
    draw = zipf_sampler(zipf_vocabulary())
    preds, target = [], []
    for q in range(questions):
        span = draw(rng, int(rng.integers(1, 6)))
        answers = [" ".join(span)]
        for _ in range(int(rng.choice([0, 1, 2], p=[0.3, 0.4, 0.3]))):
            cut = int(rng.integers(0, len(span)))
            answers.append(" ".join(["the"] + span[cut:] if rng.random() < 0.5 else span[: cut + 1]))
        roll = rng.random()
        if roll < 0.65:
            pred = answers[int(rng.integers(0, len(answers)))]
            pred = pred.capitalize() + "." if rng.random() < 0.5 else pred
        elif roll < 0.9:
            pred = " ".join(seeded_edits(rng, span, 0.6, draw))
        else:
            pred = " ".join(draw(rng, int(rng.integers(1, 6))))
        preds.append({"prediction_text": pred, "id": f"q{q}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{q}"})
    return preds, target


def summary_corpus(summaries: int = CNNDM_SUMMARIES, seed: int = 1605) -> tuple:
    """CNN/DailyMail test-shaped summaries: references of about 56 words in 3-4
    highlights, and system summaries sharing about half their words, sentence order
    shuffled."""
    rng = np.random.default_rng(seed)
    draw = zipf_sampler(zipf_vocabulary())
    preds, target = [], []
    for n in segment_lengths(rng, summaries, CNNDM_WORDS, shape=6.0, low=8):
        words = draw(rng, int(n))
        cuts = sorted(rng.choice(np.arange(3, len(words) - 2), size=int(rng.integers(2, 4)), replace=False).tolist())
        ref = [words[a:b] for a, b in zip([0, *cuts], [*cuts, len(words)])]
        hyp = [seeded_edits(rng, s, 0.5, draw) for s in ref]
        hyp = [hyp[i] for i in rng.permutation(len(hyp))]
        target.append(" ".join(written(s, rng) for s in ref))
        preds.append(" ".join(written(s, rng) for s in hyp if s))
    return preds, target


BERT_SPECIALS = ("[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def wordpiece_vocabulary(path: str, words: list, size: int = BERT_BASE["vocab_size"]) -> list:
    """Write a ``vocab.txt`` of ``size`` WordPiece entries in bert-base-uncased's layout
    ([PAD] 0, [unused0-98], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103), then ASCII
    punctuation and digits, their ``##`` continuations, the corpus ``words``, and filler
    pieces up to ``size``. Returns the entries."""
    entries = list(BERT_SPECIALS)
    chars = [c for c in "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~0123456789abcdefghijklmnopqrstuvwxyz"]
    entries += chars + [f"##{c}" for c in chars if c.isalnum()]
    seen = set(entries)
    entries += [w for w in words if not (w in seen or seen.add(w))]
    filler = 0
    while len(entries) < size:
        piece = f"##q{filler}"
        filler += 1
        if piece not in seen:
            seen.add(piece)
            entries.append(piece)
    if len(entries) != size:
        raise ValueError(f"{len(entries)} WordPiece entries do not fit a vocabulary of {size}")
    with open(path, "w") as fh:
        fh.write("\n".join(entries) + "\n")
    return entries


def batches_of_pairs(preds: list, target: list, size: int = TEXT_BATCH) -> list:
    return [(preds[i:i + size], target[i:i + size]) for i in range(0, len(preds), size)]


def text_metrics(phase: str, device=None) -> dict:
    from torchmetrics_tpu_torch import text as tx

    if phase == "text_mt":
        return {"bleu": tx.BLEUScore(device=device), "sacre_bleu_13a": tx.SacreBLEUScore(device=device),
                "sacre_bleu_intl": tx.SacreBLEUScore(tokenize="intl", device=device),
                "sacre_bleu_char": tx.SacreBLEUScore(tokenize="char", device=device),
                "chrf": tx.CHRFScore(n_word_order=0, device=device), "chrf++": tx.CHRFScore(device=device),
                "ter": tx.TranslationEditRate(device=device), "eed": tx.ExtendedEditDistance(device=device)}
    if phase == "text_asr":
        return {"wer": tx.WordErrorRate(device=device), "cer": tx.CharErrorRate(device=device),
                "mer": tx.MatchErrorRate(device=device), "wil": tx.WordInfoLost(device=device),
                "wip": tx.WordInfoPreserved(device=device), "edit_distance": tx.EditDistance(device=device)}
    return {"squad": tx.SQuAD(device=device), "rouge": tx.ROUGEScore(device=device)}


def text_phase_batches(phase: str, segments: int = 0) -> dict:
    """Each metric's update batches (the published corpus sizes, or the first
    ``segments``): the ``text_qa_sum`` phase feeds SQuAD and ROUGE their own corpora."""
    size = {} if not segments else {"text_mt": (segments,), "text_asr": (segments,), "text_qa_sum": (segments,)}[phase]
    if phase == "text_mt":
        return {"*": batches_of_pairs(*mt_corpus(*size))}
    if phase == "text_asr":
        return {"*": batches_of_pairs(*asr_corpus(*size))}
    return {"squad": batches_of_pairs(*squad_corpus(*size)), "rouge": batches_of_pairs(*summary_corpus(*size))}


def run_text(metrics: dict, batches: dict, prefix: int, timed: bool = True) -> dict:
    """Every update of every metric (``timed``: synchronised host clock around each);
    after ``prefix`` updates a clone of each metric, whose states the CPU port is held to."""
    times, snapshots = {}, {}
    for name, metric in metrics.items():
        own = batches.get(name, batches.get("*"))
        times[name] = []
        for i, batch in enumerate(own):
            if i == prefix:
                snapshots[name] = metric.clone()
            times[name].append(synced_ms(lambda: metric.update(*batch)) if timed else metric.update(*batch))
        snapshots.setdefault(name, metric.clone())
    return {"times": times, "snapshots": snapshots}


def text_states(metric) -> dict:
    """A metric's states on the host, list states concatenated."""
    return {k: (torch.cat([t.reshape(-1) for t in v]) if v else torch.zeros(0)).cpu() if isinstance(v, list)
            else v.cpu() for k, v in metric._state.items()}


def hold_text(label: str, got: dict, want: dict) -> dict:
    """Metric by metric: states bit for bit (dtypes and shapes too), values within
    ``TEXT_RTOL`` relative. Returns the largest relative difference of each value."""
    worst = {}
    for name, metric in want.items():
        mine, theirs = text_states(got[name]), text_states(metric)
        for key, value in theirs.items():
            if not same_bits(mine[key], value):
                raise AssertionError(f"{label} {name}: state {key} differs from the CPU port's")
        leaves, ref = tree_leaves(fresh_compute(got[name])), tree_leaves(fresh_compute(metric))
        worst[name] = max(largest_rel_diff(leaves[k], v) for k, v in ref.items())
        if not worst[name] <= TEXT_RTOL:
            raise AssertionError(f"{label} {name}: values {worst[name]} apart relative (limit {TEXT_RTOL})")
    return worst


def text_values(metrics: dict) -> dict:
    return {name: {k: float(v) if v.numel() == 1 else summary(v) for k, v in tree_leaves(fresh_compute(m)).items()}
            for name, m in metrics.items()}


def text_phase(card: str, phase: str) -> None:
    """One of the three string phases: every update on the card (states made there, the
    string work on the host), the first ``TEXT_CPU_BATCHES`` updates replayed by the
    port on the CPU and held, compute ms, and one update of each metric profiled as the
    split between the host's string work and the card."""
    clock = [("start", time.perf_counter())]
    batches = text_phase_batches(phase, TEXT_PHASE_SEGMENTS.get(phase, 0))
    clock.append(("corpus", time.perf_counter()))
    metrics = text_metrics(phase)
    run = run_text(metrics, batches, TEXT_CPU_BATCHES)
    clock.append(("card", time.perf_counter()))
    compute_ms = {name: [synced_ms(lambda: fresh_compute(m)) for _ in range(2)] for name, m in metrics.items()}
    values = text_values(metrics)
    for name, leaves in values.items():
        for key, value in leaves.items():
            if isinstance(value, float) and not math.isfinite(value):
                raise AssertionError(f"{phase} {name} {key}: {value}")
    cpu_metrics = text_metrics(phase, device="cpu")
    head = {k: v[:TEXT_CPU_BATCHES] for k, v in batches.items()}
    run_text(cpu_metrics, head, TEXT_CPU_BATCHES, timed=False)
    clock.append(("cpu", time.perf_counter()))
    worst = hold_text(phase, run["snapshots"], cpu_metrics)
    for name, metric in metrics.items():
        if any(isinstance(v, torch.Tensor) and v.device.type != "cuda" for v in metric._state.values()):
            raise AssertionError(f"{phase} {name}: a tensor state left the card")
    first = {name: batches.get(name, batches.get("*"))[0] for name in metrics}
    events = profile_step(f"{phase}_update", lambda: [m.update(*first[n]) for n, m in metrics.items()])
    segments = {name: sum(len(b[0]) for b in batches.get(name, batches.get("*"))) for name in metrics}
    emit({"phase": phase, "segments": segments, "batch": TEXT_BATCH,
          "reduced": "a prefix of the published corpus" if phase in TEXT_PHASE_SEGMENTS else None,
          "update_ms": {n: {"median": median(t), "sum": sum(t)} for n, t in run["times"].items()},
          "compute_ms_first_second": compute_ms, "values": values, "cpu_segments": TEXT_CPU_BATCHES * TEXT_BATCH,
          "cpu_rel_diff": worst, "rel_limit": TEXT_RTOL, "host_and_card": host_card_split(events),
          "seconds": clock_seconds(clock), "card": card})


def host_card_split(events) -> dict:
    """A profiled step's wall time split into the card's busy time (the union of its
    device spans) and the rest, the host's."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA)
    marks = [e for e in events if e.device_type == DeviceType.CPU]
    wall = (max(e.time_range.end for e in marks) - min(e.time_range.start for e in marks)) if marks else 0.0
    busy, reach = 0.0, -math.inf
    for begin, end in spans:
        busy += max(0.0, end - max(begin, reach))
        reach = max(reach, end)
    return {"wall_ms": wall / 1e3, "card_busy_ms": busy / 1e3, "host_ms": (wall - busy) / 1e3}


def ppl_window(gen: torch.Generator, windows: int = PPL_WINDOWS, context: int = GPT2_CONTEXT,
               vocab: int = GPT2_VOCAB, device: str = "cuda") -> tuple:
    """GPT-2-shaped logits from a seed: float32 ``(windows, context, vocab)`` noise, the
    target token (Zipf-drawn over the vocabulary) raised by a seeded margin, so the
    perplexity is a language model's, not the vocabulary's."""
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    weights = ranks ** -ZIPF_EXPONENT
    target = torch.multinomial(weights.float(), windows * context, replacement=True, generator=gen)
    target = target.reshape(windows, context)
    logits = torch.randn((windows, context, vocab), generator=gen, device=device)
    margin = PPL_MARGIN[0] + PPL_MARGIN[1] * torch.randn((windows, context), generator=gen, device=device)
    logits.scatter_add_(-1, target[..., None], margin[..., None])
    return logits, target


def ppl_metrics(device=None) -> dict:
    from torchmetrics_tpu_torch.text import Perplexity

    return {"float32": Perplexity(device=device), "ignore_index": Perplexity(ignore_index=PPL_IGNORE, device=device),
            "bfloat16": Perplexity(device=device)}


def ppl_inputs(name: str, logits: torch.Tensor, target: torch.Tensor) -> tuple:
    if name == "bfloat16":
        return logits.to(torch.bfloat16), target
    if name == "ignore_index":  # each window's last eighth is padding
        return logits, target.masked_fill(torch.arange(target.shape[-1], device=target.device) >=
                                          target.shape[-1] * 7 // 8, PPL_IGNORE)
    return logits, target


def perplexity_phase(card: str) -> None:
    from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_update

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(1606)
    metrics = ppl_metrics()
    times = {name: [] for name in metrics}
    first = None
    for _ in range(PPL_UPDATES):
        logits, target = ppl_window(gen)
        first = first or (logits[:1].clone(), target[:1].clone())
        for name, metric in metrics.items():
            batch = ppl_inputs(name, logits, target)
            times[name].append(synced_ms(lambda: metric.update(*batch)))
        del logits
    compute_ms = {name: synced_ms(lambda: fresh_compute(m)) for name, m in metrics.items()}
    values = {name: float(fresh_compute(m)) for name, m in metrics.items()}
    clock.append(("card", time.perf_counter()))
    for name, value in values.items():
        if not 1.0 < value < 100.0:
            raise AssertionError(f"perplexity {name}: {value}")
    counts = {name: float(m.count) for name, m in metrics.items()}
    if counts["float32"] != PPL_UPDATES * PPL_WINDOWS * GPT2_CONTEXT:
        raise AssertionError(f"perplexity: counted {counts['float32']} tokens")
    worst = {}
    for name, metric in metrics.items():
        batch = ppl_inputs(name, *first)
        card_total, card_count = _perplexity_update(*batch, metric.ignore_index)
        cpu_total, cpu_count = _perplexity_update(*(x.cpu() for x in batch), metric.ignore_index)
        if not torch.equal(card_count.cpu(), cpu_count):
            raise AssertionError(f"perplexity {name}: counts {int(card_count)} and {int(cpu_count)}")
        worst[name] = largest_rel_diff(card_total.float(), cpu_total.float())
        limit = PPL_BF16_RTOL if name == "bfloat16" else PPL_RTOL
        if not worst[name] <= limit:
            raise AssertionError(f"perplexity {name}: the first window's sum {worst[name]} apart (limit {limit})")
    clock.append(("cpu", time.perf_counter()))
    logits, target = first[0].expand(PPL_WINDOWS, -1, -1).contiguous(), first[1].expand(PPL_WINDOWS, -1).contiguous()
    peak = update_peak_bytes(metrics["float32"], (logits, target))
    reads = host_reads(lambda: metrics["float32"].update(logits, target))
    logits_bytes = logits.numel() * logits.element_size()
    emit({"phase": "perplexity", "windows": PPL_WINDOWS, "context": GPT2_CONTEXT, "vocab": GPT2_VOCAB,
          "updates": PPL_UPDATES, "tokens": PPL_UPDATES * PPL_WINDOWS * GPT2_CONTEXT,
          "logits_bytes_an_update": logits_bytes,
          "update_ms": {n: {"first": t[0], "median": median(t[1:])} for n, t in times.items()},
          "read_bound_ms": logits_bytes / PEAK_BYTES_PER_S * 1e3, "compute_ms": compute_ms, "values": values,
          "counts": counts, "cpu_first_window_rel_diff": worst, "rel_limits": {"float32": PPL_RTOL,
                                                                               "bfloat16": PPL_BF16_RTOL},
          "update_peak_extra_bytes": peak, "host_reads": reads, "seconds": clock_seconds(clock), "card": card})
    profile_step("perplexity_update", lambda: metrics["float32"].update(logits, target))


def write_wordpiece_tokenizer(directory: str, entries: list) -> None:
    """bert-base-uncased's tokenizer pipeline over ``entries`` (lowercasing BERT
    normaliser, BERT pre-tokenizer, WordPiece, ``[CLS] $A [SEP]``) as a ``tokenizers``
    file and a ``BertTokenizer`` config: transformers 4 and 5 load it alike, where 5
    no longer builds a tokenizer from ``vocab.txt`` alone."""
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors

    ids = {token: i for i, token in enumerate(entries)}
    tokenizer = Tokenizer(models.WordPiece(ids, unk_token="[UNK]"))
    tokenizer.normalizer = normalizers.BertNormalizer(lowercase=True)
    tokenizer.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tokenizer.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", ids["[CLS]"]), ("[SEP]", ids["[SEP]"])])
    tokenizer.decoder = decoders.WordPiece()
    tokenizer.save(os.path.join(directory, "tokenizer.json"))
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True, "unk_token": "[UNK]",
                   "sep_token": "[SEP]", "pad_token": "[PAD]", "cls_token": "[CLS]", "mask_token": "[MASK]",
                   "model_max_length": BERT_BASE["max_position_embeddings"]}, fh)


def write_bert(directory: str, words: list, masked_lm: bool, seed: int, config: dict = BERT_BASE) -> str:
    """A seeded ``BertModel`` (or ``BertForMaskedLM``) at ``config`` (bert-base-uncased's
    published one) and its tokenizer over ``wordpiece_vocabulary``, saved to
    ``directory``."""
    from transformers import BertConfig, BertForMaskedLM, BertModel

    os.makedirs(directory, exist_ok=True)
    entries = wordpiece_vocabulary(os.path.join(directory, "vocab.txt"), words, config["vocab_size"])
    write_wordpiece_tokenizer(directory, entries)
    torch.manual_seed(seed)
    (BertForMaskedLM if masked_lm else BertModel)(BertConfig(**config)).save_pretrained(directory)
    return directory


def check_tokenizer(tokenizer, sentences: list) -> int:
    """The tokenizer splits every corpus word into known pieces: no ``[UNK]`` in the
    sentences. Returns their pieces."""
    ids = tokenizer(sentences, padding=True, return_tensors="np")["input_ids"]
    if bool((ids == tokenizer.unk_token_id).any()):
        raise AssertionError("the WordPiece tokenizer gives [UNK] on corpus words")
    return int((ids != tokenizer.pad_token_id).sum())


def attended_tokens(metric) -> int:
    return int(sum(int(m.sum()) for m in metric._state["preds_attention_mask"] + metric._state["target_attention_mask"]))


def bert_score_phase(card: str) -> None:
    import tempfile

    from torchmetrics_tpu_torch.functional.text import bert as port_bert
    from torchmetrics_tpu_torch.text import BERTScore

    clock = [("start", time.perf_counter())]
    preds, target = mt_corpus(WMT16_PAIRS, seed=1607)
    target = [t[0] for t in target]
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_bert(tmp, zipf_vocabulary(), masked_lm=False, seed=1608)
        clock.append(("model", time.perf_counter()))
        out, cpu_rows = {}, BERT_CPU_PAIRS
        for idf in (False, True):
            metric = BERTScore(model_dir, num_layers=BERT_LAYERS, idf=idf, batch_size=BERT_SCORE_BATCH)
            if next(metric._forward.model.parameters()).device.type != "cuda":
                raise AssertionError("bert_score: the HF model is not on the card")
            check_tokenizer(metric.tokenizer, preds[:BERT_SCORE_BATCH] + target[:BERT_SCORE_BATCH])
            update_ms = [synced_ms(lambda: metric.update(preds[i:i + BERT_SCORE_BATCH],
                                                         target[i:i + BERT_SCORE_BATCH]))
                         for i in range(0, len(preds), BERT_SCORE_BATCH)]
            compute_ms = synced_ms(lambda: fresh_compute(metric))
            value = fresh_compute(metric)
            for key, v in value.items():
                if v.shape != (WMT16_PAIRS,) or not bool(torch.isfinite(v).all()) or v.device.type != "cuda":
                    raise AssertionError(f"bert_score {key}: {tuple(v.shape)} {summary(v)} on {v.device}")
                if not 0.0 < float(v.mean()) < 0.999:  # edited pairs: similar, not equal
                    raise AssertionError(f"bert_score idf={idf} {key}: mean {float(v.mean())}")
            parts, embeddings = bert_score_parts(metric)
            cpu = BERTScore(model_dir, num_layers=BERT_LAYERS, idf=idf, batch_size=BERT_SCORE_BATCH,
                            device="cpu")
            cpu.update(preds[:cpu_rows], target[:cpu_rows])
            want = cpu.compute()
            head = BERTScore(model_dir, num_layers=BERT_LAYERS, idf=idf, batch_size=BERT_SCORE_BATCH)
            head.update(preds[:cpu_rows], target[:cpu_rows])
            got = head.compute()
            diff = max(float((got[k].cpu() - want[k]).abs().max()) for k in want)
            if not diff <= BERT_ATOL:
                raise AssertionError(f"bert_score idf={idf}: {diff} from the CPU port (limit {BERT_ATOL})")
            out[f"idf={idf}"] = {"update_ms": {"first": update_ms[0], "median": median(update_ms[1:])},
                                 "compute_ms": compute_ms,
                                 "values": {k: float(v.mean()) for k, v in value.items()},
                                 "cpu_pairs": cpu_rows, "cpu_abs_diff": diff, **parts}
        clock.append(("runs", time.perf_counter()))
        emit({"phase": "bert_score", "pairs": WMT16_PAIRS, "batch": BERT_SCORE_BATCH, "config": BERT_BASE,
              "num_layers": BERT_LAYERS, "tf32": False, "runs": out, "abs_limit": BERT_ATOL,
              "seconds": clock_seconds(clock), "card": card})
        profile_step("bert_score_matching", lambda: port_bert._score_pairs(*embeddings))


def bert_score_parts(metric) -> dict:
    """The compute's two parts on the metric's states: the embedder (tokens/s over the
    attended tokens) and the greedy matching (ms), each timed alone; and the embeddings."""
    from torchmetrics_tpu_torch.functional.text import bert as port_bert

    rows = {side: {key: metric._state[f"{side}_{key}"] for key in ("input_ids", "attention_mask")}
            for side in ("preds", "target")}
    rows = {side: {k: torch.cat(v).cpu().numpy() for k, v in r.items()} for side, r in rows.items()}
    width = max(port_bert._attended_width(r["attention_mask"]) for r in rows.values())
    rows = {side: port_bert._cut(r, width) for side, r in rows.items()}
    lookup = port_bert._idf_weights(rows["target"]["input_ids"], rows["target"]["attention_mask"]) if metric.idf \
        else None
    embeddings = []
    start = time.perf_counter()
    for side in ("preds", "target"):
        embeddings += port_bert._embed(metric._forward, rows[side]["input_ids"], rows[side]["attention_mask"],
                                       metric.idf, lookup, metric.batch_size, metric.device)
    if metric.device.type == "cuda":
        torch.cuda.synchronize()
    embed_s = time.perf_counter() - start
    p_emb, p_scale, t_emb, t_scale = embeddings
    start = time.perf_counter()
    for _ in range(5):
        port_bert._score_pairs(p_emb, p_scale, t_emb, t_scale)
    if metric.device.type == "cuda":
        torch.cuda.synchronize()
    match_ms = (time.perf_counter() - start) / 5 * 1e3
    parts = {"embedder_tokens_per_s": attended_tokens(metric) / embed_s, "embedder_s": embed_s,
             "matching_ms": match_ms, "width": width}
    return parts, (p_emb, p_scale, t_emb, t_scale)


def infolm_phase(card: str) -> None:
    import tempfile

    from torchmetrics_tpu_torch.text import InfoLM

    clock = [("start", time.perf_counter())]
    preds, target = mt_corpus(INFOLM_PAIRS, seed=1607)
    target = [t[0] for t in target]
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_bert(tmp, zipf_vocabulary(), masked_lm=True, seed=1609)
        clock.append(("model", time.perf_counter()))
        metric = InfoLM(model_dir, return_sentence_level_score=True)
        if next(metric._forward.model.parameters()).device.type != "cuda":
            raise AssertionError("infolm: the HF model is not on the card")
        check_tokenizer(metric._tokenizer, preds[:64] + target[:64])
        update_ms = [synced_ms(lambda: metric.update(preds[i:i + 64], target[i:i + 64]))
                     for i in range(0, INFOLM_PAIRS, 64)]
        compute_ms = synced_ms(lambda: fresh_compute(metric))
        mean, scores = fresh_compute(metric)
        if scores.shape != (INFOLM_PAIRS,) or not bool(torch.isfinite(scores).all()) or \
                not bool((scores != 0).all()):
            raise AssertionError(f"infolm: {tuple(scores.shape)} {summary(scores)}")
        clock.append(("card", time.perf_counter()))
        head = InfoLM(model_dir, return_sentence_level_score=True)
        head.update(preds[:INFOLM_CPU_PAIRS], target[:INFOLM_CPU_PAIRS])
        cpu = InfoLM(model_dir, return_sentence_level_score=True, device="cpu")
        cpu.update(preds[:INFOLM_CPU_PAIRS], target[:INFOLM_CPU_PAIRS])
        diff = largest_rel_diff(head.compute()[1], cpu.compute()[1])
        clock.append(("cpu", time.perf_counter()))
        if not diff <= INFOLM_RTOL:
            raise AssertionError(f"infolm: {diff} relative from the CPU port (limit {INFOLM_RTOL})")
        tokens = attended_tokens(metric)
        emit({"phase": "infolm", "pairs": INFOLM_PAIRS, "config": BERT_BASE, "max_length": metric.max_length,
              "attended_tokens": tokens, "update_ms": update_ms, "compute_ms": compute_ms,
              "attended_tokens_per_s": tokens / (compute_ms / 1e3), "value": float(mean), "scores": summary(scores),
              "cpu_pairs": INFOLM_CPU_PAIRS, "cpu_rel_diff": diff, "rel_limit": INFOLM_RTOL,
              "seconds": clock_seconds(clock), "card": card})
        small = InfoLM(model_dir)
        small.update(preds[:8], target[:8])
        profile_step("infolm_compute_8_pairs", lambda: fresh_compute(small))


def vocaset_sequence(gen: torch.Generator, frames: int = VOCASET_FRAMES, vertices: int = FLAME_VERTICES,
                     device: str = "cuda") -> tuple:
    """A talking-head sequence from a seed: a template mesh of unit scale (metres / 10)
    moving smoothly over the frames, and a prediction off by seeded per-vertex drift."""
    template = torch.randn((1, vertices, 3), generator=gen, device=device) * 0.1
    t = torch.linspace(0, 4 * math.pi, frames, device=device)[:, None, None]
    motion = 0.01 * torch.sin(t + torch.rand((1, vertices, 1), generator=gen, device=device) * 6)
    truth = template + motion
    pred = truth + 0.002 * torch.randn((frames, vertices, 3), generator=gen, device=device)
    return pred, truth


def lip_map(seed: int = 1610, vertices: int = FLAME_VERTICES, count: int = LIP_VERTICES) -> list:
    return sorted(np.random.default_rng(seed).choice(vertices, count, replace=False).tolist())


def lve_phase(card: str) -> None:
    from torchmetrics_tpu_torch.multimodal import LipVertexError

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(1611)
    mouth = lip_map()
    metric = LipVertexError(mouth_map=mouth)
    cpu = LipVertexError(mouth_map=mouth, device="cpu")
    times = []
    sequences = [vocaset_sequence(gen) for _ in range(VOCASET_SEQUENCES)]
    for pred, truth in sequences:
        times.append(synced_ms(lambda: metric.update(pred, truth)))
        cpu.update(pred.cpu(), truth.cpu())
    value = fresh_compute(metric)
    clock.append(("runs", time.perf_counter()))
    if not torch.equal(metric.total.cpu(), cpu.total) or metric.total.dtype != torch.int32:
        raise AssertionError(f"lve: total {metric.total} against {cpu.total}")
    diff = largest_rel_diff(metric.sum_lve, cpu.sum_lve)
    if not diff <= LVE_RTOL or metric.sum_lve.dtype != torch.float32 or not 0 < float(value) < 1:
        raise AssertionError(f"lve: sum {diff} apart relative, value {float(value)}")
    reads = host_reads(lambda: metric.update(*sequences[0]))
    emit({"phase": "lve", "sequences": VOCASET_SEQUENCES, "frames": VOCASET_FRAMES, "vertices": FLAME_VERTICES,
          "lip_vertices": LIP_VERTICES, "update_ms": {"first": times[0], "median": median(times[1:])},
          "value": float(value), "cpu_sum_rel_diff": diff, "rel_limit": LVE_RTOL, "host_reads": reads,
          "seconds": clock_seconds(clock), "card": card})
    profile_step("lve_update", lambda: metric.update(*sequences[0]))


def he_features(spec, gen: torch.Generator) -> dict:
    """A seeded torchvision ``features`` state dict for an LPIPS layer spec (He-scaled
    weights, small biases), on the host."""
    sd = {}
    for tv_idx, layer in enumerate(spec):
        if layer[0] == "conv":
            parts = {"": (layer[2], layer[1], layer[3])}
        elif layer[0] == "fire":
            _, c_in, sq, e1, e3 = layer
            parts = {"squeeze.": (sq, c_in, 1), "expand1x1.": (e1, sq, 1), "expand3x3.": (e3, sq, 3)}
        else:
            continue
        for name, (c_out, c_in, k) in parts.items():
            sd[f"{tv_idx}.{name}weight"] = torch.randn((c_out, c_in, k, k), generator=gen) * math.sqrt(2 / (c_in * k * k))
            sd[f"{tv_idx}.{name}bias"] = torch.randn((c_out,), generator=gen) * 0.05
    return sd


def write_lpips_weights(directory: str, net: str, seed: int) -> str:
    """Seeded weights in the published layouts (torchvision's ``features``, the LPIPS
    heads' ``lin{i}.model.1.weight``), written by the port's converter."""
    from torchmetrics_tpu_torch.functional.image.lpips import _NETS, convert_lpips_weights

    spec, _, chns = _NETS[net]
    gen = torch.Generator().manual_seed(seed)
    backbone = he_features(spec, gen)
    heads = {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=gen) * 0.1 for i, c in enumerate(chns)}
    path = os.path.join(directory, f"lpips_{net}.pkl")
    convert_lpips_weights(backbone, heads, net, path)
    return path


def image_pairs(gen: torch.Generator, batch: int, size, low: float = -1.0, device: str = "cuda") -> tuple:
    """Two batches of ``size`` (an int for squares, or ``(H, W)``) images in ``[low, 1]`` on
    the card: smooth seeded content and a distorted copy (noise and a shift of
    brightness), as BAPPS's reference and distortion."""
    size = (size, size) if isinstance(size, int) else tuple(size)
    base = torch.rand((batch, 3, size[0] // 8, size[1] // 8), generator=gen, device=device)
    base = torch.nn.functional.interpolate(base, size=size, mode="bilinear", align_corners=False)
    other = (base + 0.1 * torch.randn(base.shape, generator=gen, device=device) + 0.05).clamp(0, 1)
    return base * (1 - low) + low, other * (1 - low) + low


def model_phase_line(phase: str, times: list, metric, batch: tuple, extra: dict, clock: list) -> None:
    """A model-backed phase's line: update ms (first and the median of the rest), the peak
    bytes and host reads of one more update, and the phase's own keys."""
    peak = update_peak_bytes(metric, batch)
    reads = host_reads(lambda: metric.update(*batch))
    emit({"phase": phase, "update_ms": {"first": times[0], "median": median(times[1:])},
          "update_peak_extra_bytes": peak, "host_reads": reads, **extra, "seconds": clock_seconds(clock)})


def grad_distance(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A gradient's distance from another: relative L2 over the batch, cosine, and the
    worst image's relative L2."""
    got, want = got.double(), want.double()
    per_image = (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    return {"rel_l2": float((got - want).norm() / want.norm()),
            "cosine": float((got * want).sum() / (got.norm() * want.norm())),
            "worst_image_rel_l2": float(per_image.max())}


class _Float64BackwardConv(torch.autograd.Function):
    """``F.conv2d`` in float32 with TF32 off, its input gradient in float64 rounded once:
    the backward of the same forward, so the same ReLU masks and max-pool picks."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, groups):
        from torchmetrics_tpu_torch.functional.image.utils import _ieee_float32

        ctx.save_for_backward(weight)
        ctx.conf = x.shape, stride, padding, groups
        with _ieee_float32():
            return torch.nn.functional.conv2d(x, weight, bias, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, grad):
        (weight,) = ctx.saved_tensors
        shape, stride, padding, groups = ctx.conf
        grad_x = torch.nn.grad.conv2d_input(shape, weight.double(), grad.double(), stride, padding, 1, groups)
        return grad_x.float(), None, None, None, None, None


LPIPS_CONVS = ("float64_backward", "tf32_backward", "tf32_forward_and_backward")


@contextlib.contextmanager
def lpips_conv(kind: str):
    """LPIPS with another conv in place of ``utils.conv2d_full``, and TF32 on in cuDNN and
    cuBLAS (cuDNN's default) for the block: ``float64_backward`` (the reference of the
    sound backward), ``tf32_backward`` (plain ``F.conv2d``, its forward under
    ``_ieee_float32``: the fault ``conv2d_full`` is there to prevent) or
    ``tf32_forward_and_backward`` (plain ``F.conv2d``)."""
    from torchmetrics_tpu_torch.functional.image import lpips as module
    from torchmetrics_tpu_torch.functional.image.utils import _ieee_float32

    def conv(x, weight, bias=None, stride=1, padding=0, groups=1):
        if kind == "float64_backward":
            return _Float64BackwardConv.apply(x, weight, bias, stride, padding, groups)
        if kind == "tf32_forward_and_backward":
            return torch.nn.functional.conv2d(x, weight, bias, stride, padding, 1, groups)
        with _ieee_float32():
            return torch.nn.functional.conv2d(x, weight, bias, stride, padding, 1, groups)

    if kind not in LPIPS_CONVS:
        raise ValueError(kind)
    saved = module.conv2d_full, torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    module.conv2d_full = conv
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        module.conv2d_full, torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def lpips_phase(card: str) -> None:
    import tempfile

    from torchmetrics_tpu_torch.functional.image.lpips import LPIPSNetwork
    from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity as LPIPS

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(1701)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {net: write_lpips_weights(tmp, net, 1702 + i) for i, net in enumerate(LPIPS_NETS)}
        runs = [(net, BAPPS_PATCH, LPIPS_BATCH, LPIPS_UPDATES) for net in LPIPS_NETS]
        runs.append(("vgg", FULL_SIZE, FULL_BATCH, FULL_UPDATES))
        for net, size, batch, updates in runs:
            key = f"{net}_{size}"
            metric = LPIPS(net, weights_path=paths[net])
            batches = [image_pairs(gen, batch, size) for _ in range(updates)]
            times = [synced_ms(lambda: metric.update(*b)) for b in batches]
            value = fresh_compute(metric)
            if not (0 < float(value) < 1) or float(metric.total) != batch * updates:
                raise AssertionError(f"lpips {key}: value {float(value)}, total {float(metric.total)}")
            head = [x[:LPIPS_CPU_PAIRS] for x in batches[0]]
            card_pairs = metric.net(*head)
            cpu_pairs = LPIPSNetwork(net, weights_path=paths[net])(*(x.cpu() for x in head))
            diff = float((card_pairs.cpu() - cpu_pairs).abs().max())
            if not diff <= MODEL_ATOL:
                raise AssertionError(f"lpips {key}: {diff} from the CPU port (limit {MODEL_ATOL})")
            peak = update_peak_bytes(metric, batches[0])
            reads = host_reads(lambda: metric.update(*batches[0]))
            out[key] = {"batch": batch, "updates": updates, "update_ms": {"first": times[0],
                                                                          "median": median(times[1:])},
                        "pairs_per_s": batch / (median(times[1:]) / 1e3), "value": float(value),
                        "cpu_abs_diff": diff, "update_peak_extra_bytes": peak, "host_reads": reads}
            profile_step(f"lpips_{key}_update", lambda: metric.update(*batches[0]))
        clock.append(("updates", time.perf_counter()))
        # the loss use: one forward and backward through vgg at B=16
        loss_metric = LPIPS("vgg", weights_path=paths["vgg"])
        x, y = image_pairs(gen, LPIPS_GRAD_BATCH, FULL_SIZE)

        def backward():
            leaf = x.clone().requires_grad_(True)
            loss_metric(leaf, y).backward()
            return leaf.grad

        grad_times = [synced_ms(backward) for _ in range(3)]
        grad, grad_peak = peak_extra_bytes(backward)
        cpu_leaf = x[:LPIPS_CPU_PAIRS].cpu().requires_grad_(True)
        cpu_net = LPIPSNetwork("vgg", weights_path=paths["vgg"])
        (cpu_net(cpu_leaf, y[:LPIPS_CPU_PAIRS].cpu()).sum() / LPIPS_GRAD_BATCH).backward()
        want = cpu_leaf.grad.double()
        grads = {}
        for kind in LPIPS_CONVS:
            with lpips_conv(kind):
                grads[kind] = backward()
        # against the CPU port (other max-pool picks at near-ties), and against the card's
        # own float64 backward of the same forward (the same picks: only the backward's sums)
        readings = {kind: {"cpu": grad_distance(g[:LPIPS_CPU_PAIRS].cpu(), want),
                           "float64_backward": grad_distance(g, grads["float64_backward"])}
                    for kind, g in (("sound", grad), *((k, grads[k]) for k in LPIPS_CONVS[1:]))}
        clock.append(("backward", time.perf_counter()))
    limits = {"cpu": GRAD_RTOL, "float64_backward": GRAD_F64_RTOL}

    def passes(reading):
        return all(reading[ref]["rel_l2"] <= limit for ref, limit in limits.items())

    backward_line = {"batch": LPIPS_GRAD_BATCH, "size": FULL_SIZE,
                     "ms": {"first": grad_times[0], "median": median(grad_times[1:])},
                     "peak_extra_bytes": grad_peak, "rel_l2": readings, "rel_l2_limits": limits}
    emit({"phase": "lpips", "runs": out, "abs_limit": MODEL_ATOL, "cpu_pairs": LPIPS_CPU_PAIRS,
          "backward_vgg": backward_line, "tf32": False, "seconds": clock_seconds(clock), "card": card})
    if not (passes(readings["sound"]) and bool(torch.isfinite(grad).all())):
        raise AssertionError(f"lpips backward: {readings['sound']} (limits {limits})")
    if any(passes(readings[fault]) for fault in LPIPS_CONVS[1:]):
        raise AssertionError(f"lpips backward: a TF32 gradient passes the limits {limits}: {readings}")
    profile_step("lpips_vgg_backward", backward)


def dists_phase(card: str) -> None:
    import tempfile

    from torchmetrics_tpu_torch.functional.image.dists import DISTSNetwork, convert_dists_weights
    from torchmetrics_tpu_torch.functional.image.lpips import _VGG_SPEC
    from torchmetrics_tpu_torch.image import DeepImageStructureAndTextureSimilarity as DISTS

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(1711)
    host = torch.Generator().manual_seed(1712)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dists.pkl")
        convert_dists_weights(he_features(_VGG_SPEC, host), {"alpha": torch.rand((1, 1475, 1, 1), generator=host) * 0.1,
                                                             "beta": torch.rand((1, 1475, 1, 1), generator=host) * 0.1},
                              path)
        metric = DISTS(weights_path=path)
        batches = [image_pairs(gen, FULL_BATCH, FULL_SIZE, low=0.0) for _ in range(FULL_UPDATES)]
        times = [synced_ms(lambda: metric.update(*b)) for b in batches]
        value = fresh_compute(metric)
        if not (0 < float(value) < 1) or float(metric.total) != FULL_BATCH * FULL_UPDATES:
            raise AssertionError(f"dists: value {float(value)}, total {float(metric.total)}")
        head = [x[:LPIPS_CPU_PAIRS] for x in batches[0]]
        diff = float((metric.net(*head).cpu() - DISTSNetwork(weights_path=path)(*(x.cpu() for x in head))).abs().max())
        if not diff <= MODEL_ATOL:
            raise AssertionError(f"dists: {diff} from the CPU port (limit {MODEL_ATOL})")
        clock.append(("runs", time.perf_counter()))
        model_phase_line("dists", times, metric, batches[0],
                         {"batch": FULL_BATCH, "size": FULL_SIZE, "updates": FULL_UPDATES, "value": float(value),
                          "pairs_per_s": FULL_BATCH / (median(times[1:]) / 1e3), "cpu_pairs": LPIPS_CPU_PAIRS,
                          "cpu_abs_diff": diff, "abs_limit": MODEL_ATOL, "tf32": False}, clock)
        profile_step("dists_update", lambda: metric.update(*batches[0]))


def arniqa_checkpoints(directory: str, seed: int) -> None:
    """A seeded ResNet-50 in the published ARNIQA checkpoint's layout (``model.``-prefixed
    ``nn.Sequential`` indices, a SimCLR projector) and a KonIQ regressor, written to
    ``directory/hub/checkpoints`` where ``TORCH_HOME=directory`` finds them."""
    from torchmetrics_tpu_torch.image._resnet import ResNet50Features

    torch.manual_seed(seed)
    model = ResNet50Features()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.0)
                m.running_var.uniform_(0.5, 2.0)
    names = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6", "layer4": "7"}
    sd = {"model." + ".".join([names[k.split(".")[0]], *k.split(".")[1:]]): v for k, v in model.state_dict().items()}
    sd["projector.0.weight"] = torch.zeros(8, 2048)
    target = os.path.join(directory, "hub", "checkpoints")
    os.makedirs(target, exist_ok=True)
    torch.save(sd, os.path.join(target, "ARNIQA.pth"))
    torch.save({"weights": torch.randn((1, 4096)) * 0.05, "biases": torch.tensor([50.0])},
               os.path.join(target, "regressor_koniq10k.pth"))


def arniqa_phase(card: str) -> None:
    import tempfile

    from torchmetrics_tpu_torch.functional.image import arniqa
    from torchmetrics_tpu_torch.image import ARNIQA

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(1721)
    previous = os.environ.get("TORCH_HOME")
    with tempfile.TemporaryDirectory() as tmp:
        arniqa_checkpoints(tmp, 1722)
        os.environ["TORCH_HOME"] = tmp
        try:
            metric = ARNIQA(reduction="none")
            batches = [image_pairs(gen, ARNIQA_BATCH, KONIQ_SHAPE, low=0.0)[:1] for _ in range(ARNIQA_UPDATES)]
            times = [synced_ms(lambda: metric.update(*b)) for b in batches]
            scores = fresh_compute(metric)
            if scores.shape != (ARNIQA_BATCH * ARNIQA_UPDATES,) or not bool(torch.isfinite(scores).all()):
                raise AssertionError(f"arniqa: {tuple(scores.shape)} {summary(scores)}")
            if metric.num_scores.dtype != torch.int32 or int(metric.num_scores) != scores.numel():
                raise AssertionError(f"arniqa: num_scores {metric.num_scores}")
            head = batches[0][0][:1]
            card_score = arniqa(head, reduction="none")
            cpu_score = arniqa(head.cpu(), reduction="none")
            diff = float((card_score.cpu() - cpu_score).abs().max())
            if not diff <= MODEL_ATOL:
                raise AssertionError(f"arniqa: {diff} from the CPU port (limit {MODEL_ATOL})")
            clock.append(("runs", time.perf_counter()))
            # the metric reads the hub cache at each update, so the line's updates run under it too
            model_phase_line("arniqa", times, metric, batches[0],
                             {"batch": ARNIQA_BATCH, "shape": KONIQ_SHAPE, "updates": ARNIQA_UPDATES,
                              "images_per_s": ARNIQA_BATCH / (median(times[1:]) / 1e3), "scores": summary(scores),
                              "cpu_images": 1, "cpu_abs_diff": diff, "abs_limit": MODEL_ATOL, "tf32": False},
                             clock)
            profile_step("arniqa_update", lambda: metric.update(*batches[0]))
        finally:
            if previous is None:
                os.environ.pop("TORCH_HOME", None)
            else:
                os.environ["TORCH_HOME"] = previous


class ToyGenerator(torch.nn.Module):
    """A seeded toy generator with StyleGAN2's latent (512-d) and output (256 x 256), and
    no more of StyleGAN2: a two-layer mapping to a style, a learned 4 x 4 x 512 constant,
    six doublings (nearest upsampling, one 3 x 3 conv modulated by the style, leaky ReLU)
    whose widths halve from 512 to 16, a 1 x 1 conv to RGB and ``tanh``, scaled to
    [0, 255]. StyleGAN2's own 256 x 256 generator keeps 512 channels to 64 x 64 and runs
    two convs a block, several times this one's work, so the phase times the generator
    and the similarity (resize and LPIPS) of a batch apart. ``sample`` draws latents from a host ``default_rng``, so
    a twin on another device sees the same ones. TF32 is off in its forward: a 1e-4
    latent step is below TF32's rounding."""

    z_size = TOY_Z

    def __init__(self, seed: int) -> None:
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        widths = (512, 512, 256, 128, 64, 32, 16)

        def normal(*shape):
            return torch.nn.Parameter(torch.randn(shape, generator=gen) / math.sqrt(np.prod(shape[1:]) or 1))

        self.mapping = torch.nn.ParameterList([normal(TOY_Z, TOY_Z) for _ in range(2)])
        self.const = torch.nn.Parameter(torch.randn((1, widths[0], 4, 4), generator=gen))
        self.styles = torch.nn.ParameterList([normal(c, TOY_Z) for c in widths[:-1]])
        self.convs = torch.nn.ParameterList([normal(o, c, 3, 3) for c, o in zip(widths[:-1], widths[1:])])
        self.rgb = normal(3, widths[-1], 1, 1)
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def sample(self, num_samples: int) -> torch.Tensor:
        return torch.from_numpy(self._rng.standard_normal((num_samples, TOY_Z)).astype(np.float32))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        from torchmetrics_tpu_torch.functional.image.utils import _ieee_float32

        with _ieee_float32():
            w = z
            for m in self.mapping:
                w = torch.nn.functional.leaky_relu(w @ m.T, 0.2)
            x = self.const.expand(z.shape[0], -1, -1, -1)
            for style, conv in zip(self.styles, self.convs):
                x = x * (1 + w @ style.T)[:, :, None, None]
                x = torch.nn.functional.interpolate(x, scale_factor=2, mode="nearest")
                x = torch.nn.functional.leaky_relu(torch.nn.functional.conv2d(x, conv, padding=1), 0.2)
            return (torch.tanh(torch.nn.functional.conv2d(x, self.rgb)) + 1) * 127.5


def ppl_phase(card: str) -> None:
    import copy
    import tempfile

    from torchmetrics_tpu_torch.functional.image import perceptual_path_length
    from torchmetrics_tpu_torch.functional.image._resize import resize_bilinear_antialias
    from torchmetrics_tpu_torch.functional.image.lpips import LPIPSNetwork
    from torchmetrics_tpu_torch.functional.image.utils import _ieee_float32
    from torchmetrics_tpu_torch.image import PerceptualPathLength

    clock = [("start", time.perf_counter())]
    generator = ToyGenerator(1731).cuda().eval().requires_grad_(False)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_lpips_weights(tmp, "vgg", 1732)
        metric = PerceptualPathLength(num_samples=PPL_SAMPLES, batch_size=PPL_BATCH, resize=PPL_RESIZE,
                                      sim_net="vgg", sim_net_weights_path=path)
        update_ms = synced_ms(lambda: metric.update(generator))
        mean, std, dist = metric.compute()
        if dist.shape != (PPL_SAMPLES,) or not bool(torch.isfinite(dist).all()) or not float(mean) > 0:
            raise AssertionError(f"ppl: {tuple(dist.shape)} {summary(dist)}, mean {float(mean)}")
        clock.append(("card", time.perf_counter()))
        # a prefix against the CPU port: the same latents through a CPU twin of the generator
        kw = {"num_samples": PPL_CPU_SAMPLES, "batch_size": PPL_CPU_SAMPLES, "resize": PPL_RESIZE,
              "sim_net": "vgg", "sim_net_weights_path": path, "lower_discard": None, "upper_discard": None}
        generator.reset()
        cpu_generator = copy.deepcopy(generator).cpu()
        card_dist = perceptual_path_length(generator, **kw)[2]
        cpu_dist = perceptual_path_length(cpu_generator, **kw, device="cpu")[2]
        diff = float((card_dist.cpu() - cpu_dist).abs().max()) / float(cpu_dist.median())
        # the LPIPS of the card's own image pairs, before the division, on the CPU
        generator.reset()
        z1, z2 = generator.sample(4).cuda(), generator.sample(4).cuda()
        images = generator(torch.cat([z1, z1 + (z2 - z1) * 1e-4]))
        images = 2 * (images / 255) - 1
        net = LPIPSNetwork("vgg", weights_path=path)
        card_pairs = net.to("cuda")(images[:4], images[4:])
        cpu_pairs = LPIPSNetwork("vgg", weights_path=path)(images[:4].cpu(), images[4:].cpu())
        pair_diff = float(((card_pairs.cpu() - cpu_pairs).abs() / cpu_pairs.abs()).max())
        clock.append(("cpu", time.perf_counter()))
        if not (diff <= PPL_MEDIAN_RTOL and pair_diff <= PAIR_LPIPS_RTOL):
            raise AssertionError(f"ppl: {diff} of the median (limit {PPL_MEDIAN_RTOL}), pairs {pair_diff} "
                                 f"relative (limit {PAIR_LPIPS_RTOL}) from the CPU port")
        # one batch's time apart: the generator on 2 x 64 latents, then the resize and LPIPS
        z = generator.sample(2 * PPL_BATCH).cuda()
        outputs = 2 * (generator(z) / 255) - 1

        def similarity():
            with _ieee_float32():
                small = resize_bilinear_antialias(outputs, (PPL_RESIZE, PPL_RESIZE))
            return net(small[:PPL_BATCH], small[PPL_BATCH:])

        batch_ms = {"whole": update_ms / math.ceil(PPL_SAMPLES / PPL_BATCH),
                    "generator": median([synced_ms(lambda: generator(z)) for _ in range(5)]),
                    "resize_and_lpips": median([synced_ms(similarity) for _ in range(5)])}
        generator.reset()
        small = PerceptualPathLength(num_samples=PPL_BATCH, batch_size=PPL_BATCH, resize=PPL_RESIZE, sim_net="vgg",
                                     sim_net_weights_path=path)
        peak = update_peak_bytes(small, (generator,))
        reads = host_reads(lambda: small.update(generator))
    emit({"phase": "ppl", "num_samples": PPL_SAMPLES, "batch": PPL_BATCH, "resize": PPL_RESIZE,
          "generator": f"toy, z {TOY_Z}, {TOY_RES}x{TOY_RES}", "batch_ms": batch_ms,
          "update_ms": update_ms, "samples_per_s": PPL_SAMPLES / (update_ms / 1e3),
          "mean": float(mean), "std": float(std), "distances": summary(dist),
          "cpu_samples": PPL_CPU_SAMPLES, "cpu_rel_diff_of_median": diff, "cpu_pair_lpips_rel_diff": pair_diff,
          "rel_limit": PPL_MEDIAN_RTOL, "pair_rel_limit": PAIR_LPIPS_RTOL, "batch_update_peak_extra_bytes": peak,
          "batch_update_host_reads": reads,
          "seconds": clock_seconds(clock), "card": card})
    profile_step("ppl_batch_update", lambda: small.update(generator))


def clip_vocabulary() -> dict:
    """CLIP's byte-pair vocabulary cut to characters: every letter, digit, comma and full
    stop alone and word-final (``</w>``), and the two specials."""
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for c in "abcdefghijklmnopqrstuvwxyz0123456789,.":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    return vocab


def write_clip(directory: str, seed: int, config: dict = CLIP_L14, device: str = "cuda") -> str:
    """A seeded ``CLIPModel`` at openai/clip-vit-large-patch14's published config, drawn on
    the card, and its processor (CLIP's image preprocessing at 224, a BPE tokenizer over
    ``clip_vocabulary`` saved as a ``tokenizers`` file, which transformers 4 and 5 both
    load), written to ``directory``."""
    from transformers import CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPProcessor, CLIPTokenizerFast

    vocab = clip_vocabulary()
    with open(os.path.join(directory, "vocab.json"), "w") as fh:
        json.dump(vocab, fh)
    with open(os.path.join(directory, "merges.txt"), "w") as fh:
        fh.write("#version: 0.2\n")
    tokenizer = CLIPTokenizerFast(os.path.join(directory, "vocab.json"), os.path.join(directory, "merges.txt"))
    processor = CLIPImageProcessor(size={"shortest_edge": 224}, crop_size={"height": 224, "width": 224})
    CLIPProcessor(image_processor=processor, tokenizer=tokenizer).save_pretrained(directory)
    if not os.path.exists(os.path.join(directory, "tokenizer.json")):
        raise AssertionError("clip: the processor wrote no tokenizers file")
    config = {**config, "text_config": {**config["text_config"], "bos_token_id": 0, "eos_token_id": 1,
                                        "pad_token_id": 1}}
    torch.manual_seed(seed)
    with torch.device(device):
        model = CLIPModel(CLIPConfig(**config))
    model.save_pretrained(directory)
    del model
    return directory


def coco_captions(count: int, seed: int) -> list:
    """COCO-caption-sized stand-ins: about 10.5 Zipf-drawn words, written as sentences."""
    rng = np.random.default_rng(seed)
    draw = zipf_sampler(list(zipf_vocabulary()))
    return [written(draw(rng, n), rng) for n in segment_lengths(rng, count, 10.5, low=4)]


def host_images(gen: torch.Generator, batch: int, shape, device: str = "cuda") -> torch.Tensor:
    """uint8 ``(batch, 3, H, W)`` images on the host, drawn on ``device`` (smooth content)."""
    small = torch.rand((batch, 3, shape[0] // 16, shape[1] // 16), generator=gen, device=device)
    big = torch.nn.functional.interpolate(small, size=shape, mode="bilinear", align_corners=False)
    noise = 0.05 * torch.randn(big.shape, generator=gen, device=device)
    return ((big + noise).clamp(0, 1) * 255).to(torch.uint8).cpu()


def check_clip_tokens(metric, texts: list) -> int:
    """No character of ``texts`` is unknown to the tokenizer: ``<|endoftext|>`` (CLIP's
    unknown token) ends each row and appears nowhere else. Returns the tokens."""
    ids, mask = metric.model.tokens(texts)
    unk = metric.model.processor.tokenizer.unk_token_id
    if any(bool((row[m.bool()][1:-1] == unk).any()) for row, m in zip(ids.cpu(), mask.cpu())):
        raise AssertionError("clip: the tokenizer gives an unknown token on caption characters")
    return int(mask.sum())


def clip_feature_diff(card_model, cpu_model, images: list, texts: list) -> dict:
    """The card's pixel values and features against the CPU port's, on the same inputs."""
    out = {"pixel_values_equal": torch.equal(card_model.pixel_values(images).cpu(), cpu_model.pixel_values(images))}
    for kind, call, inputs in (("image", "get_image_features", images), ("text", "get_text_features", texts)):
        got, want = getattr(card_model, call)(inputs).cpu(), getattr(cpu_model, call)(inputs)
        if got.shape != want.shape or got.shape[-1] != CLIP_L14["projection_dim"]:
            raise AssertionError(f"clip {kind} features: {tuple(got.shape)} against {tuple(want.shape)}")
        out[f"{kind}_rel_diff"] = float((got - want).abs().max() / want.abs().max())
    if not out["pixel_values_equal"] or max(out["image_rel_diff"], out["text_rel_diff"]) > CLIP_FEATURE_RTOL:
        raise AssertionError(f"clip: card against the CPU port {out} (limit {CLIP_FEATURE_RTOL})")
    return out


def clip_score_phase(card: str, model_dir: str) -> None:
    from torchmetrics_tpu_torch.functional.multimodal import clip_score
    from torchmetrics_tpu_torch.functional.multimodal.clip_score import _HFClipWrapper
    from torchmetrics_tpu_torch.multimodal import CLIPScore

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(1741)
    captions = coco_captions(COCO_CAPTIONS, 1742)
    metric = CLIPScore(model_dir)
    if next(metric.model.model.parameters()).device.type != "cuda":
        raise AssertionError("clip_score: the HF model is not on the card")
    tokens = check_clip_tokens(metric, captions[:CLIP_BATCH])
    times, first = [], None
    for start in range(0, COCO_CAPTIONS, CLIP_BATCH):
        images = host_images(gen, min(CLIP_BATCH, COCO_CAPTIONS - start), COCO_SHAPE)
        first = images if first is None else first
        times.append(synced_ms(lambda: metric.update(list(images), captions[start:start + CLIP_BATCH])))
    value = fresh_compute(metric)
    if int(metric.n_samples) != COCO_CAPTIONS or metric.n_samples.dtype != torch.int32 or \
            metric.score.dtype != torch.float32 or not 0 <= float(value) <= 100:
        raise AssertionError(f"clip_score: n {metric.n_samples}, score {metric.score}, value {float(value)}")
    clock.append(("image_text", time.perf_counter()))
    pairs = {"text_text": (captions[:CLIP_BATCH], captions[CLIP_BATCH:2 * CLIP_BATCH]),
             "image_image": (list(first), list(host_images(gen, CLIP_BATCH, COCO_SHAPE)))}
    other = {name: {"ms": synced_ms(lambda: clip_score(*p, model_name_or_path=metric.model)),
                    "value": float(clip_score(*p, model_name_or_path=metric.model))} for name, p in pairs.items()}
    head = list(first[:CLIP_CPU_PAIRS]), captions[:CLIP_CPU_PAIRS]
    cpu_model = _HFClipWrapper(model_dir, torch.device("cpu"))
    diffs = clip_feature_diff(metric.model, cpu_model, *head)
    card_head = clip_score(*head, model_name_or_path=metric.model)
    cpu_head = clip_score(*head, model_name_or_path=cpu_model, device="cpu")
    diffs["score_abs_diff"] = float((card_head.cpu() - cpu_head).abs())
    if not diffs["score_abs_diff"] <= CLIP_SCORE_ATOL:
        raise AssertionError(f"clip_score: {diffs['score_abs_diff']} from the CPU port (limit {CLIP_SCORE_ATOL})")
    clock.append(("cpu", time.perf_counter()))
    batch = (list(first), captions[:CLIP_BATCH])
    model_phase_line("clip_score", times, metric, batch,
                     {"pairs": COCO_CAPTIONS, "batch": CLIP_BATCH, "image_shape": COCO_SHAPE, "config": CLIP_L14,
                      "caption_tokens_first_batch": tokens, "value": float(value),
                      "pairs_per_s": CLIP_BATCH / (median(times[1:]) / 1e3), "other_modalities": other,
                      "cpu_pairs": CLIP_CPU_PAIRS, **diffs, "limits": {"feature_rel": CLIP_FEATURE_RTOL,
                                                                      "score_abs": CLIP_SCORE_ATOL},
                      "tf32": False}, clock)
    profile_step("clip_score_update", lambda: metric.update(*batch))


def clip_iqa_phase(card: str, model_dir: str) -> None:
    from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment

    clock = [("start", time.perf_counter())]
    gen = torch.Generator(device="cuda").manual_seed(1751)
    metric = CLIPImageQualityAssessment(model_dir, data_range=255.0, prompts=CLIP_IQA_PROMPTS)
    check_clip_tokens(metric, [t for pair in metric.prompt_pairs for t in pair])
    batches = [host_images(gen, CLIP_IQA_BATCH, KONIQ_SHAPE) for _ in range(CLIP_IQA_IMAGES // CLIP_IQA_BATCH)]
    times = [synced_ms(lambda: metric.update(b)) for b in batches]
    value = fresh_compute(metric)
    if list(value) != ["quality", "brightness", "sharpness", "user_defined_0"]:
        raise AssertionError(f"clip_iqa: keys {list(value)}")
    for name, v in value.items():
        if v.shape != (CLIP_IQA_IMAGES,) or not bool(((v >= 0) & (v <= 1)).all()) or v.device.type != "cuda":
            raise AssertionError(f"clip_iqa {name}: {tuple(v.shape)} {summary(v)} on {v.device}")
    if metric._prompt_anchors().device.type != "cuda":
        raise AssertionError("clip_iqa: the prompt anchors are not on the card")
    clock.append(("card", time.perf_counter()))
    head = batches[0][:CLIP_CPU_PAIRS]
    cpu = CLIPImageQualityAssessment(model_dir, data_range=255.0, prompts=CLIP_IQA_PROMPTS, device="cpu")
    cpu.update(head)
    want = cpu.compute()
    diff = max(float((value[k][:CLIP_CPU_PAIRS].cpu() - want[k]).abs().max()) for k in want)
    if not diff <= CLIP_PROB_ATOL:
        raise AssertionError(f"clip_iqa: {diff} from the CPU port (limit {CLIP_PROB_ATOL})")
    clock.append(("cpu", time.perf_counter()))
    model_phase_line("clip_iqa", times, metric, (batches[0],),
                     {"images": CLIP_IQA_IMAGES, "batch": CLIP_IQA_BATCH, "image_shape": KONIQ_SHAPE,
                      "prompts": [p if isinstance(p, str) else list(p) for p in CLIP_IQA_PROMPTS],
                      "values": {k: float(v.mean()) for k, v in value.items()},
                      "images_per_s": CLIP_IQA_BATCH / (median(times[1:]) / 1e3), "cpu_images": CLIP_CPU_PAIRS,
                      "cpu_abs_diff": diff, "abs_limit": CLIP_PROB_ATOL, "tf32": False}, clock)
    profile_step("clip_iqa_update", lambda: metric.update(batches[0]))


def clip_phases(card: str) -> None:
    """clip_score and clip_iqa on one seeded CLIP ViT-L/14 written once to a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        model_dir = write_clip(tmp, 1740)
        emit({"phase": "clip_model", "config": "openai/clip-vit-large-patch14", "write_s": time.perf_counter() - start,
              "bytes": sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))})
        clip_score_phase(card, model_dir)
        clip_iqa_phase(card, model_dir)


def flagship_forward(cases: dict) -> dict:
    """The 26 sepconv7 launches of one bf16 trunk forward at the flagship's batch: their
    summed times and bound, and their worst error against the plain version."""
    forward = [cases[(torch.bfloat16, FLAGSHIP_FID_IMAGES, c, o, axis)] for c, o, axis in trunk_sepconv_shapes()]
    return {"B": FLAGSHIP_FID_IMAGES, "max_abs_err": max(case["max_abs_err"] for case in forward),
            **{key: sum(case[key] for case in forward) for key in ("ms", "plain_ms", "bound_ms", "library_ms")}}


def main() -> int:
    if sys.argv[1:2] == [SYNC_CHILD_FLAG]:
        return sync_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    aot_child_args = parse_aot_child(sys.argv)
    if aot_child_args is not None:
        return aot_child(*aot_child_args)
    if sys.argv[1:2] == [MAPEVAL_CHILD_FLAG]:
        return mapeval_child(sys.argv[2])
    if sys.argv[1:2] == [CHAOS_CHILD_FLAG]:
        return chaos_child()
    if sys.argv[1:2] == [SOAK_CHILD_FLAG]:
        return soak_child()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    started = time.perf_counter()
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
    device_map = start_mapeval(*map_device_phase(card, preds, target, host_values))
    launches_by_path = {"fid": launches["bfloat16"], "flagship": flagship_phase(card, preds, target, host_values["map"])}
    flagship_two_ranks_phase(card)
    launches_by_path["generative"] = generative_phase(card)
    collection_groups_phase(card)
    launches_by_path["reliability"] = reliability_phase(card)
    launches_by_path["observability"] = observability_phase(card)
    soak_children = start_soak_children()  # the chaos and fleet phases run beside the phases up to theirs
    launches_by_path["aot"] = aot_phase(card, device_map)
    del device_map
    serving_boot = start_serving_boot()  # the serving phase's cold boot runs beside the streaming phase
    try:
        launches_by_path["streaming"] = streaming_phase(card)
    except BaseException:
        serving_boot[1][0].kill()
        serving_boot[1][0].wait()
        shutil.rmtree(serving_boot[0], ignore_errors=True)
        raise
    launches_by_path["serving"] = serving_phase(card, serving_boot)
    quantized_sync_phase(card)
    launches_by_path["fleet"] = chaos_fleet_phases(card, soak_children)
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
    image_quality_phase(card)
    image_quality_3d_phase(card)
    pansharpening_phase(card)
    audio_separation_phase(card)
    speech_quality_phase(card)
    vmaf_phase(card)
    for phase in ("text_mt", "text_asr", "text_qa_sum"):
        text_phase(card, phase)
    perplexity_phase(card)
    bert_score_phase(card)
    infolm_phase(card)
    lve_phase(card)
    models_started = time.perf_counter()
    lpips_phase(card)
    dists_phase(card)
    arniqa_phase(card)
    ppl_phase(card)
    clip_phases(card)
    emit({"phase": "model_backed_phases", "seconds": time.perf_counter() - models_started})
    emit({"phase": "script", "seconds": time.perf_counter() - started})

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
