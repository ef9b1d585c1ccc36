"""Audio metric classes (counterpart of ``torchmetrics_tpu/audio/metrics.py``).

Every metric is a running mean of per-sample scores: a float32 ``score_sum`` and an
int32 ``total``, under the JAX package's names, so checkpoints cross over. The five
tensor-math metrics are ``Metric``s; SDR, PIT and the metrics backed by host code or a
model are ``HostMetric``s, as in the JAX package (``_jittable_compute`` False). DNSMOS
and NISQA keep one sum per score dimension, ``score_sum`` of shape ``(4,)`` or ``(5,)``
from the start. (The JAX package starts it as a scalar that the first update
broadcasts, so its checkpoint of an updated metric does not restore into a fresh one
there; here it does, and into the port.)
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..functional.audio.dnsmos import _ONNXRUNTIME_AVAILABLE, deep_noise_suppression_mean_opinion_score
from ..functional.audio.external import (
    _PESQ_AVAILABLE,
    _PYSTOI_AVAILABLE,
    perceptual_evaluation_speech_quality,
    short_time_objective_intelligibility,
)
from ..functional.audio.nisqa import ensure_checkpoint_exists, non_intrusive_speech_quality_assessment
from ..functional.audio.pit import permutation_invariant_training
from ..functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from ..functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from ..functional.audio.srmr import _srmr_arg_validate, speech_reverberation_modulation_energy_ratio
from ..metric import HostMetric, Metric
from ..utilities.compute import _float32_sum

# the port's own ``Metric`` keywords: PIT passes every other keyword to ``metric_func``
_METRIC_KEYWORDS = ("device", "compute_on_cpu", "compute_with_cache", "dist_sync_on_step", "process_group",
                    "dist_sync_fn", "distributed_available_fn", "sync_on_compute")


def _mean_states(metric: Metric, dims: int = 0) -> None:
    shape = (dims,) if dims else ()
    metric.add_state("score_sum", default=torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum")
    metric.add_state("total", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")


def _mean_batch(score: torch.Tensor, dims: int = 0) -> dict:
    """A batch's sum and count; with ``dims`` the sum keeps the score's last axis."""
    if dims:
        score = score.reshape(-1, dims)
        return {"score_sum": _float32_sum(score, 0), "total": torch.full((), score.shape[0], dtype=torch.int32,
                                                                           device=score.device)}
    return {"score_sum": _float32_sum(score), "total": torch.full((), score.numel(), dtype=torch.int32,
                                                                  device=score.device)}


class _MeanAudioMetric(Metric):
    """Running mean of a per-sample audio score."""

    full_state_update = False
    is_differentiable = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _mean_states(self)

    def _score(self, preds, target) -> torch.Tensor:
        raise NotImplementedError

    def _batch_state(self, preds, target):
        return _mean_batch(self._score(preds, target))

    def _compute(self, state):
        return state["score_sum"] / state["total"]


class SignalNoiseRatio(_MeanAudioMetric):
    """SNR.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SignalNoiseRatio
        >>> metric = SignalNoiseRatio(device="cpu")
        >>> metric.update(torch.tensor([2.8, -1.2, 0.06, 1.3]), torch.tensor([3.0, -0.5, 0.1, 1.0]))
        >>> metric.compute()
        tensor(12.1764)
    """

    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _score(self, preds, target):
        return signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)


class ScaleInvariantSignalNoiseRatio(_MeanAudioMetric):
    """SI-SNR.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ScaleInvariantSignalNoiseRatio
        >>> metric = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> metric.update(torch.tensor([2.8, -1.2, 0.06, 1.3]), torch.tensor([3.0, -0.5, 0.1, 1.0]))
        >>> metric.compute()
        tensor(12.5348)
    """

    higher_is_better = True

    def _score(self, preds, target):
        return scale_invariant_signal_noise_ratio(preds=preds, target=target)


class ComplexScaleInvariantSignalNoiseRatio(_MeanAudioMetric):
    """C-SI-SNR.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ComplexScaleInvariantSignalNoiseRatio
        >>> t = torch.arange(48.0).reshape(4, 12)
        >>> metric = ComplexScaleInvariantSignalNoiseRatio(device="cpu")
        >>> metric.update(torch.stack([t.sin(), t.cos()], -1)[None], torch.stack([t.cos(), t.sin()], -1)[None])
        >>> metric.compute()
        tensor(-52.5751)
    """

    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean

    def _score(self, preds, target):
        return complex_scale_invariant_signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)


class ScaleInvariantSignalDistortionRatio(_MeanAudioMetric):
    """SI-SDR.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ScaleInvariantSignalDistortionRatio
        >>> metric = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> metric.update(torch.tensor([2.8, -1.2, 0.06, 1.3]), torch.tensor([3.0, -0.5, 0.1, 1.0]))
        >>> metric.compute()
        tensor(12.2167)
    """

    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _score(self, preds, target):
        return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)


class SourceAggregatedSignalDistortionRatio(_MeanAudioMetric):
    """SA-SDR.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SourceAggregatedSignalDistortionRatio
        >>> t = torch.arange(100.0)
        >>> metric = SourceAggregatedSignalDistortionRatio(device="cpu")
        >>> preds = torch.stack([(t / 9).sin(), (t / 7).cos()])[None]
        >>> metric.update(preds, torch.stack([(t / 10).sin(), (t / 8).cos()])[None])
        >>> metric.compute()
        tensor(-0.4277)
    """

    higher_is_better = True

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.scale_invariant = scale_invariant
        self.zero_mean = zero_mean

    def _score(self, preds, target):
        return source_aggregated_signal_distortion_ratio(
            preds=preds, target=target, scale_invariant=self.scale_invariant, zero_mean=self.zero_mean
        )


class _HostMeanAudioMetric(HostMetric):
    """Running mean of a per-sample audio score whose function is host code, or whose
    per-sample dimensions (DNSMOS, NISQA) are kept."""

    full_state_update = False
    is_differentiable = False
    _score_dims = 0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _mean_states(self, self._score_dims)

    def _score(self, preds, target=None) -> torch.Tensor:
        raise NotImplementedError

    def _host_batch_state(self, preds, target=None):
        score = self._score(preds, target) if target is not None else self._score(preds)
        return _mean_batch(score, self._score_dims)

    def _compute(self, state):
        return state["score_sum"] / state["total"]


class SignalDistortionRatio(_HostMeanAudioMetric):
    """SDR: each sample's Toeplitz system solved in float64 on the metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SignalDistortionRatio
        >>> preds = torch.sin(torch.arange(800, dtype=torch.float32) / 20)
        >>> target = torch.sin(torch.arange(800, dtype=torch.float32) / 20 + 0.1)
        >>> metric = SignalDistortionRatio(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(32.2147)
    """

    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def _score(self, preds, target):
        return signal_distortion_ratio(preds, target, self.use_cg_iter, self.filter_length, self.zero_mean,
                                       self.load_diag)


class PermutationInvariantTraining(_HostMeanAudioMetric):
    """PIT: mean of the best-permutation metric. Keywords that are not the port's
    ``Metric`` keywords go to ``metric_func``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import PermutationInvariantTraining
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> t = torch.arange(100.0)
        >>> metric = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, eval_func="max", device="cpu")
        >>> preds = torch.stack([(t / 9).sin(), (t / 7).cos()])[None]
        >>> metric.update(preds, torch.stack([(t / 8).cos(), (t / 10).sin()])[None])
        >>> metric.compute()
        tensor(-0.1867)
    """

    higher_is_better = True

    def __init__(
        self,
        metric_func: Callable,
        mode: str = "speaker-wise",
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in _METRIC_KEYWORDS}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        if mode not in ("speaker-wise", "permutation-wise"):
            raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.kwargs = kwargs

    def _score(self, preds, target):
        best_metric, _ = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.kwargs
        )
        return best_metric

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, id(self)))


class PerceptualEvaluationSpeechQuality(_HostMeanAudioMetric):
    """PESQ through the ``pesq`` wheel on the host."""

    higher_is_better = True
    plot_lower_bound = -0.5
    plot_upper_bound = 4.5

    def __init__(self, fs: int, mode: str, n_processes: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PESQ metric requires that pesq is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pesq`."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.fs = fs
        self.mode = mode
        self.n_processes = n_processes

    def _score(self, preds, target):
        return perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, n_processes=self.n_processes)


class ShortTimeObjectiveIntelligibility(_HostMeanAudioMetric):
    """STOI through ``pystoi`` on the host."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PYSTOI_AVAILABLE:
            raise ModuleNotFoundError(
                "STOI metric requires that `pystoi` is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pystoi`."
            )
        self.fs = fs
        self.extended = extended

    def _score(self, preds, target):
        return short_time_objective_intelligibility(preds, target, self.fs, self.extended)


class SpeechReverberationModulationEnergyRatio(_HostMeanAudioMetric):
    """SRMR: the in-tree gammatone and modulation filterbank pipeline
    (``functional/audio/srmr.py``); no optional wheel.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio
        >>> wave = torch.sin(torch.arange(8000, dtype=torch.float64) / 8) * torch.cos(torch.arange(8000) / 500)
        >>> metric = SpeechReverberationModulationEnergyRatio(8000, device="cpu")
        >>> metric.update(wave)
        >>> metric.compute()
        tensor(72.4991)
    """

    higher_is_better = True

    def __init__(
        self,
        fs: int,
        n_cochlear_filters: int = 23,
        low_freq: float = 125,
        min_cf: float = 4,
        max_cf: Optional[float] = None,
        norm: bool = False,
        fast: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
        self.fs = fs
        self.n_cochlear_filters = n_cochlear_filters
        self.low_freq = low_freq
        self.min_cf = min_cf
        self.max_cf = max_cf
        self.norm = norm
        self.fast = fast

    def _score(self, preds, target=None):
        return speech_reverberation_modulation_energy_ratio(
            preds, self.fs, self.n_cochlear_filters, self.low_freq, self.min_cf, self.max_cf, self.norm, self.fast,
        )


class DeepNoiseSuppressionMeanOpinionScore(_HostMeanAudioMetric):
    """DNSMOS: the in-tree feature pipeline (``functional/audio/dnsmos.py``); the
    DNS-Challenge ONNX models through onnxruntime, or ``infer_fns``. ``device`` is the
    metric's device, as for every metric of the port; ``score_sum`` keeps the four
    dimensions [p808, sig, bak, ovr].

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import DeepNoiseSuppressionMeanOpinionScore
        >>> p808 = lambda mel: mel.mean(dim=(1, 2))[:, None]
        >>> sig_bak_ovr = lambda audio: audio.abs().mean(1, keepdim=True).repeat(1, 3) + 3
        >>> metric = DeepNoiseSuppressionMeanOpinionScore(16000, False, device="cpu", infer_fns=(p808, sig_bak_ovr))
        >>> metric.update(torch.sin(torch.arange(16000.0) / 7)[None])
        >>> metric.compute()
        tensor([-0.7991,  3.3344,  3.7145,  3.2077])
    """

    higher_is_better = True
    _score_dims = 4

    def __init__(
        self,
        fs: int,
        personalized: bool,
        device: Optional[str] = None,
        num_threads: Optional[int] = None,
        cache_session: bool = True,
        infer_fns: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        if infer_fns is None and not _ONNXRUNTIME_AVAILABLE:
            raise ModuleNotFoundError(
                "DNSMOS metric requires that onnxruntime is installed."
                " Install as `pip install onnxruntime`, or pass `infer_fns`."
            )
        self.fs = fs
        self.personalized = personalized
        self.num_threads = num_threads
        self.cache_session = cache_session
        self.infer_fns = infer_fns

    def _score(self, preds, target=None):
        return deep_noise_suppression_mean_opinion_score(
            preds, self.fs, self.personalized, num_threads=self.num_threads,
            cache_session=self.cache_session, infer_fns=self.infer_fns,
        )


class NonIntrusiveSpeechQualityAssessment(_HostMeanAudioMetric):
    """NISQA: the in-tree melspec and model (``functional/audio/nisqa.py``) over the
    published ``nisqa.tar`` checkpoint; ``score_sum`` keeps the five dimensions [mos,
    noi, dis, col, loud]."""

    higher_is_better = True
    _score_dims = 5

    def __init__(self, fs: int, checkpoint_path: Optional[str] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        ensure_checkpoint_exists(checkpoint_path)
        self.fs = fs
        self.checkpoint_path = checkpoint_path

    def _score(self, preds, target=None):
        return non_intrusive_speech_quality_assessment(preds, self.fs, self.checkpoint_path)
