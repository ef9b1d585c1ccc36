"""The other image metric classes (counterpart of ``torchmetrics_tpu/image/metrics.py``):
UQI, VIF, TotalVariation, SAM, SCC, ERGAS, RASE, RMSE-SW, D_lambda, D_s, QNR and the
model-backed ARNIQA.

States follow the JAX package: the cheap metrics keep float32 sum states and int32
counts; the statistics that do not decompose over batches (UQI and SAM with
``reduction="none"``, ERGAS, RASE, VIF's scores, the pan-sharpening indices) keep cat
states."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..functional.image.d_lambda import _spectral_distortion_index_compute, _spectral_distortion_index_update
from ..functional.image.d_s import _spatial_distortion_index_compute, _spatial_distortion_index_update
from ..functional.image.ergas import _ergas_compute, _ergas_update
from ..functional.image.rase import _rase_over
from ..functional.image.rmse_sw import _rmse_sw_update
from ..functional.image.sam import _sam_compute, _sam_update
from ..functional.image.scc import spatial_correlation_coefficient
from ..functional.image.tv import _total_variation_compute, _total_variation_update
from ..functional.image.uqi import _uqi_compute, _uqi_map, _uqi_update
from ..functional.image.utils import _jax_tensor, _sum64
from ..functional.image.vif import _check_vif_size, _vif_scores
from ..metric import HostMetric, Metric, _to_device

def _zero(dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros((), dtype=dtype)


def _int32(n: int, like: torch.Tensor) -> torch.Tensor:
    """A batch's count as an int32 state, made on the batch's device."""
    return torch.full((), n, dtype=torch.int32, device=like.device)


def _float32(n: float, like: torch.Tensor) -> torch.Tensor:
    """A batch's count as a float32 state, made on the batch's device."""
    return torch.full((), float(n), dtype=torch.float32, device=like.device)


def _check_reduction(reduction: Optional[str]) -> None:
    if reduction not in ("elementwise_mean", "sum", "none", None):
        raise ValueError(
            f"Argument `reduction` must be one of ('elementwise_mean', 'sum', 'none', None), got {reduction}"
        )


class UniversalImageQualityIndex(Metric):
    """UQI. The mean and sum reductions fold into a float32 sum and an int32 count;
    ``reduction="none"`` keeps the images (the output is the per-pixel map).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import UniversalImageQualityIndex
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> metric = UniversalImageQualityIndex(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.0586)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_reduction(reduction)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("sum_uqi", _zero(), dist_reduce_fx="sum")
            self.add_state("numel", _zero(torch.int32), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        preds, target = _uqi_update(preds, target)
        if self.reduction in ("none", None):
            return {"preds": preds, "target": target}
        uqi_map = _uqi_map(preds, target, self.kernel_size, self.sigma)
        return {"sum_uqi": _sum64(uqi_map), "numel": _int32(uqi_map.numel(), uqi_map)}

    def _compute(self, state):
        if self.reduction in ("none", None):
            return _uqi_compute(state["preds"], state["target"], self.kernel_size, self.sigma, self.reduction)
        value = state["sum_uqi"] / state["numel"]
        return value if self.reduction == "elementwise_mean" else state["sum_uqi"]


class VisualInformationFidelity(Metric):
    """VIF; the per-image scores are a cat state.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import VisualInformationFidelity
        >>> preds = (torch.arange(3 * 48 * 48, dtype=torch.float32).reshape(1, 3, 48, 48) * 37 % 97) / 97
        >>> target = (torch.arange(3 * 48 * 48, dtype=torch.float32).reshape(1, 3, 48, 48) * 31 % 89) / 89
        >>> metric = VisualInformationFidelity(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.0013)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (float, int)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` is expected to be a positive float or int, but got {sigma_n_sq}")
        self.sigma_n_sq = sigma_n_sq
        self.add_state("vif_score", default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        # the size check runs before any convolution, as the function's does (the JAX
        # class skips it and scores empty convolutions)
        _check_vif_size(preds, target)
        return {"vif_score": _vif_scores(preds.to(torch.float32), target.to(torch.float32), self.sigma_n_sq)}

    def _compute(self, state):
        return torch.mean(state["vif_score"])


class TotalVariation(Metric):
    """Total variation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import TotalVariation
        >>> preds = (torch.arange(48, dtype=torch.float32).reshape(1, 3, 4, 4) * 37 % 97) / 97
        >>> metric = TotalVariation(device="cpu")
        >>> metric.update(preds)
        >>> metric.compute()
        tensor(34.6289)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        if reduction in (None, "none"):
            self.add_state("score_list", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("score", default=_zero(), dist_reduce_fx="sum")
            self.add_state("num_elements", default=_zero(torch.int32), dist_reduce_fx="sum")

    def _batch_state(self, img):
        score, num_elements = _total_variation_update(img)
        if self.reduction in (None, "none"):
            return {"score_list": score}
        total = _total_variation_compute(score, num_elements, "sum").to(torch.float32)
        return {"score": total, "num_elements": _int32(num_elements, score)}

    def _compute(self, state):
        if self.reduction in (None, "none"):
            return state["score_list"]
        return _total_variation_compute(state["score"], state["num_elements"], self.reduction)


class SpectralAngleMapper(Metric):
    """SAM.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralAngleMapper
        >>> preds = (torch.arange(48, dtype=torch.float32).reshape(1, 3, 4, 4) * 37 % 97) / 97
        >>> target = (torch.arange(48, dtype=torch.float32).reshape(1, 3, 4, 4) * 31 % 89) / 89
        >>> metric = SpectralAngleMapper(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.6083)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_reduction(reduction)
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("sum_sam", _zero(), dist_reduce_fx="sum")
            self.add_state("numel", _zero(torch.int32), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        preds, target = _sam_update(preds, target)
        if self.reduction in ("none", None):
            return {"preds": preds, "target": target}
        sam_map = _sam_compute(preds, target, reduction="none")
        return {"sum_sam": _sum64(sam_map), "numel": _int32(sam_map.numel(), sam_map)}

    def _compute(self, state):
        if self.reduction in ("none", None):
            return _sam_compute(state["preds"], state["target"], self.reduction)
        value = state["sum_sam"] / state["numel"]
        return value if self.reduction == "elementwise_mean" else state["sum_sam"]


class SpatialCorrelationCoefficient(Metric):
    """SCC; two float32 sum states.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpatialCorrelationCoefficient
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> metric = SpatialCorrelationCoefficient(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(-0.0327)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self, high_pass_filter: Optional[torch.Tensor] = None, window_size: int = 8, **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Expected `window_size` to be a positive integer. Got {window_size}.")
        self.hp_filter = high_pass_filter
        self.ws = window_size
        self.add_state("scc_score", default=_zero(), dist_reduce_fx="sum")
        self.add_state("total", default=_zero(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        scores = spatial_correlation_coefficient(preds, target, self.hp_filter, self.ws, reduction="none")
        return {"scc_score": _sum64(scores), "total": _float32(scores.shape[0], scores)}

    def _compute(self, state):
        return state["scc_score"] / state["total"]


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    """ERGAS; cat states of the images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import ErrorRelativeGlobalDimensionlessSynthesis
        >>> preds = (torch.arange(48, dtype=torch.float32).reshape(1, 3, 4, 4) * 37 % 97) / 97
        >>> target = (torch.arange(48, dtype=torch.float32).reshape(1, 3, 4, 4) * 31 % 89) / 89
        >>> metric = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(21.2961)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_reduction(reduction)
        self.ratio = ratio
        self.reduction = reduction
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        preds, target = _ergas_update(preds, target)
        return {"preds": preds, "target": target}

    def _compute(self, state):
        return _ergas_compute(state["preds"], state["target"], self.ratio, self.reduction)


class RelativeAverageSpectralError(Metric):
    """RASE; cat states (the per-window statistic depends on the global target mean).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RelativeAverageSpectralError
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> metric = RelativeAverageSpectralError(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(5315.8857)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
        self.window_size = window_size
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        return {"preds": _jax_tensor(preds), "target": _jax_tensor(target)}

    def _compute(self, state):
        return _rase_over(state["preds"], state["target"], self.window_size)


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    """RMSE-SW; two float32 sum states.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RootMeanSquaredErrorUsingSlidingWindow
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> metric = RootMeanSquaredErrorUsingSlidingWindow(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.4099)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size
        self.add_state("rmse_val_sum", default=_zero(), dist_reduce_fx="sum")
        self.add_state("total_images", default=_zero(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        rmse_val_sum, _, total_images = _rmse_sw_update(
            preds, target, self.window_size, rmse_val_sum=None, rmse_map=None, total_images=None
        )
        return {"rmse_val_sum": rmse_val_sum, "total_images": total_images}

    def _compute(self, state):
        return state["rmse_val_sum"] / state["total_images"]


def _check_pan_reduction(reduction: Optional[str]) -> None:
    if reduction not in ("elementwise_mean", "sum", "none"):
        raise ValueError(
            f"Expected argument `reduction` be one of ('elementwise_mean', 'sum', 'none') but got {reduction}"
        )


def _check_norm_and_window(norm_order: Any, window_size: Any) -> None:
    if not isinstance(norm_order, int) or norm_order <= 0:
        raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
    if not isinstance(window_size, int) or window_size <= 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got window_size: {window_size}.")


class SpectralDistortionIndex(Metric):
    """D_lambda; cat states of the images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralDistortionIndex
        >>> preds = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 37 % 97) / 97
        >>> target = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 31 % 89) / 89
        >>> metric = SpectralDistortionIndex(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.2275)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, p: int = 1, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        _check_pan_reduction(reduction)
        self.reduction = reduction
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target):
        preds, target = _spectral_distortion_index_update(preds, target)
        return {"preds": preds, "target": target}

    def _compute(self, state):
        return _spectral_distortion_index_compute(state["preds"], state["target"], self.p, self.reduction)


class _PanSharpeningStates(Metric):
    """Cat states of the fused images and a ``target`` dict of ``ms``, ``pan`` and, where
    given, ``pan_lr`` (a list that may stay empty)."""

    def _add_pan_states(self) -> None:
        for name in ("preds", "ms", "pan", "pan_lr"):
            self.add_state(name, default=[], dist_reduce_fx="cat")

    def _batch_state(self, preds, target: Dict[str, Any]):
        if "ms" not in target or "pan" not in target:
            raise ValueError(f"Expected `target` to contain keys ms and pan. Got target: {list(target.keys())}")
        moved = {k: _to_device(v, self.device) for k, v in target.items()}
        preds, ms, pan, pan_lr = _spatial_distortion_index_update(preds, moved["ms"], moved["pan"], moved.get("pan_lr"))
        out = {"preds": preds, "ms": ms, "pan": pan}
        if pan_lr is not None:
            out["pan_lr"] = pan_lr
        return out

    @staticmethod
    def _pan_lr(state) -> Optional[torch.Tensor]:
        return state["pan_lr"] if state["pan_lr"].numel() else None


class SpatialDistortionIndex(_PanSharpeningStates):
    """D_s; ``target`` is a dict with ``ms``, ``pan`` and optionally ``pan_lr``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpatialDistortionIndex
        >>> preds = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 37 % 97) / 97
        >>> ms = (torch.arange(3 * 16 * 16, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> pan = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 29 % 83) / 83
        >>> metric = SpatialDistortionIndex(device="cpu")
        >>> metric.update(preds, {"ms": ms, "pan": pan})
        >>> metric.compute()
        tensor(0.0871)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self, norm_order: int = 1, window_size: int = 7, reduction: Optional[str] = "elementwise_mean", **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        _check_norm_and_window(norm_order, window_size)
        self.norm_order = norm_order
        self.window_size = window_size
        _check_pan_reduction(reduction)
        self.reduction = reduction
        self._add_pan_states()

    def _compute(self, state):
        return _spatial_distortion_index_compute(
            state["preds"], state["ms"], state["pan"], self._pan_lr(state), self.norm_order, self.window_size,
            self.reduction,
        )


class QualityWithNoReference(_PanSharpeningStates):
    """QNR = (1 - D_lambda)^alpha * (1 - D_s)^beta over cat states.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import QualityWithNoReference
        >>> preds = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 37 % 97) / 97
        >>> ms = (torch.arange(3 * 16 * 16, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> pan = (torch.arange(3 * 32 * 32, dtype=torch.float32).reshape(1, 3, 32, 32) * 29 % 83) / 83
        >>> metric = QualityWithNoReference(device="cpu")
        >>> metric.update(preds, {"ms": ms, "pan": pan})
        >>> metric.compute()
        tensor(0.4175)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        alpha: float = 1,
        beta: float = 1,
        norm_order: int = 1,
        window_size: int = 7,
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(alpha, (int, float)) or alpha < 0:
            raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
        self.alpha = alpha
        if not isinstance(beta, (int, float)) or beta < 0:
            raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
        self.beta = beta
        _check_norm_and_window(norm_order, window_size)
        self.norm_order = norm_order
        self.window_size = window_size
        _check_pan_reduction(reduction)
        self.reduction = reduction
        self._add_pan_states()

    def _compute(self, state):
        d_lambda = _spectral_distortion_index_compute(state["preds"], state["ms"], self.norm_order, self.reduction)
        d_s = _spatial_distortion_index_compute(
            state["preds"], state["ms"], state["pan"], self._pan_lr(state), self.norm_order, self.window_size,
            self.reduction,
        )
        return (1 - d_lambda) ** self.alpha * (1 - d_s) ** self.beta


class ARNIQA(HostMetric):
    """ARNIQA no-reference quality (counterpart of the JAX package's class): the port's
    ResNet-50 encoder and linear regressor (``functional/image/arniqa.py``) on the
    metric's device; only the trained weights are external (torch-hub cache, explicit
    state dicts or modules, or a custom ``scorer``). States as the JAX class keeps them:
    a float32 ``sum_scores`` (its ``np.zeros(())`` default held as ``jnp.asarray`` holds
    it with 64-bit types off), an int32 ``num_scores`` and, only under
    ``reduction="none"``, the per-image ``scores``."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        regressor_dataset: str = "koniq10k",
        reduction: str = "mean",
        normalize: bool = True,
        autocast: bool = False,
        scorer: Optional[Callable] = None,
        encoder_weights: Optional[Any] = None,
        regressor_weights: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        from ..functional.image.arniqa import _REGRESSOR_DATASETS

        super().__init__(**kwargs)
        if regressor_dataset not in _REGRESSOR_DATASETS:
            raise ValueError(
                f"Argument `regressor_dataset` must be one of ('kadid10k', 'koniq10k'), but got {regressor_dataset}"
            )
        if reduction not in ("mean", "sum", "none"):
            raise ValueError(f"Argument `reduction` must be one of ('mean', 'sum', 'none'), but got {reduction}")
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.regressor_dataset = regressor_dataset
        self.reduction = reduction
        self.normalize = normalize
        self.scorer = scorer
        self.encoder_weights = encoder_weights
        self.regressor_weights = regressor_weights
        self.add_state("sum_scores", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("num_scores", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        if reduction == "none":
            # unbounded per-image state only when the caller actually wants it
            self.add_state("scores", default=[], dist_reduce_fx="cat")

    def _host_batch_state(self, img) -> Dict[str, Any]:
        from ..functional.image.arniqa import arniqa

        scores = arniqa(
            img, self.regressor_dataset, reduction="none", normalize=self.normalize,
            scorer=self.scorer, encoder_weights=self.encoder_weights, regressor_weights=self.regressor_weights,
        ).reshape(-1)
        state = {"sum_scores": scores.sum(),
                 "num_scores": torch.full((), scores.numel(), dtype=torch.int32, device=scores.device)}
        if self.reduction == "none":
            state["scores"] = scores
        return state

    def _compute(self, state):
        if self.reduction == "mean":
            return state["sum_scores"] / state["num_scores"]
        if self.reduction == "sum":
            return state["sum_scores"]
        return state["scores"]
