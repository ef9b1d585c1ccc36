"""SSIM and MS-SSIM metric classes (counterpart of ``torchmetrics_tpu/image/ssim.py``).

With a mean or sum reduction the states are two float32 sums; with ``reduction="none"``
the per-image scores are a cat state, as in the JAX package."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from ..functional.image.ssim import _multiscale_ssim_update, _ssim_check_inputs, _ssim_update
from ..functional.image.utils import _sum64
from ..metric import Metric
from .metrics import _float32


class StructuralSimilarityIndexMeasure(Metric):
    """SSIM over NCHW or NCDHW batches.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import StructuralSimilarityIndexMeasure
        >>> preds = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 37 % 97) / 97
        >>> target = (torch.arange(768, dtype=torch.float32).reshape(1, 3, 16, 16) * 31 % 89) / 89
        >>> metric = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(-0.0258)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_reduction = ("elementwise_mean", "sum", "none", None)
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        if reduction in ("elementwise_mean", "sum"):
            self.add_state("similarity", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        else:
            self.add_state("similarity", default=[], dist_reduce_fx="cat")
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        if return_contrast_sensitivity or return_full_image:
            self.add_state("image_return", default=[], dist_reduce_fx="cat")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def _prepare_inputs(self, preds, target):
        return _ssim_check_inputs(preds, target), {}

    def _batch_state(self, preds, target):
        pack = _ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size,
            self.data_range, self.k1, self.k2, self.return_full_image, self.return_contrast_sensitivity,
        )
        similarity, image = pack if isinstance(pack, tuple) else (pack, None)
        out = {"similarity": _sum64(similarity) if self.reduction in ("elementwise_mean", "sum") else similarity,
               "total": _float32(preds.shape[0], preds)}
        if image is not None:
            out["image_return"] = image
        return out

    def _compute(self, state):
        similarity = state["similarity"]
        if self.reduction == "elementwise_mean":
            similarity = similarity / state["total"]
        if self.return_contrast_sensitivity or self.return_full_image:
            return similarity, state["image_return"]
        return similarity


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """MS-SSIM, with SSIM's reduction-dependent states.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure
        >>> preds = (torch.arange(3 * 180 * 180, dtype=torch.float32).reshape(1, 3, 180, 180) * 37 % 97) / 97
        >>> target = (torch.arange(3 * 180 * 180, dtype=torch.float32).reshape(1, 3, 180, 180) * 31 % 89) / 89
        >>> metric = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.1403)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_reduction = ("elementwise_mean", "sum", "none", None)
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        if reduction in ("elementwise_mean", "sum"):
            self.add_state("similarity", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        else:
            self.add_state("similarity", default=[], dist_reduce_fx="cat")
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        if not (isinstance(kernel_size, (Sequence, int))):
            raise ValueError(
                f"Argument `kernel_size` expected to be an sequence or an int, or a single int. Got {kernel_size}"
            )
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be of a tuple of floats")
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None`, `relu` or `simple`")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize

    def _prepare_inputs(self, preds, target):
        return _ssim_check_inputs(preds, target), {}

    def _batch_state(self, preds, target):
        similarity = _multiscale_ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size,
            self.data_range, self.k1, self.k2, self.betas, self.normalize,
        )
        if self.reduction in ("elementwise_mean", "sum"):
            similarity = _sum64(similarity)
        return {"similarity": similarity, "total": _float32(preds.shape[0], preds)}

    def _compute(self, state):
        if self.reduction == "elementwise_mean":
            return state["similarity"] / state["total"]
        return state["similarity"]
