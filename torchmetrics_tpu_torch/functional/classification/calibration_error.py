"""Calibration error, ECE (counterpart of
``torchmetrics_tpu/functional/classification/calibration_error.py``).

As in the JAX package, the state is each bin's sufficient statistics, ``(n_bins + 1,)``
float32 sums of the weights, the confidences and the accuracies, so the value is the
same as binning every confidence at compute time. The bin edges are ``jnp.linspace``'s
bits, which are neither ``torch.linspace``'s nor ``np.linspace``'s: ``i * float32(1 /
n_bins)``, the last edge exactly 1 (XLA turns the division by ``n_bins`` into that
product). A confidence on an edge falls in the bin that edge opens.

The bin sums are accumulated in float64 and rounded once to float32: a sum's order
(the card's atomic adds, the CPU's loop) then moves only the float64's last bits, so
the card and the CPU give the same float32 sums. The weight and accuracy sums hold
integers and equal the JAX package's float32 sums bit for bit; the confidence sums lie
within the float32 rounding of the JAX package's sequential sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...utilities.checks import _as_tensor
from ...utilities.compute import _safe_divide, normalize_logits_if_needed
from ...utilities.enums import ClassificationTaskNoMultilabel
from .precision_recall_curve import _binary_precision_recall_curve_tensor_validation
from .stat_scores import _ignore_weights, _multiclass_stat_scores_tensor_validation


def _bin_boundaries(n_bins: int, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n_bins + 1, dtype=float32)`` bit for bit."""
    edges = np.arange(n_bins + 1, dtype=np.float32) * np.float32(1 / n_bins)
    edges[-1] = 1.0
    return torch.from_numpy(edges).to(device)


def _binned_stats_update(
    confidences: torch.Tensor, accuracies: torch.Tensor, n_bins: int, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-bin sums ``(conf_bin, acc_bin, count_bin)``, each float32 ``(n_bins + 1,)``:
    a confidence goes to the last edge at or below it (1.0 to the extra bin ``n_bins``,
    NaN to it too, as ``searchsorted`` puts NaN past every edge)."""
    boundaries = _bin_boundaries(n_bins, confidences.device)
    n = boundaries.numel()
    w = torch.ones(confidences.shape, dtype=torch.float64, device=confidences.device) if weights is None \
        else weights.to(torch.float64)
    index = (torch.searchsorted(boundaries, confidences.contiguous(), right=True) - 1).clamp(0, n - 1)

    def segment_sum(values: torch.Tensor) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.float64, device=values.device).index_add_(0, index, values).to(torch.float32)

    return (segment_sum(w * confidences.to(torch.float64)), segment_sum(w * accuracies.to(torch.float64)),
            segment_sum(w))


def _ce_compute_from_bins(conf_bin: torch.Tensor, acc_bin: torch.Tensor, count_bin: torch.Tensor,
                          norm: str = "l1") -> torch.Tensor:
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
    acc_rate = _safe_divide(acc_bin, count_bin)
    conf_rate = _safe_divide(conf_bin, count_bin)
    prop_bin = _safe_divide(count_bin, count_bin.sum())
    if norm == "l1":
        return ((acc_rate - conf_rate).abs() * prop_bin).sum()
    if norm == "max":
        return ((acc_rate - conf_rate).abs() * (prop_bin > 0)).max()
    ce = ((acc_rate - conf_rate).square() * prop_bin).sum()
    return torch.where(ce > 0, ce.sqrt(), ce)


def _binary_calibration_error_arg_validation(n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None) -> None:
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Expected argument `norm` to be one of 'l1', 'l2' or 'max' but got {norm}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_calibration_error_tensor_validation(preds: torch.Tensor, target: torch.Tensor,
                                                ignore_index: Optional[int] = None) -> None:
    _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)


def _binary_calibration_error_format(preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None):
    """-> (float32 confidences after one batch-wide sigmoid when needed, int32 targets,
    float32 weights), flat."""
    preds = normalize_logits_if_needed(preds.reshape(-1).to(torch.float32), "sigmoid")
    target, w = _ignore_weights(target.reshape(-1), ignore_index)
    return preds, target.to(torch.int32), w.to(torch.float32)


def _binary_calibration_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return preds, target  # confidences, accuracies


def binary_calibration_error(
    preds, target, n_bins: int = 15, norm: str = "l1", ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary calibration error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_calibration_error
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_calibration_error(preds, target, n_bins=3)
        tensor(0.1950)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_calibration_error_tensor_validation(preds, target, ignore_index)
    preds, target, w = _binary_calibration_error_format(preds, target, ignore_index)
    return _ce_compute_from_bins(*_binned_stats_update(preds, target, n_bins, w), norm)


def _multiclass_calibration_error_arg_validation(
    num_classes: int, n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)


def _multiclass_calibration_error_format(preds: torch.Tensor, target: torch.Tensor, num_classes: int,
                                         ignore_index: Optional[int] = None):
    """-> (``(N, C)`` float32 scores after one batch-wide softmax when needed, targets
    clipped into the classes, float32 weights)."""
    preds = normalize_logits_if_needed(preds.to(torch.float32), "softmax")
    target, w = _ignore_weights(target.reshape(-1), ignore_index)
    return preds, target.clamp(0, num_classes - 1), w.to(torch.float32)


def _multiclass_calibration_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-label confidence and correctness (the first maximum on a tie)."""
    confidences, predicted = preds.max(dim=1)
    return confidences, (predicted == target).to(torch.int32)


def multiclass_calibration_error(
    preds, target, num_classes: int, n_bins: int = 15, norm: str = "l1", ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass calibration error of the top-label confidence.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_calibration_error
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_calibration_error(preds, target, num_classes=3, n_bins=3)
        tensor(0.3875)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)
    preds, target, w = _multiclass_calibration_error_format(preds, target, num_classes, ignore_index)
    confidences, accuracies = _multiclass_calibration_error_update(preds, target)
    return _ce_compute_from_bins(*_binned_stats_update(confidences, accuracies, n_bins, w), norm)


def calibration_error(
    preds, target, task: str, n_bins: int = 15, norm: str = "l1", num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch (binary or multiclass).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import calibration_error
        >>> calibration_error(torch.tensor([0.25, 0.75]), torch.tensor([0, 1]), task="binary")
        tensor(0.2500)
    """
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
    return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args)
