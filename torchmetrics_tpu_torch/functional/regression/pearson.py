"""Pearson correlation by running moments (counterpart of
``torchmetrics_tpu/functional/regression/pearson.py``).

A batch gives its moments (means, centred sums of squares and of products, the largest
absolute deviations, the count); ``_merge_moments`` is Chan et al.'s exact parallel
combination of two moment sets, in the JAX package's float32 operation order. It is
associative, so the same merge folds batches, serves ``merge_state`` and folds the
moments of several processes (``_final_aggregation``), where a sum would be wrong for
means and variances. A batch's means and sums are float64 sums rounded once to float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum
from ...utilities.prints import rank_zero_warn
from .utils import _check_data_shape_to_num_outputs, _mean32

Moments = Tuple[torch.Tensor, ...]


def _batch_moments(preds: torch.Tensor, target: torch.Tensor) -> Moments:
    """(mean_x, mean_y, max_abs_dev_x, max_abs_dev_y, var_x, var_y, corr_xy, n) of one
    batch along axis 0; var and corr are unnormalised centred sums."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    n = torch.tensor(float(preds.shape[0]), dtype=torch.float32, device=preds.device)
    mean_x, mean_y = _mean32(preds), _mean32(target)
    px, ty = preds - mean_x, target - mean_y
    return (mean_x, mean_y, px.abs().amax(0), ty.abs().amax(0), _float32_sum(px * px, 0), _float32_sum(ty * ty, 0),
            _float32_sum(px * ty, 0), n)


def _merge_moments(a: Moments, b: Moments) -> Moments:
    """Exact parallel combination of two moment sets (Chan et al.)."""
    mx_a, my_a, dev_xa, dev_ya, vx_a, vy_a, cxy_a, n_a = a
    mx_b, my_b, dev_xb, dev_yb, vx_b, vy_b, cxy_b, n_b = b
    n = n_a + n_b
    safe_n = torch.where(n == 0, torch.ones_like(n), n)
    delta_x = mx_b - mx_a
    delta_y = my_b - my_a
    mean_x = mx_a + delta_x * n_b / safe_n
    mean_y = my_a + delta_y * n_b / safe_n
    correction = n_a * n_b / safe_n
    var_x = vx_a + vx_b + delta_x * delta_x * correction
    var_y = vy_a + vy_b + delta_y * delta_y * correction
    corr_xy = cxy_a + cxy_b + delta_x * delta_y * correction
    # the largest deviation only flags instability: bound it by each side's mean shift
    dev_x = torch.maximum(dev_xa + (mx_a - mean_x).abs(), dev_xb + (mx_b - mean_x).abs())
    dev_y = torch.maximum(dev_ya + (my_a - mean_y).abs(), dev_yb + (my_b - mean_y).abs())
    return mean_x, mean_y, dev_x, dev_y, var_x, var_y, corr_xy, n


def _pearson_corrcoef_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    max_abs_dev_x: torch.Tensor,
    max_abs_dev_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    num_prior: torch.Tensor,
    num_outputs: int,
) -> Moments:
    """Fold one batch into the running moments."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    batch = _batch_moments(preds, target)
    return _merge_moments((mean_x, mean_y, max_abs_dev_x, max_abs_dev_y, var_x, var_y, corr_xy, num_prior), batch)


def _pearson_corrcoef_compute(
    max_abs_dev_x: torch.Tensor,
    max_abs_dev_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    num_total: torch.Tensor,
) -> torch.Tensor:
    """Correlation from the final moments; the near-zero variance warning reads the
    host once, except under ``torch.export`` (as the JAX package skips it while it
    traces)."""
    var_x = var_x / (num_total - 1)
    var_y = var_y / (num_total - 1)
    corr_xy = corr_xy / (num_total - 1)
    if not torch.compiler.is_exporting() and bool(((var_x < 1e-6).any() | (var_y < 1e-6).any()).item()):
        rank_zero_warn(
            "The variance of predictions or target is close to zero. This can cause instability in Pearson correlation"
            "coefficient, leading to wrong results. Consider re-scaling the input if possible or computing using a"
            f"larger dtype (currently using {var_x.dtype}).",
            UserWarning,
        )
    return (corr_xy / torch.sqrt(var_x * var_y)).clamp(-1.0, 1.0).squeeze()


def _final_aggregation(
    means_x: torch.Tensor,
    means_y: torch.Tensor,
    max_abs_dev_x: torch.Tensor,
    max_abs_dev_y: torch.Tensor,
    vars_x: torch.Tensor,
    vars_y: torch.Tensor,
    corrs_xy: torch.Tensor,
    nbs: torch.Tensor,
) -> Moments:
    """Fold per-process moment stacks ``(world, num_outputs)`` into one moment set, in
    rank order."""
    stacks = (means_x, means_y, max_abs_dev_x, max_abs_dev_y, vars_x, vars_y, corrs_xy, nbs)
    acc = tuple(s[0] for s in stacks)
    for i in range(1, means_x.shape[0]):
        acc = _merge_moments(acc, tuple(s[i] for s in stacks))
    return acc


def _zero_moments(preds: torch.Tensor) -> Moments:
    num_outputs = 1 if preds.ndim == 1 else preds.shape[-1]
    zeros = torch.zeros((num_outputs,) if num_outputs > 1 else (), dtype=torch.float32, device=preds.device)
    return (zeros,) * 7 + (torch.zeros((), dtype=torch.float32, device=preds.device),)


def pearson_corrcoef(preds, target) -> torch.Tensor:
    """One-shot Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pearson_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> pearson_corrcoef(preds, target)
        tensor(0.9849)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[-1]
    _, _, dev_x, dev_y, var_x, var_y, corr_xy, n = _pearson_corrcoef_update(
        preds, target, *_zero_moments(preds), num_outputs)
    return _pearson_corrcoef_compute(dev_x, dev_y, var_x, var_y, corr_xy, n)
