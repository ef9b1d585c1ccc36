"""Numerics helpers (counterpart of ``torchmetrics_tpu/utilities/compute.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def _safe_divide(num: torch.Tensor, denom: torch.Tensor, zero_division: float = 0.0) -> torch.Tensor:
    """``num / denom`` with 0-denominator positions replaced by ``zero_division``
    (``float("nan")`` marks them undefined).

    Both operands are promoted to at least float32.
    """
    num = torch.as_tensor(num)
    denom = torch.as_tensor(denom, device=num.device)
    dtype = torch.promote_types(torch.promote_types(num.dtype, denom.dtype), torch.float32)
    num = num.to(dtype)
    denom = denom.to(dtype)
    zero = denom == 0
    quotient = num / torch.where(zero, torch.ones_like(denom), denom)
    return torch.where(zero, torch.full_like(quotient, zero_division), quotient)


def _safe_xlogy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x * log(y)`` that is 0 where ``x == 0`` (even where ``y`` is 0 or inf), in at
    least float32.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utilities.compute import _safe_xlogy
        >>> _safe_xlogy(torch.tensor([0.0, 2.0]), torch.tensor([0.0, 1.0]))
        tensor([0., 0.])
    """
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    dtype = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.float32)
    x, y = x.to(dtype), y.to(dtype)
    zero = x == 0
    safe_y = torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros_like(x), x * torch.log(safe_y))


def _float32_sum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """A float32 sum accumulated in float64: the order of the additions (the card's, the
    CPU's) then moves only the float64's last bits, not the float32 result's."""
    return (x.sum(dtype=torch.float64) if dim is None else x.sum(dim, dtype=torch.float64)).to(torch.float32)


def _adjust_weights_safe_divide(
    score: torch.Tensor,
    average: Optional[str],
    multilabel: bool,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    top_k: int = 1,
) -> torch.Tensor:
    """Weighted/macro reduction of per-class scores, ignoring absent classes."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(torch.float32)
    else:
        weights = torch.ones_like(score, dtype=torch.float32)
        if not multilabel:
            # drop classes that never appear (neither predicted nor present); with
            # top_k > 1 only true absence (no support) drops a class
            absent = (tp + fp + fn) == 0 if top_k == 1 else (tp + fn) == 0
            weights = weights * (~absent)
    norm = weights.sum(-1, keepdim=True)
    return (_safe_divide(weights, norm) * score).sum(-1)


def _auc_compute(x: torch.Tensor, y: torch.Tensor, direction: Optional[float] = None) -> torch.Tensor:
    """Trapezoidal area under the curve ``(x, y)`` along the last axis, in float32.

    ``direction`` multiplies the area; when None it is -1 if ``x`` never increases and
    +1 otherwise, decided on the device. Leading axes are independent curves.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utilities.compute import _auc_compute
        >>> _auc_compute(torch.tensor([0.0, 0.5, 1.0]), torch.tensor([0.0, 1.0, 1.0]))
        tensor(0.7500)
        >>> _auc_compute(torch.tensor([1.0, 0.0]), torch.tensor([1.0, 1.0]))  # x decreases
        tensor(1.)
    """
    x, y = torch.as_tensor(x).to(torch.float32), torch.as_tensor(y).to(torch.float32)
    dx = x.diff(dim=-1)
    trapz = ((y[..., 1:] + y[..., :-1]) / 2 * dx).sum(-1)
    if direction is None:
        sign = torch.where((dx <= 0).all(-1), -1.0, 1.0)
        return trapz * torch.where((dx >= 0).all(-1), 1.0, sign)
    return trapz * direction


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1-D linear interpolation by the formula of ``jnp.interp``: ``xp`` nondecreasing,
    repeated values allowed. The interval is ``searchsorted(xp, x, side="right")``
    clipped to ``[1, len - 1]``; where ``xp`` does not move across it (within the float
    spacing of the dtype's epsilon) the left value is taken; outside ``xp`` the end values.
    The step ``fl + slope * df`` is rounded once, as XLA's fused multiply-add rounds it.

    ``xp`` and ``fp`` may carry leading axes, one curve per row, each row's first
    ``lengths[i]`` points valid (all of them when None) and the rest any padding that
    keeps the row nondecreasing; ``x`` is then broadcast against each row.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utilities.compute import interp
        >>> interp(torch.tensor([0.25, 0.5, 2.0]), torch.tensor([0.0, 0.5, 0.5, 1.0]), torch.tensor([0.0, 1.0, 2.0, 3.0]))
        tensor([0.5000, 2.0000, 3.0000])
    """
    x, xp, fp = torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)
    dtype = torch.promote_types(torch.promote_types(x.dtype, xp.dtype), torch.float32)
    x, xp = x.to(dtype), xp.to(dtype)
    fp = fp.to(torch.promote_types(fp.dtype, torch.float32))
    rows = xp.shape[:-1]
    if lengths is None:
        lengths = torch.full(rows, xp.shape[-1], dtype=torch.long, device=xp.device)
    last = (lengths - 1).unsqueeze(-1)
    xb = x.expand(*rows, *x.shape).contiguous()
    i = torch.searchsorted(xp.contiguous(), xb, right=True)
    i = torch.minimum(i.clamp(min=1), last)
    xl, xr, fl, fr = xp.gather(-1, i - 1), xp.gather(-1, i), fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = xr - xl
    epsilon = torch.finfo(dtype).eps ** 2  # the spacing of eps: one ulp at eps
    dx0 = dx.abs() <= epsilon
    slope = (xb - xl) / torch.where(dx0, torch.ones_like(dx), dx)
    # XLA fuses ``fl + slope * df`` into one FMA; a float32 product is exact in float64,
    # so one rounding of the float64 sum gives the FMA's bits
    wide = torch.promote_types(fp.dtype, torch.float64)
    f = torch.where(dx0, fl, (fl.to(wide) + slope.to(wide) * (fr - fl).to(wide)).to(fp.dtype))
    f = torch.where(xb < xp[..., :1], fp[..., :1], f)
    return torch.where(xb > xp.gather(-1, last), fp.gather(-1, last), f)


def normalize_logits_if_needed(preds: torch.Tensor, normalization: str = "sigmoid") -> torch.Tensor:
    """Apply sigmoid (or softmax over dim 1) to the whole batch when any value lies
    outside [0, 1]; otherwise return the batch as it is.

    The test is one 0-d condition over the batch, applied by ``torch.where``, so CUDA
    never waits for the host. Integer input is taken as float32 first.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
        >>> normalize_logits_if_needed(torch.tensor([0.25, 0.75]))
        tensor([0.2500, 0.7500])
        >>> normalize_logits_if_needed(torch.tensor([0.25, 1.5]))  # one value outside: all of it
        tensor([0.5622, 0.8176])
    """
    if not preds.is_floating_point():
        preds = preds.to(torch.float32)
    outside = (preds.min() < 0) | (preds.max() > 1)
    if normalization == "sigmoid":
        return torch.where(outside, preds.sigmoid(), preds)
    if normalization == "softmax":
        return torch.where(outside, preds.softmax(dim=1), preds)
    return preds


def reduce(x: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    """Reduce a tensor by ``'elementwise_mean'``, ``'sum'``, or ``'none'``/None
    (reference ``utilities/distributed.py:22-42``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utilities import reduce
        >>> reduce(torch.tensor([1.0, 2.0, 6.0]), "elementwise_mean")
        tensor(3.)
    """
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "none" or reduction is None:
        return x
    if reduction == "sum":
        return torch.sum(x)
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: torch.Tensor, denom: torch.Tensor, weights: torch.Tensor,
                 class_reduction: Optional[str] = "none") -> torch.Tensor:
    """Reduce per-class ``num / denom * weights`` metrics by micro/macro/weighted/none
    (reference ``utilities/distributed.py:45-88``); NaN cells (classes without
    support) count as 0.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.utilities import class_reduce
        >>> class_reduce(torch.tensor([1.0, 0.0]), torch.tensor([2.0, 0.0]), torch.tensor([2, 0]), "macro")
        tensor(0.2500)
    """
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), 0.0, fraction)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights.to(torch.float32) / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")
