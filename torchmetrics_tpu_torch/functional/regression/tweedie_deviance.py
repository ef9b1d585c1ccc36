"""Tweedie deviance score (counterpart of
``torchmetrics_tpu/functional/regression/tweedie_deviance.py``).

For ``power`` 1 and 2 the domain check reads the host once per update (one bool over
both conditions); the other powers read nothing."""

from __future__ import annotations

import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.compute import _float32_sum, _safe_xlogy


def _ieee_pow(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """``x ** exponent`` as IEEE ``pow`` (and ``jnp.power``) gives it at a zero of either
    sign: torch takes the exponents 0.5 and -0.5 as ``sqrt`` and ``rsqrt``, which keep the
    zero's sign (``rsqrt(-0.0)`` is ``-inf``, where ``pow(-0.0, -0.5)`` is ``+inf``), so
    for those two the zero is made ``+0.0`` first (``x + 0.0``)."""
    return torch.pow(x + 0.0 if exponent in (0.5, -0.5) else x, exponent)


def _tweedie_deviance_score_update(preds: torch.Tensor, targets: torch.Tensor, power: float = 0.0):
    _check_same_shape(preds, targets)
    preds, targets = preds.to(torch.float32), targets.to(torch.float32)
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    if power == 1 and bool(((preds <= 0).any() | (targets < 0).any()).item()):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
    if power == 2 and bool(((preds <= 0).any() | (targets <= 0).any()).item()):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")

    if power == 0:
        deviance_score = torch.square(targets - preds)
    elif power == 1:
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        term_1 = _ieee_pow(targets.clamp(min=0), 2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * _ieee_pow(preds, 1 - power) / (1 - power)
        term_3 = _ieee_pow(preds, 2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)
    num = torch.tensor(float(deviance_score.numel()), dtype=torch.float32, device=preds.device)
    return _float32_sum(deviance_score), num


def _tweedie_deviance_score_compute(sum_deviance_score: torch.Tensor, num_observations: torch.Tensor) -> torch.Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds, targets, power: float = 0.0) -> torch.Tensor:
    """Tweedie deviance score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import tweedie_deviance_score
        >>> preds = torch.tensor([2.5, 0.5, 2.0, 8.0])
        >>> target = torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> tweedie_deviance_score(preds, target, power=1.5)
        tensor(0.0262)
    """
    preds, targets = _as_tensor(preds), _as_tensor(targets)
    s, n = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(s, n)
