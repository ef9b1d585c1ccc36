"""Perplexity (counterpart of ``torchmetrics_tpu/functional/text/perplexity.py``).

The one text metric whose update is device work end to end: a log-softmax over the
vocabulary, a gather of the target tokens' log-probabilities and a masked sum, on the
logits' device. The sum adds in float64 and rounds once to the logits' dtype, so the
card and the CPU agree on the order-free part.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...utilities.checks import _as_tensor
from ...utilities.data import _jax_dtype


def _check_shape_and_type_consistency(preds: torch.Tensor, target: torch.Tensor) -> None:
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len], but got {target.ndim}."
        )
    if tuple(preds.shape[:2]) != tuple(target.shape):
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {tuple(preds.shape[:2])} and {tuple(target.shape)}."
        )
    if not preds.is_floating_point():
        raise TypeError(f"Input tensor `preds` is expected to be of floating point type but got {preds.dtype}.")
    if preds.is_complex() or target.is_floating_point() or target.is_complex() or target.dtype == torch.bool:
        raise TypeError(f"Input tensor `target` is expected to be of integer type but got {target.dtype}.")


def _perplexity_update(preds, target, ignore_index: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The negative log-likelihood summed over the counted tokens (in the logits' dtype)
    and their int32 count."""
    preds = _jax_dtype(_as_tensor(preds))
    target = _jax_dtype(_as_tensor(target))
    _check_shape_and_type_consistency(preds, target)
    log_probs = torch.log_softmax(preds.reshape(-1, preds.shape[-1]), dim=-1)
    target = target.reshape(-1).long()
    if ignore_index is not None:
        mask = target != ignore_index
        target = torch.where(mask, target, 0)
    else:
        mask = torch.ones_like(target, dtype=torch.bool)
    picked = log_probs.gather(1, target[:, None])[:, 0]
    total_log_probs = -torch.where(mask, picked, 0.0).sum(dtype=torch.float64).to(picked.dtype)
    return total_log_probs, mask.sum(dtype=torch.int32)


def _perplexity_compute(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return torch.exp(total / count)


def perplexity(preds, target, ignore_index: Optional[int] = None) -> torch.Tensor:
    """exp of the mean negative log-likelihood of the target tokens under ``preds``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import perplexity
        >>> preds = torch.tensor([[[0.2, 0.4, 0.4], [0.5, 0.2, 0.3]]])
        >>> target = torch.tensor([[1, 0]])
        >>> perplexity(torch.log(preds), target)
        tensor(2.2361)
    """
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
