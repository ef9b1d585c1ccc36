"""Edit (Levenshtein) distance (counterpart of
``torchmetrics_tpu/functional/text/edit.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .helper import _host_tensor
from .ter import _levenshtein_with_trace


def _edit_distance_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    device=None,
) -> torch.Tensor:
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if not all(isinstance(x, str) for x in preds):
        raise ValueError(f"Expected all values in argument `preds` to be string type, but got {preds}")
    if not all(isinstance(x, str) for x in target):
        raise ValueError(f"Expected all values in argument `target` to be string type, but got {target}")
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
        )
    # beam-limited DP like the reference's _LevenshteinEditDistance (beam width 25):
    # the beam is part of the reference's observable behavior on length-disparate pairs
    distance = [_levenshtein_with_trace(list(p), list(t), substitution_cost)[0] for p, t in zip(preds, target)]
    return _host_tensor(distance, torch.int32, device)


def _edit_distance_compute(
    edit_scores: torch.Tensor,
    num_elements,
    reduction: Optional[str] = "mean",
) -> torch.Tensor:
    """int32 sums as ``jnp.sum`` keeps them; the mean is their float32 quotient."""
    if edit_scores.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=edit_scores.device)
    if reduction == "mean":
        return edit_scores.sum(dtype=torch.int32) / num_elements
    if reduction == "sum":
        return edit_scores.sum(dtype=torch.int32)
    if reduction is None or reduction == "none":
        return edit_scores
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    reduction: Optional[str] = "mean",
    device=None,
) -> torch.Tensor:
    """Character-level Levenshtein distance with configurable substitution cost, on
    ``device`` (the card when None).

    Example:
        >>> from torchmetrics_tpu_torch.functional import edit_distance
        >>> edit_distance(['rain'], ['shine'], device="cpu")
        tensor(3.)
    """
    distance = _edit_distance_update(preds, target, substitution_cost, device)
    return _edit_distance_compute(distance, num_elements=distance.numel(), reduction=reduction)
