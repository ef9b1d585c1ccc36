"""BLEU score (counterpart of ``torchmetrics_tpu/functional/text/bleu.py``).

Host-side n-gram counting produces four sum states (numerator and denominator per
order, prediction and reference lengths); the geometric mean and the brevity penalty
are float32 tensor ops on the states' device.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .helper import _count_ngram, _host_tensor


def _tokenize_fn(sentence: str) -> Sequence[str]:
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Returns (numerator, denominator, preds_len, target_len) contributions."""
    target_tok = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tok = [tokenizer(line) if line else [] for line in preds]
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len = 0.0
    target_len = 0.0
    for pred, targets in zip(preds_tok, target_tok):
        preds_len += len(pred)
        target_len_list = [len(tgt) for tgt in targets]
        target_len_diff = [abs(len(pred) - x) for x in target_len_list]
        target_len += target_len_list[target_len_diff.index(min(target_len_diff))]
        preds_counter: Counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)
        ngram_counter_clip = preds_counter & target_counter
        for counter_clip in ngram_counter_clip:
            numerator[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]
        for counter in preds_counter:
            denominator[len(counter) - 1] += preds_counter[counter]
    return numerator, denominator, preds_len, target_len


def _bleu_score_compute(
    preds_len: torch.Tensor, target_len: torch.Tensor, numerator: torch.Tensor, denominator: torch.Tensor,
    n_gram: int, weights: Sequence[float], smooth: bool,
) -> torch.Tensor:
    """The corpus score from float32 states, on their device."""
    if smooth:
        precision_scores = (numerator + 1.0) / (denominator + 1.0)
        precision_scores[0] = numerator[0] / denominator[0]
    else:
        precision_scores = numerator / denominator
    weights_t = torch.tensor(list(weights), dtype=torch.float32, device=numerator.device)
    geometric_mean = torch.exp(torch.sum(weights_t * torch.log(precision_scores)))
    brevity_penalty = torch.where(preds_len > target_len, 1.0, torch.exp(1 - (target_len / preds_len)))
    score = brevity_penalty * geometric_mean
    return torch.where(torch.min(numerator) == 0.0, 0.0, score)


def _resolve_weights(n_gram: int, weights: Optional[Sequence[float]]) -> Sequence[float]:
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    return weights if weights is not None else [1.0 / n_gram] * n_gram


def _bleu_states(counts: tuple, device) -> Tuple[torch.Tensor, ...]:
    """(numerator, denominator, preds_len, target_len) as float32 tensors on ``device``."""
    return tuple(_host_tensor(c, torch.float32, device) for c in counts)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    device=None,
) -> torch.Tensor:
    """Corpus BLEU of machine-translated text against one or more references, on
    ``device`` (the card when None).

    Example:
        >>> from torchmetrics_tpu_torch.functional import bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu_score(preds, target, device="cpu")
        tensor(0.7598)
    """
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    weights = _resolve_weights(n_gram, weights)
    numerator, denominator, preds_len, target_len = _bleu_states(_bleu_score_update(preds_, target_, n_gram), device)
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
