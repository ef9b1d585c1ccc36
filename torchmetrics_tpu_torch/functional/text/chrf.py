"""chrF / chrF++ score (counterpart of ``torchmetrics_tpu/functional/text/chrf.py``).

Host-side character/word n-gram counting (plain float dicts instead of the reference's
per-n-gram tensors) feeding fixed-shape per-order count vectors: six ``(n,)`` sum
states. The corpus F-score is computed from them in float64 numpy on the host, as
there.
"""

from __future__ import annotations

import string
from collections import defaultdict
from itertools import chain
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from .helper import _host_tensor

_EPS_SMOOTHING = 1e-16
_PUNCTUATIONS = set(string.punctuation)


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    return list(chain.from_iterable(_separate_word_and_punctuation(word) for word in sentence.strip().split()))


def _ngram_counts(tokens: List[str], n_gram_order: int) -> Dict[int, Dict[tuple, float]]:
    ngrams: Dict[int, Dict[tuple, float]] = {n: defaultdict(float) for n in range(1, n_gram_order + 1)}
    for n in range(1, n_gram_order + 1):
        for i in range(len(tokens) - n + 1):
            ngrams[n][tuple(tokens[i : i + n])] += 1
    return ngrams


def _sentence_counts(sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool):
    if lowercase:
        sentence = sentence.lower()
    char_counts = _ngram_counts(_get_characters(sentence, whitespace), n_char_order)
    word_counts = _ngram_counts(_get_words_and_punctuation(sentence), n_word_order)
    char_totals = np.asarray([sum(char_counts[n].values()) for n in range(1, n_char_order + 1)])
    word_totals = np.asarray([sum(word_counts[n].values()) for n in range(1, n_word_order + 1)])
    return char_counts, word_counts, char_totals, word_totals


def _matches(hyp_counts, ref_counts, order: int) -> np.ndarray:
    out = np.zeros(order)
    for n in range(1, order + 1):
        out[n - 1] = sum(min(ref_counts[n][g], c) for g, c in hyp_counts[n].items() if g in ref_counts[n])
    return out


def _fscore(
    matching_char, matching_word, hyp_char, hyp_word, ref_char, ref_word, n_order: float, beta: float
) -> float:
    def per_order(matching, ref, hyp):
        precision = np.where(hyp > 0, matching / np.where(hyp > 0, hyp, 1.0), 0.0)
        recall = np.where(ref > 0, matching / np.where(ref > 0, ref, 1.0), 0.0)
        denominator = np.maximum(beta**2 * precision + recall, _EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denominator

    return float(
        (per_order(matching_char, ref_char, hyp_char).sum() + per_order(matching_word, ref_word, hyp_word).sum())
        / n_order
    )


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[float]]:
    """Per-call contribution: (preds_char, preds_word, target_char, target_word,
    matching_char, matching_word) count vectors + sentence-level scores."""
    if isinstance(preds, str):
        preds = [preds]
    target = [[t] if isinstance(t, str) else t for t in target]
    n_order = float(n_char_order + n_word_order)
    tot = [np.zeros(n_char_order), np.zeros(n_word_order), np.zeros(n_char_order), np.zeros(n_word_order),
           np.zeros(n_char_order), np.zeros(n_word_order)]
    sentence_scores: List[float] = []
    for pred, targets in zip(preds, target):
        p_char_counts, p_word_counts, p_char_tot, p_word_tot = _sentence_counts(
            pred, n_char_order, n_word_order, lowercase, whitespace
        )
        best = (0.0, np.zeros(n_char_order), np.zeros(n_word_order), np.zeros(n_char_order), np.zeros(n_word_order))
        for tgt in targets:
            t_char_counts, t_word_counts, t_char_tot, t_word_tot = _sentence_counts(
                tgt, n_char_order, n_word_order, lowercase, whitespace
            )
            m_char = _matches(p_char_counts, t_char_counts, n_char_order)
            m_word = _matches(p_word_counts, t_word_counts, n_word_order)
            f = _fscore(m_char, m_word, p_char_tot, p_word_tot, t_char_tot, t_word_tot, n_order, beta)
            if f > best[0]:
                best = (f, m_char, m_word, t_char_tot, t_word_tot)
        sentence_scores.append(best[0])
        tot[0] += p_char_tot
        tot[1] += p_word_tot
        tot[2] += best[3]
        tot[3] += best[4]
        tot[4] += best[1]
        tot[5] += best[2]
    return (*tot, sentence_scores)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _chrf_score_compute(
    preds_char, preds_word, target_char, target_word, matching_char, matching_word, n_order: float, beta: float,
    device=None,
) -> torch.Tensor:
    """The corpus F-score of the six count vectors, on ``device`` (the first vector's
    device when it is a tensor, else the card when None)."""
    if device is None and isinstance(preds_char, torch.Tensor):
        device = preds_char.device
    score = _fscore(
        _host(matching_char), _host(matching_word), _host(preds_char), _host(preds_word),
        _host(target_char), _host(target_word), n_order, beta,
    )
    return _host_tensor(score, torch.float32, device)


def _validate_chrf_args(n_char_order, n_word_order, beta) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """chrF (``n_word_order=0``) / chrF++ (default) score against the best-matching
    reference per sentence, on ``device`` (the card when None).

    Example:
        >>> from torchmetrics_tpu_torch.functional import chrf_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> chrf_score(preds, target, device="cpu")
        tensor(0.8640)
    """
    _validate_chrf_args(n_char_order, n_word_order, beta)
    n_order = float(n_char_order + n_word_order)
    *totals, sentence_scores = _chrf_score_update(
        preds, target, n_char_order, n_word_order, beta, lowercase, whitespace
    )
    score = _chrf_score_compute(*totals, n_order, beta, device=device)
    if return_sentence_level_score:
        return score, _host_tensor(sentence_scores, torch.float32, device)
    return score
