"""Extended Edit Distance (counterpart of ``torchmetrics_tpu/functional/text/eed.py``;
Stanchev, Wang, Ney,
"EED: Extended Edit Distance Measure for Machine Translation", WMT 2019).

The CDER-style character DP with long-jump penalties runs host-side with the inner
deletion chain folded into a numpy prefix-min; sentence scores are cat rows.
"""

from __future__ import annotations

import re
import unicodedata
from math import inf
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from .helper import _as_list, _host_tensor, _mean32


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Character-level CDER alignment with long jumps at reference spaces and a
    coverage penalty for repeated visits."""
    hyp_chars = np.array(list(hyp)) if hyp else np.empty(0, dtype="<U1")
    n = len(hyp_chars)
    visits = np.full(n + 1, -1, np.int64)
    row = np.ones(n + 1)
    row[0] = 0.0
    for w in range(1, len(ref) + 1):
        ref_char = ref[w - 1]
        # candidate costs without the sequential deletion chain
        base = np.empty(n + 1)
        base[0] = row[0] + 1.0
        match_cost = row[:-1] + (hyp_chars != ref_char).astype(np.float64)
        base[1:] = np.minimum(match_cost, row[1:] + insertion)
        # deletion chain folded SEQUENTIALLY: a prefix-min with (i-k)*deletion rounds
        # differently from repeated `+deletion` and flips argmin tie-breaks (and with
        # them the coverage/long-jump terms) vs the published DP
        next_row = base.tolist()
        for i in range(1, n + 1):
            chained = next_row[i - 1] + deletion
            if chained < next_row[i]:
                next_row[i] = chained
        next_row = np.asarray(next_row)
        min_index = int(np.argmin(next_row))
        visits[min_index] += 1
        if ref_char == " ":
            next_row = np.minimum(next_row, alpha + next_row[min_index])
        row = next_row
    coverage = rho * float(np.where(visits >= 0, visits, 1).sum())
    return min(1.0, (row[-1] + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    for pattern, replacement in (
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ):
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return f" {sentence} "


def _preprocess_ja(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> List[float]:
    """Per-sentence best-reference EED scores."""
    preds = _as_list(preds)
    target = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if language == "en":
        preprocess = _preprocess_en
    elif language == "ja":
        preprocess = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    scores: List[float] = []
    for pred, refs in zip(preds, target):
        pred_p = preprocess(pred)
        best = inf
        for ref in refs:
            score = _eed_function(pred_p, preprocess(ref), alpha, rho, deletion, insertion)
            best = min(best, score)
        scores.append(best)
    return scores


def _eed_compute(sentence_level_scores: torch.Tensor) -> torch.Tensor:
    """The mean of the float32 sentence scores (added in float64, rounded once), 0 when
    there are none."""
    if sentence_level_scores.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=sentence_level_scores.device)
    return _mean32(sentence_level_scores)


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Corpus EED averaged over sentence-level best-reference scores, on ``device`` (the
    card when None).

    Example:
        >>> from torchmetrics_tpu_torch.functional import extended_edit_distance
        >>> preds = ['this is the prediction']
        >>> extended_edit_distance(preds, [['this is the reference']], device="cpu")
        tensor(0.3835)
    """
    _check_eed_params(alpha, rho, deletion, insertion)
    scores = _host_tensor(_eed_update(preds, target, language, alpha, rho, deletion, insertion), torch.float32,
                          device)
    average = _eed_compute(scores)
    if return_sentence_level_score:
        return average, scores
    return average


def _check_eed_params(alpha, rho, deletion, insertion) -> None:
    for name, val in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
        if not isinstance(val, float) or val < 0:
            raise ValueError(f"Parameter `{name}` is expected to be a non-negative float.")
