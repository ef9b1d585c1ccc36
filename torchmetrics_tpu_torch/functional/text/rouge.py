"""ROUGE score (counterpart of ``torchmetrics_tpu/functional/text/rouge.py``; the
algorithm follows the official
google-research rouge_scorer semantics).

Host-side tokenization/LCS producing per-sentence (precision, recall, fmeasure)
triples; the stateful class keeps them as cat rows per rouge key.
"""

from __future__ import annotations

import re
from collections import Counter
from functools import lru_cache
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...utilities.imports import _NLTK_AVAILABLE
from .helper import _host_tensor

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1, "rouge2": 2, "rouge3": 3, "rouge4": 4, "rouge5": 5,
    "rouge6": 6, "rouge7": 7, "rouge8": 8, "rouge9": 9, "rougeL": "L", "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")


@lru_cache(maxsize=None)
def _punkt_available() -> bool:
    """Whether nltk's ``punkt_tab`` sentence model is installed. It is looked up once and
    never downloaded: the port reaches no network."""
    if not _NLTK_AVAILABLE:
        return False
    import nltk

    try:
        nltk.data.find("tokenizers/punkt_tab")
    except LookupError:
        return False
    return True


def _split_sentence(x: str) -> Sequence[str]:
    """Sentence splitter for ROUGE-Lsum: nltk's punkt where it is installed, else the JAX
    package's offline splitter (a split after ``.``, ``!`` or ``?`` and white space)."""
    x = re.sub("<n>", "", x)  # remove pegasus newline char
    if _punkt_available():
        import nltk

        return nltk.sent_tokenize(x)
    return [s for s in re.split(r"(?<=[.!?])\s+", x.strip()) if s]


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    fmeasure = 2 * precision * recall / (precision + recall)
    return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


def _lcs_table(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> List[List[int]]:
    """LCS DP table, indexed ``[target_j][pred_i]``, as Python lists: the recurrence is
    sequential in both axes, and list cells read faster than numpy scalars (the JAX
    package's table holds the same numbers in a numpy array)."""
    n, m = len(target_tokens), len(pred_tokens)
    table = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        token = target_tokens[i - 1]
        row, prev = table[i], table[i - 1]
        for j in range(1, m + 1):
            if pred_tokens[j - 1] == token:
                row[j] = prev[j - 1] + 1
            else:
                up, left = prev[j], row[j - 1]
                row[j] = up if up > left else left
    return table


def _lcs(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> int:
    return _lcs_table(pred_tokens, target_tokens)[-1][-1]


def _backtracked_lcs(table: List[List[int]], pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> List[int]:
    i, j = len(pred_tokens), len(target_tokens)
    out: List[int] = []
    while i > 0 and j > 0:
        if pred_tokens[i - 1] == target_tokens[j - 1]:
            out.insert(0, j - 1)
            i -= 1
            j -= 1
        elif table[j][i - 1] > table[j - 1][i]:
            i -= 1
        else:
            j -= 1
    return out


def _union_lcs(pred_tokens_list: Sequence[Sequence[str]], target_tokens: Sequence[str]) -> List[str]:
    indices: set = set()
    for pred_tokens in pred_tokens_list:
        table = _lcs_table(pred_tokens, target_tokens)  # indexed [target_j][pred_i]
        indices.update(_backtracked_lcs(table, pred_tokens, target_tokens))
    return [target_tokens[i] for i in sorted(indices)]


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> List[str]:
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    def _create_ngrams(tokens: Sequence[str], n: int) -> Counter:
        return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))

    pred_ngrams, target_ngrams = _create_ngrams(pred, n_gram), _create_ngrams(target, n_gram)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    hits = sum(min(pred_ngrams[w], target_ngrams[w]) for w in set(pred_ngrams))
    return _compute_metrics(hits, max(pred_len, 1), max(target_len, 1))


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    pred_len, target_len = len(pred), len(target)
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    return _compute_metrics(_lcs(pred, target), pred_len, target_len)


def _rouge_lsum_score(pred: Sequence[Sequence[str]], target: Sequence[Sequence[str]]) -> Dict[str, float]:
    pred_len = sum(map(len, pred))
    target_len = sum(map(len, target))
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    pred_counts = Counter()
    target_counts = Counter()
    for sentence in pred:
        pred_counts.update(sentence)
    for sentence in target:
        target_counts.update(sentence)
    hits = 0
    for tgt in target:
        for token in _union_lcs(pred, tgt):
            if pred_counts[token] > 0 and target_counts[token] > 0:
                hits += 1
                pred_counts[token] -= 1
                target_counts[token] -= 1
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sentence (best- or avg-over-references) score triples per rouge key."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}
    for pred_raw, target_raw in zip(preds, target):
        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        if "Lsum" in rouge_keys_values:
            pred_lsum = [
                _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer) for s in _split_sentence(pred_raw)
            ]
        per_ref: List[Dict[Union[int, str], Dict[str, float]]] = []
        for target_raw_inner in target_raw:
            tgt = _normalize_and_tokenize_text(target_raw_inner, stemmer, normalizer, tokenizer)
            scores: Dict[Union[int, str], Dict[str, float]] = {}
            for rouge_key in rouge_keys_values:
                if isinstance(rouge_key, int):
                    scores[rouge_key] = _rouge_n_score(pred, tgt, rouge_key)
                elif rouge_key == "L":
                    scores[rouge_key] = _rouge_l_score(pred, tgt)
                else:  # Lsum
                    target_lsum = [
                        _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                        for s in _split_sentence(target_raw_inner)
                    ]
                    scores[rouge_key] = _rouge_lsum_score(pred_lsum, target_lsum)
            per_ref.append(scores)
        for rouge_key in rouge_keys_values:
            if accumulate == "best":
                best = max(per_ref, key=lambda s: s[rouge_key]["fmeasure"])
                results[rouge_key].append(best[rouge_key])
            else:
                avg = {
                    t: float(np.mean([s[rouge_key][t] for s in per_ref]))
                    for t in ("precision", "recall", "fmeasure")
                }
                results[rouge_key].append(avg)
    return results


def _rouge_score_compute(sentence_results: Dict[str, List[float]], device=None) -> Dict[str, torch.Tensor]:
    return {k: _host_tensor(np.mean(v), torch.float32, device) for k, v in sentence_results.items()}


def _resolve_rouge_keys(rouge_keys: Union[str, Tuple[str, ...]]) -> Tuple[Tuple[str, ...], List[Union[int, str]]]:
    if isinstance(rouge_keys, str):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    return tuple(rouge_keys), [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]


def _make_stemmer(use_stemmer: bool):
    if not use_stemmer:
        return None
    if not _NLTK_AVAILABLE:
        raise ModuleNotFoundError("Stemmer requires that `nltk` is installed. Use `pip install nltk`.")
    import nltk

    return nltk.stem.porter.PorterStemmer()


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device=None,
) -> Dict[str, torch.Tensor]:
    """ROUGE-N/L/Lsum precision/recall/F over the best (or averaged) reference, on
    ``device`` (the card when None).

    Example:
        >>> from torchmetrics_tpu_torch.functional import rouge_score
        >>> scores = rouge_score(['the cat is on the mat'], [['a cat is on the mat']], rouge_keys='rouge1', device="cpu")
        >>> {k: round(float(v), 4) for k, v in scores.items()}
        {'rouge1_fmeasure': 0.8333, 'rouge1_precision': 0.8333, 'rouge1_recall': 0.8333}
    """
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    stemmer = _make_stemmer(use_stemmer)
    keys, key_values = _resolve_rouge_keys(rouge_keys)
    preds, target = _rouge_inputs(preds, target)
    sentence_results = _rouge_score_update(preds, target, key_values, accumulate, stemmer, normalizer, tokenizer)
    output: Dict[str, List[float]] = {}
    for key, key_value in zip(keys, key_values):
        for tp in ("fmeasure", "precision", "recall"):
            output[f"{key}_{tp}"] = [s[tp] for s in sentence_results[key_value]]
    return _rouge_score_compute(output, device)


def _rouge_inputs(preds, target):
    """Lists of predictions and of reference lists: a flat list of strings is several
    references of one prediction given as a string, else one reference each."""
    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    return preds, target
