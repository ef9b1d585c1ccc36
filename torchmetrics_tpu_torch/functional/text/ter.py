"""Translation Edit Rate (counterpart of ``torchmetrics_tpu/functional/text/ter.py``;
the algorithm follows the
Tercom/sacrebleu semantics: greedy block-shift search over a trace-producing,
beam-limited Levenshtein alignment).

All work is host-side; the class keeps two scalar sum states (edits, reference
length).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .helper import _as_list, _host_tensor

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000
_BEAM_WIDTH = 25
_INT_INFINITY = int(1e16)

# edit-operation codes for the trace
_NOTHING, _SUB, _INS, _DEL, _UNDEF = 0, 1, 2, 3, 4


class _TercomTokenizer:
    """Tercom normalization/tokenization (sacrebleu ``tokenizer_ter`` semantics)."""

    _ASIAN_PUNCTUATION = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCTUATION = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        rules = [
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ]
        for pattern, replacement in rules:
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)

    @classmethod
    def _remove_asian_punct(cls, sentence: str) -> str:
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r"", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r"", sentence)


def _levenshtein_with_trace(
    pred: List[str], ref: List[str], op_substitute: int = 1
) -> Tuple[int, List[int]]:
    """Beam-limited Levenshtein with backtrace (Tercom beam + tie preference
    substitute > delete > insert; the beam mirrors sacrebleu's lib_ter and is part of
    the compatibility surface — it changes results on length-disparate pairs)."""
    n, m = len(pred), len(ref)
    cost = [[_INT_INFINITY] * (m + 1) for _ in range(n + 1)]
    op = [[_UNDEF] * (m + 1) for _ in range(n + 1)]
    cost[0] = list(range(m + 1))
    op[0] = [_INS] * (m + 1)
    length_ratio = m / n if pred else 1.0
    beam_width = math.ceil(length_ratio / 2 + _BEAM_WIDTH) if length_ratio / 2 > _BEAM_WIDTH else _BEAM_WIDTH
    for i in range(1, n + 1):
        pseudo_diag = math.floor(i * length_ratio)
        min_j = max(0, pseudo_diag - beam_width)
        max_j = m + 1 if i == n else min(m + 1, pseudo_diag + beam_width)
        above, row, row_op, word = cost[i - 1], cost[i], op[i], pred[i - 1]
        for j in range(min_j, max_j):
            if j == 0:
                row[0] = above[0] + 1
                row_op[0] = _DEL
                continue
            # the candidates in order, each taken only where strictly cheaper than the
            # best so far (from infinity): substitute or match > delete > insert
            best, best_op = _INT_INFINITY, _UNDEF
            diagonal = above[j - 1] if word == ref[j - 1] else above[j - 1] + op_substitute
            if diagonal < best:
                best, best_op = diagonal, (_NOTHING if word == ref[j - 1] else _SUB)
            if above[j] + 1 < best:
                best, best_op = above[j] + 1, _DEL
            if row[j - 1] + 1 < best:
                best, best_op = row[j - 1] + 1, _INS
            row[j], row_op[j] = best, best_op
    # backtrace
    trace: List[int] = []
    i, j = n, m
    while i > 0 or j > 0:
        o = op[i][j]
        trace.append(o)
        if o in (_NOTHING, _SUB):
            i -= 1
            j -= 1
        elif o == _INS:
            j -= 1
        elif o == _DEL:
            i -= 1
        else:  # pragma: no cover - beam always covers the backtrace path
            raise ValueError("Unknown operation in edit-distance backtrace")
    trace.reverse()
    return cost[n][m], trace


def _flip_trace(trace: List[int]) -> List[int]:
    return [_DEL if o == _INS else _INS if o == _DEL else o for o in trace]


def _trace_to_alignment(trace: List[int]) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Alignment + per-side error flags from an edit trace, derived via cumulative
    position counters: the reference side advances on match/substitute/delete, the
    hypothesis side on match/substitute/insert; a reference position aligns to the
    hypothesis position current when it was consumed, and a position is an "error"
    unless its op was a match."""
    ops = np.asarray(trace, np.int64) if trace else np.zeros(0, np.int64)
    ref_step = ops != _INS
    hyp_step = ops != _DEL
    ref_pos = np.cumsum(ref_step) - 1
    hyp_pos = np.cumsum(hyp_step) - 1
    alignments = dict(zip(ref_pos[ref_step].tolist(), hyp_pos[ref_step].tolist()))
    ref_errors = (ops[ref_step] != _NOTHING).astype(int).tolist()
    hyp_errors = (ops[hyp_step] != _NOTHING).astype(int).tolist()
    return alignments, ref_errors, hyp_errors


def _find_shifted_pairs(pred_words: List[str], target_words: List[str]) -> Iterator[Tuple[int, int, int]]:
    """Common-run candidates ``(pred_start, target_start, 1..run_length)`` for every
    word shared between the sequences, found through a position index of the target
    side. Runs are capped by the Tercom shift-size/distance limits; enumeration is
    (pred_start, target_start, length)-ascending, which the candidate-budget cutoff
    depends on."""
    where_in_target: Dict[str, List[int]] = {}
    for j, word in enumerate(target_words):
        where_in_target.setdefault(word, []).append(j)
    for i, word in enumerate(pred_words):
        for j in where_in_target.get(word, ()):
            if abs(j - i) > _MAX_SHIFT_DIST:
                continue
            run = 1
            while (
                run < _MAX_SHIFT_SIZE - 1
                and i + run < len(pred_words)
                and j + run < len(target_words)
                and pred_words[i + run] == target_words[j + run]
            ):
                run += 1
            for length in range(1, run + 1):
                yield i, j, length


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Move ``words[start:start+length]`` so it lands at trace position ``target``:
    remove the block, then re-insert it (insertion index shifts down by the block
    length once the removal happens before it)."""
    block = words[start : start + length]
    rest = words[:start] + words[start + length :]
    ins = target - length if target > start + length else target
    return rest[:ins] + block + rest[ins:]


def _candidate_insertion_points(alignments: Dict[int, int], target_start: int, length: int) -> List[int]:
    """Hypothesis-side insertion indices for a block aimed at ``target_start``: just
    before the aligned position of each trace slot ``target_start-1 .. target_start+
    length-1``, stopping at the first unaligned slot. Aligned positions are
    non-decreasing, so set-dedup equals the adjacent-dedup Tercom performs."""
    out: List[int] = []
    for slot in range(target_start - 1, target_start + length):
        if slot == -1:
            idx = 0
        elif slot in alignments:
            idx = alignments[slot] + 1
        else:
            break
        if not out or idx != out[-1]:
            out.append(idx)
    return out


def _shift_words(
    pred_words: List[str],
    target_words: List[str],
    checked_candidates: int,
) -> Tuple[int, List[str], int]:
    """One round of the greedy Tercom shift search; returns the best gain."""
    edit_distance, inv_trace = _levenshtein_with_trace(pred_words, target_words)
    alignments, target_errors, pred_errors = _trace_to_alignment(_flip_trace(inv_trace))

    def gain_of(shifted: List[str]) -> int:
        return edit_distance - _levenshtein_with_trace(shifted, target_words)[0]

    best: Optional[tuple] = None
    for pred_start, target_start, length in _find_shifted_pairs(pred_words, target_words):
        span_already_right = sum(pred_errors[pred_start : pred_start + length]) == 0
        target_span_matched = sum(target_errors[target_start : target_start + length]) == 0
        shifts_within_itself = pred_start <= alignments[target_start] < pred_start + length
        if span_already_right or target_span_matched or shifts_within_itself:
            continue
        for idx in _candidate_insertion_points(alignments, target_start, length):
            shifted_words = _perform_shift(pred_words, pred_start, length, idx)
            # ties prefer longer blocks, then earlier sources, then earlier targets
            candidate = (gain_of(shifted_words), length, -pred_start, -idx, shifted_words)
            checked_candidates += 1
            if best is None or candidate > best:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break
    if best is None:
        return 0, pred_words, checked_candidates
    return best[0], best[4], checked_candidates


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> float:
    """Shifts + remaining edit distance between one hypothesis and one reference."""
    if len(target_words) == 0:
        return 0.0
    num_shifts = 0
    checked_candidates = 0
    input_words = pred_words
    while True:
        delta, new_input_words, checked_candidates = _shift_words(input_words, target_words, checked_candidates)
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input_words
    edit_distance, _ = _levenshtein_with_trace(input_words, target_words)
    return float(num_shifts + edit_distance)


def _compute_sentence_statistics(pred_words: List[str], target_words: List[List[str]]) -> Tuple[float, float]:
    tgt_lengths = 0.0
    best_num_edits = 2e16
    for tgt_words in target_words:
        # NOTE: argument order follows the reference (ter.py:371): the reference
        # sentence is the one being shifted toward the hypothesis
        num_edits = _translation_edit_rate(tgt_words, pred_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    avg_tgt_len = tgt_lengths / len(target_words) if target_words else 0.0
    return best_num_edits, avg_tgt_len


def _compute_ter_score_from_statistics(num_edits: float, tgt_length: float) -> float:
    if tgt_length > 0 and num_edits > 0:
        return num_edits / tgt_length
    if tgt_length == 0 and num_edits > 0:
        return 1.0
    return 0.0


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
) -> Tuple[float, float, List[float]]:
    """Per-call (total_edits, total_target_length, sentence_ter) contribution."""
    preds = _as_list(preds)
    target = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    total_num_edits = 0.0
    total_tgt_length = 0.0
    sentence_ter: List[float] = []
    for pred, tgt in zip(preds, target):
        tgt_words_ = [tokenizer(_tgt.rstrip()).split() for _tgt in tgt]
        pred_words_ = tokenizer(pred.rstrip()).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words_, tgt_words_)
        total_num_edits += num_edits
        total_tgt_length += tgt_length
        sentence_ter.append(_compute_ter_score_from_statistics(num_edits, tgt_length))
    return total_num_edits, total_tgt_length, sentence_ter


def _ter_compute(total_num_edits, total_tgt_length, device=None) -> torch.Tensor:
    """The corpus rate of the two sums, on ``device`` (the edits' device when they are a
    tensor, else the card when None)."""
    if device is None and isinstance(total_num_edits, torch.Tensor):
        device = total_num_edits.device
    score = _compute_ter_score_from_statistics(float(total_num_edits), float(total_tgt_length))
    return _host_tensor(score, torch.float32, device)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Corpus TER (Tercom/sacrebleu-compatible block-shift edit rate), on ``device``
    (the card when None).

    Example:
        >>> from torchmetrics_tpu_torch.functional import translation_edit_rate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> translation_edit_rate(preds, target, device="cpu")
        tensor(0.1538)
    """
    _check_ter_flags(normalize, no_punctuation, lowercase, asian_support)
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    total_num_edits, total_tgt_length, sentence_ter = _ter_update(preds, target, tokenizer)
    score = _ter_compute(total_num_edits, total_tgt_length, device)
    if return_sentence_level_score:
        return score, _host_tensor(sentence_ter, torch.float32, device)
    return score


def _check_ter_flags(normalize, no_punctuation, lowercase, asian_support) -> None:
    for name, val in (
        ("normalize", normalize), ("no_punctuation", no_punctuation),
        ("lowercase", lowercase), ("asian_support", asian_support),
    ):
        if not isinstance(val, bool):
            raise ValueError(f"Expected argument `{name}` to be of type boolean but got {val}.")
