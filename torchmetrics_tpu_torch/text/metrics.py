"""Text metric classes (counterpart of ``torchmetrics_tpu/text/metrics.py``).

The string metrics are ``HostMetric``s: their Python string work runs on the host in
``_host_batch_state`` and gives the JAX package's states, made on the metric's device
(the card by default): float32 and int32 sums, and cat rows for ROUGE, EED, the
sentence-level scores and ``EditDistance(reduction="none")``. Perplexity is a device
``Metric``. BERTScore and InfoLM keep the tokenized sentences as int32 cat states and
run their model on the metric's device at ``compute``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import aot as _aot
from ..functional.text.asr import (
    _asr_counts,
    _cer_compute,
    _mer_compute,
    _wer_compute,
    _wil_compute,
    _wip_compute,
)
from ..functional.text.bert import (_attended_width, _cut, _embed, _idf_weights, _load_hf, _score_pairs, _tokenize,
                                    _user_forward, bert_score)
from ..functional.text.bleu import _bleu_score_compute, _bleu_score_update, _resolve_weights, _tokenize_fn
from ..functional.text.chrf import _chrf_score_compute, _chrf_score_update, _validate_chrf_args
from ..functional.text.edit import _edit_distance_compute, _edit_distance_update
from ..functional.text.eed import _check_eed_params, _eed_compute, _eed_update
from ..functional.text.helper import _host_tensor, _mean32
from ..functional.text.infolm import _infolm_compute, _infolm_prepare, _infolm_tokenize, _InformationMeasure
from ..functional.text.perplexity import _perplexity_compute, _perplexity_update
from ..functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    _make_stemmer,
    _resolve_rouge_keys,
    _rouge_inputs,
    _rouge_score_update,
)
from ..functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from ..functional.text.squad import _squad_compute, _squad_input_check, _squad_update
from ..functional.text.ter import _check_ter_flags, _ter_compute, _ter_update, _TercomTokenizer
from ..metric import HostMetric, Metric


def _zeros(shape=(), dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype)


class _TextMetric(HostMetric):
    """A host metric whose batch states are made on its device."""

    def _tensor(self, value: Any, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return _host_tensor(value, dtype, self.device)


class BLEUScore(_TextMetric):
    """Corpus BLEU (reference ``text/bleu.py:34``; states ``text/bleu.py:92-95``).

    Example:
        >>> from torchmetrics_tpu_torch.text import BLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> metric = BLEUScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.7598)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self, n_gram: int = 4, smooth: bool = False, weights: Optional[Sequence[float]] = None, **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        self.weights = _resolve_weights(n_gram, weights)
        self.tokenizer: Callable = _tokenize_fn
        self.add_state("preds_len", _zeros(), dist_reduce_fx="sum")
        self.add_state("target_len", _zeros(), dist_reduce_fx="sum")
        self.add_state("numerator", _zeros(self.n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", _zeros(self.n_gram), dist_reduce_fx="sum")

    def _host_batch_state(self, preds: Sequence[str], target: Sequence[Union[str, Sequence[str]]]):
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
        numerator, denominator, preds_len, target_len = _bleu_score_update(
            preds_, target_, self.n_gram, self.tokenizer
        )
        return {
            "numerator": self._tensor(numerator),
            "denominator": self._tensor(denominator),
            "preds_len": self._tensor(preds_len),
            "target_len": self._tensor(target_len),
        }

    def _compute(self, state):
        return _bleu_score_compute(
            state["preds_len"], state["target_len"], state["numerator"], state["denominator"],
            self.n_gram, self.weights, self.smooth,
        )


class SacreBLEUScore(BLEUScore):
    """BLEU with sacrebleu tokenization (reference ``text/sacre_bleu.py:35``).

    Example:
        >>> from torchmetrics_tpu_torch.text import SacreBLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> metric = SacreBLEUScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.7598)
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)


class _ASRMetric(_TextMetric):
    """Shared shell for CER/WER/MER: (errors, total) float32 sum states."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    _char_level = False
    _total_is_max = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", _zeros(), dist_reduce_fx="sum")
        self.add_state("total", _zeros(), dist_reduce_fx="sum")

    def _host_batch_state(self, preds, target):
        errors, total_max, target_total, _ = _asr_counts(preds, target, char_level=self._char_level)
        return {
            "errors": self._tensor(errors),
            "total": self._tensor(total_max if self._total_is_max else target_total),
        }


class CharErrorRate(_ASRMetric):
    """Character error rate (reference ``text/cer.py:29``).

    Example:
        >>> from torchmetrics_tpu_torch.text import CharErrorRate
        >>> metric = CharErrorRate(device="cpu")
        >>> metric.update(['this is the prediction'], ['this is the reference'])
        >>> metric.compute()
        tensor(0.3810)
    """

    _char_level = True

    def _compute(self, state):
        return _cer_compute(state["errors"], state["total"])


class WordErrorRate(_ASRMetric):
    """Word error rate (reference ``text/wer.py:29``).

    Example:
        >>> from torchmetrics_tpu_torch.text import WordErrorRate
        >>> metric = WordErrorRate(device="cpu")
        >>> metric.update(['this is the prediction'], ['this is the reference'])
        >>> metric.compute()
        tensor(0.2500)
    """

    def _compute(self, state):
        return _wer_compute(state["errors"], state["total"])


class MatchErrorRate(_ASRMetric):
    """Match error rate (reference ``text/mer.py:29``).

    Example:
        >>> from torchmetrics_tpu_torch.text import MatchErrorRate
        >>> metric = MatchErrorRate(device="cpu")
        >>> metric.update(['this is the prediction'], ['this is the reference'])
        >>> metric.compute()
        tensor(0.2500)
    """

    _total_is_max = True

    def _compute(self, state):
        return _mer_compute(state["errors"], state["total"])


class _WordInfoMetric(_TextMetric):
    is_differentiable = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", _zeros(), dist_reduce_fx="sum")
        self.add_state("target_total", _zeros(), dist_reduce_fx="sum")
        self.add_state("preds_total", _zeros(), dist_reduce_fx="sum")

    def _host_batch_state(self, preds, target):
        errors, total, target_total, preds_total = _asr_counts(preds, target, char_level=False)
        return {
            "errors": self._tensor(errors - total),
            "target_total": self._tensor(target_total),
            "preds_total": self._tensor(preds_total),
        }


class WordInfoLost(_WordInfoMetric):
    """Word information lost (reference ``text/wil.py:28``).

    Example:
        >>> from torchmetrics_tpu_torch.text import WordInfoLost
        >>> metric = WordInfoLost(device="cpu")
        >>> metric.update(['this is the prediction'], ['this is the reference'])
        >>> metric.compute()
        tensor(0.4375)
    """

    higher_is_better = False

    def _compute(self, state):
        return _wil_compute(state["errors"], state["target_total"], state["preds_total"])


class WordInfoPreserved(_WordInfoMetric):
    """Word information preserved (reference ``text/wip.py:28``).

    Example:
        >>> from torchmetrics_tpu_torch.text import WordInfoPreserved
        >>> metric = WordInfoPreserved(device="cpu")
        >>> metric.update(['this is the prediction'], ['this is the reference'])
        >>> metric.compute()
        tensor(0.5625)
    """

    higher_is_better = True

    def _compute(self, state):
        return _wip_compute(state["errors"], state["target_total"], state["preds_total"])


class EditDistance(_TextMetric):
    """Levenshtein edit distance (reference ``text/edit.py:30``): int32 sums, or the
    distances as cat rows with ``reduction="none"``.

    Example:
        >>> from torchmetrics_tpu_torch.text import EditDistance
        >>> metric = EditDistance(device="cpu")
        >>> metric.update(['rain'], ['shine'])
        >>> metric.compute()
        tensor(3.)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, substitution_cost: int = 1, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(substitution_cost, int) and substitution_cost >= 0):
            raise ValueError(
                f"Expected argument `substitution_cost` to be a positive integer, but got {substitution_cost}"
            )
        allowed_reduction = (None, "mean", "sum", "none")
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction}, but got {reduction}")
        self.substitution_cost = substitution_cost
        self.reduction = reduction
        if self.reduction in ("none", None):
            self.add_state("edit_scores_list", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("edit_scores", default=_zeros(dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("num_elements", default=_zeros(dtype=torch.int32), dist_reduce_fx="sum")

    def _host_batch_state(self, preds, target):
        distance = _edit_distance_update(preds, target, self.substitution_cost, self.device)
        if self.reduction in ("none", None):
            return {"edit_scores_list": distance}
        return {
            "edit_scores": distance.sum(dtype=torch.int32),
            "num_elements": self._tensor(distance.numel(), torch.int32),
        }

    def _compute(self, state):
        if self.reduction in ("none", None):
            return _edit_distance_compute(state["edit_scores_list"].to(torch.int32), 1, self.reduction)
        return _edit_distance_compute(state["edit_scores"], state["num_elements"], self.reduction)


class CHRFScore(_TextMetric):
    """chrF/chrF++ (reference ``text/chrf.py:53``): six per-order count vectors.

    Example:
        >>> from torchmetrics_tpu_torch.text import CHRFScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> metric = CHRFScore(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.4942)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    _COUNTS = ("preds_char", "preds_word", "target_char", "target_word", "matching_char", "matching_word")

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _validate_chrf_args(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)
        for name in self._COUNTS:
            order = n_char_order if "char" in name else n_word_order
            self.add_state(f"total_{name}_n_grams", _zeros(order), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf_score", default=[], dist_reduce_fx="cat")

    def _host_batch_state(self, preds, target):
        *counts, sentence_scores = _chrf_score_update(
            preds, target, self.n_char_order, self.n_word_order, self.beta, self.lowercase, self.whitespace
        )
        out = {f"total_{name}_n_grams": self._tensor(count) for name, count in zip(self._COUNTS, counts)}
        if self.return_sentence_level_score:
            out["sentence_chrf_score"] = self._tensor(sentence_scores)
        return out

    def _compute(self, state):
        score = _chrf_score_compute(*(state[f"total_{name}_n_grams"] for name in self._COUNTS), self.n_order,
                                    self.beta)
        if self.return_sentence_level_score:
            return score, state["sentence_chrf_score"]
        return score


class SQuAD(_TextMetric):
    """SQuAD EM/F1 (reference ``text/squad.py:35``).

    Example:
        >>> from torchmetrics_tpu_torch.text import SQuAD
        >>> preds = [{'prediction_text': '1976', 'id': '56e10a3be3433e1400422b22'}]
        >>> target = [{'answers': {'answer_start': [97], 'text': ['1976']}, 'id': '56e10a3be3433e1400422b22'}]
        >>> metric = SQuAD(device="cpu")
        >>> metric.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", _zeros(), dist_reduce_fx="sum")
        self.add_state("exact_match", _zeros(), dist_reduce_fx="sum")
        self.add_state("total", _zeros(dtype=torch.int32), dist_reduce_fx="sum")

    def _host_batch_state(self, preds, target):
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, target_dict)
        return {
            "f1_score": self._tensor(f1),
            "exact_match": self._tensor(exact_match),
            "total": self._tensor(total, torch.int32),
        }

    def _compute(self, state):
        return _squad_compute(state["f1_score"], state["exact_match"], state["total"])


class Perplexity(Metric):
    """Perplexity (reference ``text/perplexity.py:29``): a device update, two float32 sums.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import Perplexity
        >>> preds = torch.tensor([[[0.2, 0.4, 0.4], [0.5, 0.2, 0.3]]])
        >>> target = torch.tensor([[1, 0]])
        >>> metric = Perplexity(device="cpu")
        >>> metric.update(torch.log(preds), target)
        >>> metric.compute()
        tensor(2.2361)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", default=_zeros(), dist_reduce_fx="sum")
        self.add_state("count", default=_zeros(), dist_reduce_fx="sum")

    def _batch_state(self, preds, target):
        total_log_probs, count = _perplexity_update(preds, target, self.ignore_index)
        return {"total_log_probs": total_log_probs.to(torch.float32), "count": count.to(torch.float32)}

    def _compute(self, state):
        return _perplexity_compute(state["total_log_probs"], state["count"])


class ROUGEScore(_TextMetric):
    """ROUGE-N/L/Lsum (reference ``text/rouge.py:37``): per-sentence cat rows per rouge
    key and statistic.

    Example:
        >>> from torchmetrics_tpu_torch.text import ROUGEScore
        >>> metric = ROUGEScore(rouge_keys='rouge1', device="cpu")
        >>> metric.update(['the cat is on the mat'], [['a cat is on the mat']])
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'rouge1_fmeasure': 0.8333, 'rouge1_precision': 0.8333, 'rouge1_recall': 0.8333}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )
        self.rouge_keys, self.rouge_keys_values = _resolve_rouge_keys(rouge_keys)
        self.stemmer = _make_stemmer(use_stemmer)
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        for rouge_key in self.rouge_keys:
            for score in ("fmeasure", "precision", "recall"):
                self.add_state(f"{rouge_key}_{score}", default=[], dist_reduce_fx="cat")

    def _host_batch_state(self, preds, target):
        preds, target = _rouge_inputs(preds, target)
        results = _rouge_score_update(
            preds, target, self.rouge_keys_values, self.accumulate, self.stemmer, self.normalizer, self.tokenizer
        )
        return {
            f"{rouge_key}_{score}": self._tensor([s[score] for s in results[key_value]])
            for rouge_key, key_value in zip(self.rouge_keys, self.rouge_keys_values)
            for score in ("fmeasure", "precision", "recall")
        }

    def _compute(self, state):
        return {
            key: _mean32(state[key])
            for key in (f"{rk}_{sc}" for rk in self.rouge_keys for sc in ("fmeasure", "precision", "recall"))
        }


class TranslationEditRate(_TextMetric):
    """TER (reference ``text/ter.py:30``): two float32 sums and, optionally, the
    sentence-level rates as cat rows.

    Example:
        >>> from torchmetrics_tpu_torch.text import TranslationEditRate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> metric = TranslationEditRate(device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.4286)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_ter_flags(normalize, no_punctuation, lowercase, asian_support)
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("total_num_edits", _zeros(), dist_reduce_fx="sum")
        self.add_state("total_tgt_len", _zeros(), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", default=[], dist_reduce_fx="cat")

    def _host_batch_state(self, preds, target):
        total_num_edits, total_tgt_length, sentence_ter = _ter_update(preds, target, self.tokenizer)
        out = {"total_num_edits": self._tensor(total_num_edits), "total_tgt_len": self._tensor(total_tgt_length)}
        if self.return_sentence_level_score:
            out["sentence_ter"] = self._tensor(sentence_ter)
        return out

    def _compute(self, state):
        score = _ter_compute(state["total_num_edits"], state["total_tgt_len"])
        if self.return_sentence_level_score:
            return score, state["sentence_ter"]
        return score


class ExtendedEditDistance(_TextMetric):
    """EED (reference ``text/eed.py:29``): the sentence scores as cat rows.

    Example:
        >>> from torchmetrics_tpu_torch.text import ExtendedEditDistance
        >>> metric = ExtendedEditDistance(device="cpu")
        >>> metric.update(['this is the prediction'], [['this is the reference']])
        >>> metric.compute()
        tensor(0.3835)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        _check_eed_params(alpha, rho, deletion, insertion)
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion
        self.add_state("sentence_eed", default=[], dist_reduce_fx="cat")

    def _host_batch_state(self, preds, target):
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        return {"sentence_eed": self._tensor(scores)}

    def _compute(self, state):
        average = _eed_compute(state["sentence_eed"])
        if self.return_sentence_level_score:
            return average, state["sentence_eed"]
        return average


def _token_states(metric: HostMetric) -> None:
    for name in ("preds_input_ids", "preds_attention_mask", "target_input_ids", "target_attention_mask"):
        metric.add_state(name, default=[], dist_reduce_fx="cat")


def _host_rows(state, prefix: str) -> dict:
    """A side's tokenized rows back on the host, for the tokenizer-side steps."""
    return {key: state[f"{prefix}_{key}"].cpu().numpy() for key in ("input_ids", "attention_mask")}


class _EscoreProgram(torch.nn.Module):
    """BERTScore's matching in the AOT plane's calling convention (no states)."""

    def forward(self, tensors: dict, n: torch.Tensor, args: tuple, kwargs: dict):
        return _score_pairs(*args)


def _bucket(n: int, floor: int = 4) -> int:
    """Round up to the next power of two (compile-cache friendliness)."""
    b = floor
    while b < n:
        b *= 2
    return b


class BERTScore(_TextMetric):
    """BERTScore (reference ``text/bert.py:59``): the tokenized sentences, padded to
    ``max_length``, as int32 cat states on the metric's device (reference
    ``text/bert.py:220``); the embedder and the matching run there at ``compute``. The
    HF model, or a user ``model`` that is an ``nn.Module``, moves to the metric's device.
    With the AOT plane active the matching runs as the ``"escore"`` program: each scoring
    batch zero-padded to power-of-two (batch, token) buckets, so a few cached programs
    serve every size, and ``precompile`` writes it ahead of traffic.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import BERTScore
        >>> class Chars:
        ...     def __call__(self, texts, **kw):
        ...         ids = [[1] + [2 + ord(c) % 6 for c in t] + [0] for t in texts]
        ...         return {"input_ids": ids, "attention_mask": [[1] * len(r) for r in ids]}
        >>> metric = BERTScore(model=lambda i, m: torch.eye(8)[i], user_tokenizer=Chars(), max_length=8,
        ...                    device="cpu")
        >>> metric.update(["abc"], ["abc"])
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'precision': 1.0, 'recall': 1.0, 'f1': 1.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Callable] = None,
        user_tokenizer: Optional[Any] = None,
        user_forward_fn: Optional[Callable] = None,
        verbose: bool = False,
        idf: bool = False,
        max_length: int = 512,
        batch_size: int = 64,
        return_hash: bool = False,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        baseline_path: Optional[str] = None,
        truncation: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if all_layers:
            raise ValueError(
                "`all_layers=True` is only meaningful with per-layer baselines; use num_layers instead."
            )
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.idf = idf
        self.verbose = verbose
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_hash = return_hash
        self.lang = lang
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path
        self.truncation = truncation
        self.model_name_or_path = model_name_or_path
        if model is not None:
            if user_tokenizer is None:
                raise ValueError("The model must be accompanied by a `user_tokenizer`.")
            self._forward = _user_forward(model, user_forward_fn, self.device)
            self.tokenizer = user_tokenizer
        else:
            self.tokenizer, self._forward = _load_hf(model_name_or_path or "roberta-large", num_layers, self.device)
        _token_states(self)

    def _host_batch_state(self, preds, target):
        preds = [preds] if isinstance(preds, str) else list(preds)
        target = [target] if isinstance(target, str) else list(target)
        p = _tokenize(self.tokenizer, preds, self.max_length, self.truncation)
        t = _tokenize(self.tokenizer, target, self.max_length, self.truncation)
        for tok in (p, t):
            if tok["input_ids"].shape[1] > self.max_length:
                raise ValueError(
                    f"Tokenized input of length {tok['input_ids'].shape[1]} exceeds max_length="
                    f"{self.max_length}. Enable `truncation=True` or raise `max_length`."
                )
        pad = lambda arr: self._tensor(np.pad(arr, ((0, 0), (0, self.max_length - arr.shape[1]))), torch.int32)
        return {
            "preds_input_ids": pad(p["input_ids"]),
            "preds_attention_mask": pad(p["attention_mask"]),
            "target_input_ids": pad(t["input_ids"]),
            "target_attention_mask": pad(t["attention_mask"]),
        }

    def _compute(self, state):
        return bert_score(
            _host_rows(state, "preds"), _host_rows(state, "target"), user_tokenizer=self.tokenizer, idf=self.idf,
            device=self.device, max_length=self.max_length, batch_size=self.batch_size,
            return_hash=self.return_hash, lang=self.lang, rescale_with_baseline=self.rescale_with_baseline,
            baseline_path=self.baseline_path, truncation=self.truncation, _forward=self._forward,
            score_fn=self._dispatch_escore if _aot._ACTIVE is not None else None,
        )

    # --------------------------------------------------- the matching ("escore")

    def _aot_program(self, tag: str) -> torch.nn.Module:
        if tag == "escore":
            return _EscoreProgram()
        return super()._aot_program(tag)

    @staticmethod
    def _pad_escore(p_emb, p_scale, t_emb, t_scale) -> Tuple[tuple, int]:
        """Zero-pad one scoring batch to power-of-two (batch, token) buckets. A padded
        token scores 0 against every token, as the masked special tokens already do, so
        no maximum moves; padded rows are cut off."""
        batch, length = p_emb.shape[0], max(p_emb.shape[1], t_emb.shape[1])
        b_cap, l_cap = _bucket(max(batch, 1), floor=4), _bucket(max(length, 1), floor=8)
        pad3 = lambda a: torch.nn.functional.pad(a, (0, 0, 0, l_cap - a.shape[1], 0, b_cap - a.shape[0]))  # noqa: E731
        pad2 = lambda a: torch.nn.functional.pad(a, (0, l_cap - a.shape[1], 0, b_cap - a.shape[0]))  # noqa: E731
        return (pad3(p_emb), pad2(p_scale), pad3(t_emb), pad2(t_scale)), batch

    def _dispatch_escore(self, p_emb, p_scale, t_emb, t_scale):
        """``score_fn`` seam of :func:`bert_score`: pad to buckets, run the matching
        through the AOT plane (a cached program, or the eager matching), cut the real
        rows back."""
        padded, batch = self._pad_escore(p_emb, p_scale, t_emb, t_scale)
        precision, recall, f1 = self._program_dispatch("escore", {}, (padded, {}), lambda: _score_pairs(*padded))
        return precision[:batch], recall[:batch], f1[:batch]

    def precompile(
        self,
        *example_inputs: Any,
        tags: Sequence[str] = ("escore",),
        cache_dir: Optional[str] = None,
        force: bool = False,
        **example_kwargs: Any,
    ) -> Dict[str, Any]:
        """Ahead-of-traffic export and compile of the ``"escore"`` matching program.

        ``example_inputs`` is one ``(preds, target)`` sentence batch: it is tokenized and
        embedded as ``compute`` would (the model runs), and the bucketed signature is
        compiled into the active (or ``cache_dir``) AOT cache. Other tags get the host
        metric's no-op rows."""
        tags = tuple(tags)
        rest = tuple(t for t in tags if t != "escore")
        report = super().precompile(*example_inputs, tags=rest, **example_kwargs) if rest else {}
        if "escore" not in tags:
            return report
        plane = self._aot_plane(cache_dir)
        preds, target = example_inputs
        preds = [preds] if isinstance(preds, str) else list(preds)
        target = [target] if isinstance(target, str) else list(target)
        p = _tokenize(self.tokenizer, preds, self.max_length, self.truncation)
        t = _tokenize(self.tokenizer, target, self.max_length, self.truncation)
        width = max(_attended_width(p["attention_mask"]), _attended_width(t["attention_mask"]), 1)
        p, t = _cut(p, width), _cut(t, width)
        idf_lookup = _idf_weights(t["input_ids"], t["attention_mask"]) if self.idf else None
        p_emb, p_scale = _embed(self._forward, p["input_ids"], p["attention_mask"], self.idf, idf_lookup,
                                self.batch_size, self.device)
        t_emb, t_scale = _embed(self._forward, t["input_ids"], t["attention_mask"], self.idf, idf_lookup,
                                self.batch_size, self.device)
        padded, _ = self._pad_escore(p_emb, p_scale, t_emb, t_scale)
        report["escore"] = plane.precompile_program(self, "escore", self._aot_program("escore"), {}, padded, {},
                                                    force=force)
        return report


class InfoLM(_TextMetric):
    """InfoLM (reference ``text/infolm.py:42``): information measures over masked-LM
    token distributions (``functional/text/infolm.py``). States are the tokenized
    sentences, padded to ``max_length``, as four int64 cat states on the metric's device
    (reference ``text/infolm.py:168-171``); the masked LM runs there at ``compute``.

    ``model_name_or_path`` loads ``AutoModelForMaskedLM`` from the local HF cache (no
    download) onto the metric's device, or ``model`` + ``user_tokenizer`` supply a custom
    pipeline (the BERTScore seam).
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        model_name_or_path: str = "bert-base-uncased",
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        device: Optional[Any] = None,
        max_length: Optional[int] = None,
        batch_size: int = 64,
        num_threads: int = 0,
        verbose: bool = True,
        return_sentence_level_score: bool = False,
        model: Optional[Callable] = None,
        user_tokenizer: Any = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        self.temperature = temperature
        self.idf = idf
        self.batch_size = batch_size
        self.return_sentence_level_score = return_sentence_level_score
        self._measure = _InformationMeasure(information_measure, alpha, beta)
        self._tokenizer, self._forward, self.max_length, self._special = _infolm_prepare(
            model_name_or_path, model, user_tokenizer, max_length, self.device
        )
        _token_states(self)

    def _host_batch_state(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> dict:
        preds = [preds] if isinstance(preds, str) else list(preds)
        target = [target] if isinstance(target, str) else list(target)
        p = _infolm_tokenize(self._tokenizer, preds, self.max_length)
        t = _infolm_tokenize(self._tokenizer, target, self.max_length)
        # int64, as the JAX package keeps the tokenizer's numpy rows here
        return {
            "preds_input_ids": self._tensor(p["input_ids"], torch.int64),
            "preds_attention_mask": self._tensor(p["attention_mask"], torch.int64),
            "target_input_ids": self._tensor(t["input_ids"], torch.int64),
            "target_attention_mask": self._tensor(t["attention_mask"], torch.int64),
        }

    def _compute(self, state):
        scores = _infolm_compute(
            self._forward, _host_rows(state, "preds"), _host_rows(state, "target"), self.temperature, self.idf,
            self._measure, self._special, self.batch_size, self.device,
        )
        if self.return_sentence_level_score:
            return scores.mean(), scores
        return scores.mean()
