"""SacreBLEU (counterpart of ``torchmetrics_tpu/functional/text/sacre_bleu.py``; the
tokenizers follow the public sacrebleu definitions, whose rules are the compatibility
surface).

Supported tokenizers: ``none``, ``13a`` (default), ``zh``, ``intl`` (needs the
``regex`` package), ``char``. The mecab/flores tokenizers require optional wheels not
present in this environment and raise a clear error.
"""

from __future__ import annotations

import re
from typing import ClassVar, Optional, Sequence, Union

import torch

from ...utilities.imports import _REGEX_AVAILABLE
from .bleu import _bleu_score_compute, _bleu_score_update, _bleu_states, _resolve_weights

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")
_UCODE_RANGES = (
    ("㐀", "䶵"), ("一", "龥"), ("龦", "龻"), ("豈", "鶴"),
    ("侮", "頻"), ("並", "龎"), (" 0", "⩭6"), ("⾀0", "⾡d"),
    ("＀", "￯"), ("⺀", "⻿"), ("　", "〿"), ("㇀", "㇯"),
    ("⼀", "⿟"), ("⿰", "⿿"), ("㄀", "ㄯ"), ("ㆠ", "ㆿ"),
    ("︐", "︙"), ("︰", "﹏"), ("☀", "⛿"), ("✀", "➿"),
    ("㈀", "㋿"), ("㌀", "㏿"),
)


class _SacreBLEUTokenizer:
    """WMT-style tokenizers (sacrebleu semantics)."""

    _REGEX = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    )
    _TOKENIZE_FN: ClassVar[dict] = {
        "none": "_tokenize_base",
        "13a": "_tokenize_13a",
        "zh": "_tokenize_zh",
        "intl": "_tokenize_international",
        "char": "_tokenize_char",
    }

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        self._check_tokenizers_validity(tokenize)
        self.tokenize_fn = getattr(self, self._TOKENIZE_FN[tokenize])
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized_line = self.tokenize_fn(line)
        return self._lower(tokenized_line, self.lowercase).split()

    @classmethod
    def _check_tokenizers_validity(cls, tokenize: str) -> None:
        if tokenize not in cls._TOKENIZE_FN:
            raise ValueError(
                f"Argument `tokenize` expected to be one of {list(cls._TOKENIZE_FN)} but got {tokenize}."
            )
        if tokenize == "intl" and not _REGEX_AVAILABLE:
            raise ModuleNotFoundError(
                "`'intl'` tokenization requires that `regex` is installed. Use `pip install regex`."
            )

    @staticmethod
    def _lower(line: str, lowercase: bool) -> str:
        return line.lower() if lowercase else line

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for _re, repl in cls._REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @staticmethod
    def _is_chinese_char(uchar: str) -> bool:
        return any(start <= uchar <= end for start, end in _UCODE_RANGES)

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
        return cls._tokenize_regex(f" {line} ")

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        line_in_chars = ""
        for char in line:
            if cls._is_chinese_char(char):
                line_in_chars += f" {char} "
            else:
                line_in_chars += char
        return cls._tokenize_regex(line_in_chars)

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        import regex

        int_regex = (
            (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
            (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
            (regex.compile(r"(\p{S})"), r" \1 "),
        )
        for _re, repl in int_regex:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(char for char in line)

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        cls._check_tokenizers_validity(tokenize)
        tokenized_line = getattr(cls, cls._TOKENIZE_FN[tokenize])(line)
        return cls._lower(tokenized_line, lowercase).split()


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    device=None,
) -> torch.Tensor:
    """BLEU with sacrebleu's standardized tokenization pipeline, on ``device`` (the card
    when None).

    Example:
        >>> from torchmetrics_tpu_torch.functional import sacre_bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> sacre_bleu_score(preds, target, device="cpu")
        tensor(0.7598)
    """
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target_)}")
    weights = _resolve_weights(n_gram, weights)
    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    numerator, denominator, preds_len, target_len = _bleu_states(
        _bleu_score_update(preds, target_, n_gram, tokenizer), device
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
