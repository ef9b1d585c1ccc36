"""Text tower: stateless functions (counterpart of ``torchmetrics_tpu/functional/text``).

The string metrics take ``device`` (the card when None) for their results; Perplexity
runs where its logits are; BERTScore and InfoLM run their models on ``device``."""

from .asr import (
    char_error_rate,
    match_error_rate,
    word_error_rate,
    word_information_lost,
    word_information_preserved,
)
from .bert import bert_score
from .bleu import bleu_score
from .chrf import chrf_score
from .edit import edit_distance
from .eed import extended_edit_distance
from .infolm import infolm
from .perplexity import perplexity
from .rouge import rouge_score
from .sacre_bleu import sacre_bleu_score
from .squad import squad
from .ter import translation_edit_rate

__all__ = [
    "bert_score",
    "infolm",
    "bleu_score",
    "char_error_rate",
    "chrf_score",
    "edit_distance",
    "extended_edit_distance",
    "match_error_rate",
    "perplexity",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
