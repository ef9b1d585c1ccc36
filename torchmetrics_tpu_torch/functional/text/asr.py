"""ASR error rates: CER / WER / MER / WIL / WIP (counterpart of
``torchmetrics_tpu/functional/text/asr.py``).

All five share one host-side tokenize + edit-distance pass and differ only in which
counts they keep; the rates are float32 quotients of the counts, on ``device`` (the
card when None).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from .helper import _as_list, _edit_distance, _host_tensor

TextInput = Union[str, Sequence[str]]


def _asr_counts(preds: TextInput, target: TextInput, char_level: bool) -> Tuple[float, float, float, float]:
    """Returns (edit_errors, sum_max_len, target_total, preds_total)."""
    preds = _as_list(preds)
    target = _as_list(target)
    errors = total = target_total = preds_total = 0.0
    for pred, tgt in zip(preds, target):
        pred_tokens = list(pred) if char_level else pred.split()
        tgt_tokens = list(tgt) if char_level else tgt.split()
        errors += _edit_distance(pred_tokens, tgt_tokens)
        total += max(len(tgt_tokens), len(pred_tokens))
        target_total += len(tgt_tokens)
        preds_total += len(pred_tokens)
    return errors, total, target_total, preds_total


def _rate_compute(errors: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return errors / total


_cer_compute = _wer_compute = _mer_compute = _rate_compute


def _wil_compute(errors: torch.Tensor, target_total: torch.Tensor, preds_total: torch.Tensor) -> torch.Tensor:
    return 1 - ((errors / target_total) * (errors / preds_total))


def _wip_compute(errors: torch.Tensor, target_total: torch.Tensor, preds_total: torch.Tensor) -> torch.Tensor:
    return (errors / target_total) * (errors / preds_total)


def _counts(values, device) -> Tuple[torch.Tensor, ...]:
    return tuple(_host_tensor(v, torch.float32, device) for v in values)


def char_error_rate(preds: TextInput, target: TextInput, device=None) -> torch.Tensor:
    """CER = character edit distance / reference characters.

    Example:
        >>> from torchmetrics_tpu_torch.functional import char_error_rate
        >>> char_error_rate(['this is the prediction'], ['this is the reference'], device="cpu")
        tensor(0.3810)
    """
    errors, _, target_total, _ = _asr_counts(preds, target, char_level=True)
    return _cer_compute(*_counts((errors, target_total), device))


def word_error_rate(preds: TextInput, target: TextInput, device=None) -> torch.Tensor:
    """WER = word edit distance / reference words.

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_error_rate
        >>> word_error_rate(['this is the prediction'], ['this is the reference'], device="cpu")
        tensor(0.2500)
    """
    errors, _, target_total, _ = _asr_counts(preds, target, char_level=False)
    return _wer_compute(*_counts((errors, target_total), device))


def match_error_rate(preds: TextInput, target: TextInput, device=None) -> torch.Tensor:
    """MER = word edit distance / max(reference, prediction) words.

    Example:
        >>> from torchmetrics_tpu_torch.functional import match_error_rate
        >>> match_error_rate(['this is the prediction'], ['this is the reference'], device="cpu")
        tensor(0.2500)
    """
    errors, total, _, _ = _asr_counts(preds, target, char_level=False)
    return _mer_compute(*_counts((errors, total), device))


def _wil_wip_counts(preds: TextInput, target: TextInput, device) -> Tuple[torch.Tensor, ...]:
    errors, total, target_total, preds_total = _asr_counts(preds, target, char_level=False)
    # the reference folds hits as (edit_sum - maxlen_sum) into its "errors" state
    # (functional/text/wil.py:52), kept for the state layout
    return _counts((errors - total, target_total, preds_total), device)


def word_information_lost(preds: TextInput, target: TextInput, device=None) -> torch.Tensor:
    """WIL = 1 - hit-rate product over reference and prediction lengths.

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_information_lost
        >>> word_information_lost(['this is the prediction'], ['this is the reference'], device="cpu")
        tensor(0.4375)
    """
    return _wil_compute(*_wil_wip_counts(preds, target, device))


def word_information_preserved(preds: TextInput, target: TextInput, device=None) -> torch.Tensor:
    """WIP = hit-rate product over reference and prediction lengths.

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_information_preserved
        >>> word_information_preserved(['this is the prediction'], ['this is the reference'], device="cpu")
        tensor(0.5625)
    """
    return _wip_compute(*_wil_wip_counts(preds, target, device))
