"""SQuAD exact-match / F1 (counterpart of ``torchmetrics_tpu/functional/text/squad.py``)."""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Tuple

import torch

from ...utilities.prints import rank_zero_warn
from .helper import _host_tensor

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}


def _normalize_text(s: str) -> str:
    """Lowercase, strip punctuation/articles, squeeze whitespace (SQuAD official)."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _get_tokens(s: str) -> List[str]:
    return _normalize_text(s).split() if s else []


def _compute_f1_score(predicted_answer: str, target_answer: str) -> float:
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    common = Counter(target_tokens) & Counter(predicted_tokens)
    num_same = sum(common.values())
    if len(target_tokens) == 0 or len(predicted_tokens) == 0:
        return float(target_tokens == predicted_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(predicted_tokens)
    recall = num_same / len(target_tokens)
    return (2 * precision * recall) / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(metric_fn: Callable, prediction: str, ground_truths: List[str]) -> float:
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(preds, targets) -> Tuple[Dict[str, str], List[Dict[str, Any]]]:
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]
    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key string.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                f"Please make sure that 'answer' maps to a `SQuAD` format dictionary.\nSQuAD Format: {SQuAD_FORMAT}"
            )
    preds_dict = {prediction["id"]: prediction["prediction_text"] for prediction in preds}
    _fn_answer = lambda tgt: {"answers": [{"text": txt} for txt in tgt["answers"]["text"]], "id": tgt["id"]}
    targets_dict = [{"paragraphs": [{"qas": [_fn_answer(target) for target in targets]}]}]
    return preds_dict, targets_dict


def _squad_update(preds: Dict[str, str], target: List[Dict[str, Any]]) -> Tuple[float, float, int]:
    """Returns (f1_sum, exact_match_sum, total)."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    rank_zero_warn(f"Unanswered question {qa['id']} will receive score 0.")
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                prediction = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, prediction, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, prediction, ground_truths)
    return f1, exact_match, total


def _squad_compute(f1, exact_match, total, device=None) -> Dict[str, torch.Tensor]:
    """Percentages: of float32 states in float32 (as the JAX class computes them), of
    host numbers in float64 rounded once (as the JAX function does), on ``device``."""
    if isinstance(f1, torch.Tensor):
        return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}
    return {
        "exact_match": _host_tensor(100.0 * exact_match / total, torch.float32, device),
        "f1": _host_tensor(100.0 * f1 / total, torch.float32, device),
    }


def squad(preds, target, device=None) -> Dict[str, torch.Tensor]:
    """SQuAD v1 exact-match and token-F1 over prediction/target answer dicts, on
    ``device`` (the card when None).

    Example:
        >>> from torchmetrics_tpu_torch.functional import squad
        >>> preds = [{'prediction_text': '1976', 'id': '56e1'}]
        >>> target = [{'answers': {'answer_start': [97], 'text': ['1976']}, 'id': '56e1'}]
        >>> {k: round(float(v), 4) for k, v in squad(preds, target, device="cpu").items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_dict, target_dict = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, target_dict)
    return _squad_compute(f1, exact_match, total, device)
