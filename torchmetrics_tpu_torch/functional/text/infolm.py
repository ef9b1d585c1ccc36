"""InfoLM (counterpart of ``torchmetrics_tpu/functional/text/infolm.py``; Colombo et al.,
AAAI 2022).

Information measures between masked-LM token distributions of predicted and reference
sentences. The distribution of a sentence is the (idf-weighted) average over positions
of ``softmax(logits[pos] / temperature)`` with position ``pos`` masked out. The JAX
package runs one forward a position over a batch of sentences; here the masked copies
of a batch's sentences (one for each of its positions) go through the masked LM
together, ``batch_size`` copies a forward, on ``device`` (the card when None), with
TF32 off. Each copy's softmax is the one the JAX loop takes at that position, and the
weighted copies add in float64 into their sentence's row, rounded once to float32.
Copies of zero weight (pads, ``[CLS]``, ``[SEP]``, tokens of zero idf) are not run: in
the JAX loop they add exact zeros.

The masked LM is pluggable through the same seam BERTScore uses: ``model_name_or_path``
loads a HF ``AutoModelForMaskedLM`` from the *local* cache (no download), or ``model`` +
``user_tokenizer`` supply a custom pipeline: ``model(input_ids, attention_mask)`` on
int64 tensors on ``device`` returns ``(batch, tokens, vocab)`` logits.

As in the JAX package, sentences keep their input order (the reference applies its
length-sorting permutation twice; see ``bert.py``).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...utilities.checks import resolve_device
from ...utilities.imports import _TRANSFORMERS_AVAILABLE
from ..image.utils import _ieee_float32
from .bert import _on

_ALLOWED_INFORMATION_MEASURE = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)


class _InformationMeasure:
    """Information measures over ``(batch, vocab)`` float32 distributions.

    Validation rules mirror the reference (``functional/text/infolm.py:104-136``):
    alpha required (and not in {0, 1}) for alpha divergence, not 1 for Rényi;
    beta required (not in {0, -1}) for beta divergence; AB divergence needs
    alpha, beta and alpha+beta all nonzero.
    """

    def __init__(
        self,
        information_measure: str,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
    ) -> None:
        if information_measure not in _ALLOWED_INFORMATION_MEASURE:
            raise ValueError(
                f"Argument `information_measure` expected one of {_ALLOWED_INFORMATION_MEASURE}, "
                f"got {information_measure}"
            )
        self.information_measure = information_measure
        needs_alpha = ("alpha_divergence", "ab_divergence", "renyi_divergence")
        if information_measure in needs_alpha and not isinstance(alpha, float):
            raise ValueError(f"Parameter `alpha` is expected to be defined for {information_measure}.")
        if information_measure in ("beta_divergence", "ab_divergence") and not isinstance(beta, float):
            raise ValueError(f"Parameter `beta` is expected to be defined for {information_measure}.")
        if information_measure == "alpha_divergence" and (not isinstance(alpha, float) or alpha in (0, 1)):
            raise ValueError(
                f"Parameter `alpha` is expected to be float differened from 0 and 1 for {information_measure}."
            )
        if information_measure == "beta_divergence" and (not isinstance(beta, float) or beta in (0, -1)):
            raise ValueError(
                f"Parameter `beta` is expected to be float differened from 0 and -1 for {information_measure}."
            )
        if information_measure == "ab_divergence" and (
            alpha is None or beta is None or 0 in (alpha, beta, alpha + beta)
        ):
            raise ValueError(
                "Parameters `alpha`, `beta` and their sum are expected to be differened from 0 for "
                f"{information_measure}."
            )
        if information_measure == "renyi_divergence" and (not isinstance(alpha, float) or alpha == 1):
            raise ValueError(f"Parameter `alpha` is expected to be float differened from 1 for {information_measure}.")
        self.alpha = alpha or 0.0
        self.beta = beta or 0.0

    def __call__(self, preds_dist: torch.Tensor, target_dist: torch.Tensor) -> torch.Tensor:
        fn = getattr(self, f"_{self.information_measure}")
        return torch.nan_to_num(fn(preds_dist, target_dist))

    @staticmethod
    def _kl_divergence(p, t):
        return torch.sum(t * torch.log(p / t), dim=-1)

    def _alpha_divergence(self, p, t):
        a = self.alpha
        return (1 - torch.sum(t**a * p ** (1 - a), dim=-1)) / (a * (a - 1))

    def _ab_divergence(self, p, t, alpha: Optional[float] = None):
        a = self.alpha if alpha is None else alpha
        b = self.beta
        x = torch.log(torch.sum(t ** (b + a), dim=-1)) / (b * (b + a))
        y = torch.log(torch.sum(p ** (b + a), dim=-1)) / (a * (b + a))
        z = torch.log(torch.sum(t**a * p**b, dim=-1)) / (a * b)
        return x + y - z

    def _beta_divergence(self, p, t):
        return self._ab_divergence(p, t, alpha=1.0)

    def _renyi_divergence(self, p, t):
        a = self.alpha
        return torch.log(torch.sum(t**a * p ** (1 - a), dim=-1)) / (a - 1)

    @staticmethod
    def _l1_distance(p, t):
        return torch.sum(torch.abs(t - p), dim=-1)

    @staticmethod
    def _l2_distance(p, t):
        return torch.sqrt(torch.sum((t - p) ** 2, dim=-1))

    @staticmethod
    def _l_infinity_distance(p, t):
        return torch.amax(torch.abs(t - p), dim=-1)

    @staticmethod
    def _fisher_rao_distance(p, t):
        return 2 * torch.arccos(torch.clamp(torch.sqrt(p * t).sum(-1), 0, 1))


def _load_hf_masked_lm(model_name_or_path: str, device: torch.device):
    """The local HF tokenizer, a forward ``(ids, mask) -> logits`` of the masked LM on
    ``device`` and the config's ``max_length``."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`infolm` metric with default models requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.4` or `pip install torchmetrics[text]`."
        )
    from transformers import AutoModelForMaskedLM, AutoTokenizer

    try:
        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
        hf_model = AutoModelForMaskedLM.from_pretrained(model_name_or_path, local_files_only=True)
    except OSError as err:
        raise ModuleNotFoundError(
            f"Model {model_name_or_path!r} is not in the local HF cache and this environment has "
            "no network egress to download it. Pre-populate the cache offline, or pass "
            "`model` + `user_tokenizer` for a custom masked-LM pipeline."
        ) from err
    hf_model = _on(hf_model, device)

    def forward(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return hf_model(input_ids=input_ids, attention_mask=attention_mask).logits

    forward.model = hf_model
    max_length = getattr(hf_model.config, "max_length", 512)
    return tokenizer, forward, max_length


def _special_tokens_map(tokenizer: Any) -> Dict[str, int]:
    """mask/pad/sep/cls ids (reference ``functional/text/infolm.py:322-339``)."""
    return {
        "mask_token_id": tokenizer.mask_token_id,
        "pad_token_id": tokenizer.pad_token_id,
        "sep_token_id": tokenizer.sep_token_id,
        "cls_token_id": tokenizer.cls_token_id,
    }


def _token_mask(input_ids: torch.Tensor, special: Dict[str, int]) -> torch.Tensor:
    """1 for content tokens, 0 for pad/sep/cls (reference ``infolm.py:342-365``)."""
    bad = (
        (input_ids == special["pad_token_id"])
        | (input_ids == special["sep_token_id"])
        | (input_ids == special["cls_token_id"])
    )
    return ~bad


def _tokens_idf(input_ids: np.ndarray) -> Dict[int, float]:
    """log((N+1)/(df+1)) over full padded rows; the reference counts special and pad
    tokens too (``helper_embedding_metric.py:242-261``), which zeroes their idf."""
    num = input_ids.shape[0]
    df: Counter = Counter()
    for row in input_ids:
        df.update(set(row.tolist()))
    weights = {tok: float(np.log((num + 1) / (cnt + 1))) for tok, cnt in df.items()}
    weights["__default__"] = float(np.log(num + 1))
    return weights


def _sentence_distributions(
    forward: Callable,
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    temperature: float,
    idf: bool,
    special: Dict[str, int],
    batch_size: int,
    device: torch.device,
) -> torch.Tensor:
    """(B, vocab) float32 distribution a sentence on ``device``: the idf-weighted average
    over positions of the MLM's softened softmax with that position masked."""
    num = input_ids.shape[0]
    idf_lookup = _tokens_idf(input_ids) if idf else None
    chunks = []
    for start in range(0, num, batch_size):
        ids_np = input_ids[start : start + batch_size]
        mask_np = attention_mask[start : start + batch_size]
        # trim to the batch's longest attended sequence (reference collator)
        l_eff = int(mask_np.sum(1).max()) if ids_np.size else 0
        ids = torch.as_tensor(ids_np[:, :l_eff], device=device).long()
        mask = torch.as_tensor(mask_np[:, :l_eff], device=device).long()
        weight = _token_mask(ids, special).to(torch.float32)
        if idf:
            default = idf_lookup["__default__"]
            idf_w = np.vectorize(lambda t: idf_lookup.get(int(t), default), otypes=[np.float32])(ids_np[:, :l_eff])
            weight = weight * torch.as_tensor(idf_w, device=device)
        rows = ids.shape[0]
        if l_eff == 0:
            chunks.append(torch.full((rows, 1), torch.nan, dtype=torch.float32, device=device))
            continue
        # a (sentence, position) copy with that position masked, sentence-major, for each
        # position of nonzero weight: the JAX loop's copies of pads, [CLS], [SEP] and
        # idf-0 tokens add exact zeros (one kept if none has weight, for the vocabulary)
        kept = torch.nonzero(weight.reshape(-1)).reshape(-1)
        kept = kept if kept.numel() else torch.zeros(1, dtype=torch.long, device=device)
        owner, positions = kept // l_eff, kept % l_eff
        copies = ids[owner]
        copies[torch.arange(copies.shape[0], device=device), positions] = special["mask_token_id"]
        copy_mask = mask[owner]
        copy_weight = weight.reshape(-1)[kept]
        acc = None
        for first in range(0, copies.shape[0], batch_size):
            part = slice(first, first + batch_size)
            with _ieee_float32():
                logits = forward(copies[part], copy_mask[part])
            picked = logits[torch.arange(logits.shape[0], device=device), positions[part]].to(torch.float32)
            prob = torch.softmax(picked / temperature, dim=-1) * copy_weight[part, None]
            if acc is None:
                acc = torch.zeros((rows, prob.shape[-1]), dtype=torch.float64, device=device)
            acc.index_add_(0, owner[part], prob.to(torch.float64))
        denom = weight.sum(1)
        chunks.append(acc.to(torch.float32) / denom[:, None])
    if not chunks:
        return torch.zeros((0, 1), dtype=torch.float32, device=device)
    return torch.cat(chunks)


def _infolm_prepare(
    model_name_or_path: Optional[str],
    model: Optional[Callable],
    user_tokenizer: Any,
    max_length: Optional[int],
    device: torch.device,
) -> Tuple[Any, Callable, int, Dict[str, int]]:
    if model is not None:
        if user_tokenizer is None:
            raise ValueError("A custom `model` must be accompanied by a `user_tokenizer`.")
        tokenizer, forward = user_tokenizer, _on(model, device)
        max_len = max_length or 512
    else:
        tokenizer, forward, model_max = _load_hf_masked_lm(model_name_or_path or "bert-base-uncased", device)
        max_len = max_length or model_max
    return tokenizer, forward, max_len, _special_tokens_map(tokenizer)


def _infolm_tokenize(tokenizer: Any, texts: Sequence[str], max_length: int) -> Dict[str, np.ndarray]:
    out = tokenizer(list(texts), padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
    return {"input_ids": np.asarray(out["input_ids"]), "attention_mask": np.asarray(out["attention_mask"])}


def _infolm_compute(
    forward: Callable,
    preds_tok: Dict[str, np.ndarray],
    target_tok: Dict[str, np.ndarray],
    temperature: float,
    idf: bool,
    measure: _InformationMeasure,
    special: Dict[str, int],
    batch_size: int,
    device: torch.device,
) -> torch.Tensor:
    preds_dist = _sentence_distributions(
        forward, preds_tok["input_ids"], preds_tok["attention_mask"], temperature, idf, special, batch_size, device
    )
    target_dist = _sentence_distributions(
        forward, target_tok["input_ids"], target_tok["attention_mask"], temperature, idf, special, batch_size, device
    )
    return measure(preds_dist, target_dist)


def infolm(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
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
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Corpus-level InfoLM score on ``device`` (the card when None).

    ``model``/``user_tokenizer`` extend the reference surface with the BERTScore seam,
    so any masked LM can drive the pipeline.
    """
    device = resolve_device(device)
    preds = [preds] if isinstance(preds, str) else list(preds)
    target = [target] if isinstance(target, str) else list(target)
    measure = _InformationMeasure(information_measure, alpha, beta)
    tokenizer, forward, max_len, special = _infolm_prepare(model_name_or_path, model, user_tokenizer, max_length,
                                                           device)
    preds_tok = _infolm_tokenize(tokenizer, preds, max_len)
    target_tok = _infolm_tokenize(tokenizer, target, max_len)
    scores = _infolm_compute(forward, preds_tok, target_tok, temperature, idf, measure, special, batch_size, device)
    if return_sentence_level_score:
        return scores.mean(), scores
    return scores.mean()
