"""BERTScore (counterpart of ``torchmetrics_tpu/functional/text/bert.py``; Zhang et al.,
ICLR 2020).

The contextual embedder is pluggable: ``model_name_or_path`` loads a HF model from the
*local* cache (no download), or ``model`` + ``user_tokenizer`` (+ optional
``user_forward_fn``) supply a custom pipeline. The model runs on ``device`` (the card
when None; an ``nn.Module`` is moved there), and so does everything after it:
normalised embeddings, the special-token mask, the IDF weights and the greedy cosine
matching, one batched ``einsum`` in float32 with TF32 off.

Two changes of layout that leave every value as it is:

- the corpus is cut to its longest attended row before the embedder runs, and each
  embedder batch to its own longest row; the columns cut off are zero embeddings of
  zero weight, and each row already holds zero columns (its masked ``[CLS]`` and
  ``[SEP]``), so no maximum changes. A ``BERTScore`` state padded to ``max_length``
  is scored at the width of its sentences, not at 512.
- as in the JAX package, sentences keep their input order. The reference sorts them by
  length for batching and applies the sorting permutation a second time instead of
  inverting it (its ``functional/text/bert.py:563-567`` indexing with the output of
  ``helper_embedding_metric.py:79-84``), so its per-sentence scores come back
  mis-ordered, and when predictions and references sort differently it matches the
  wrong pairs. This package keeps the JAX package's documented divergence.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...utilities.checks import resolve_device
from ...utilities.imports import _TRANSFORMERS_AVAILABLE
from ..image.utils import _ieee_float32


def _on(model: Any, device: torch.device) -> Any:
    """An ``nn.Module`` moved to ``device`` and put in eval mode; any other callable as it is."""
    if isinstance(model, torch.nn.Module):
        model.to(device).eval()
    return model


def _load_hf(model_name_or_path: str, num_layers: Optional[int], device: torch.device):
    """The local HF tokenizer and a forward ``(ids, mask) -> hidden states`` of the model on
    ``device``."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`bert_score` metric with default models requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.4` or `pip install torchmetrics[text]`."
        )
    from transformers import AutoModel, AutoTokenizer

    try:
        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
        hf_model = AutoModel.from_pretrained(model_name_or_path, local_files_only=True)
    except OSError as err:  # HF raises OSError subclasses for cache misses
        raise ModuleNotFoundError(
            f"Model {model_name_or_path!r} is not in the local HF cache and this environment has "
            "no network egress to download it. Pre-populate the cache offline, or pass "
            "`model` + `user_tokenizer` for a custom embedding pipeline."
        ) from err
    hf_model = _on(hf_model, device)
    layer = num_layers if num_layers is not None else -1

    def forward(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            out = hf_model(input_ids=input_ids, attention_mask=attention_mask, output_hidden_states=True)
        return out.hidden_states[layer]

    forward.model = hf_model
    return tokenizer, forward


def _user_forward(model: Callable, user_forward_fn: Optional[Callable], device: torch.device) -> Callable:
    """The embedder of a user ``model``: ``model(ids, mask)``, or ``user_forward_fn(model,
    {"input_ids": ids, "attention_mask": mask})``, on tensors on ``device``."""
    model = _on(model, device)
    if user_forward_fn is None:
        return model
    return lambda ids, mask: user_forward_fn(model, {"input_ids": ids, "attention_mask": mask})


def _tokenize(tokenizer, texts: List[str], max_length: int, truncation: bool) -> Dict[str, np.ndarray]:
    out = tokenizer(
        texts, padding=True, truncation=truncation, max_length=max_length if truncation else None,
        return_tensors="np",
    )
    return {"input_ids": np.asarray(out["input_ids"]), "attention_mask": np.asarray(out["attention_mask"])}


def _process_attention_mask_for_special_tokens(attention_mask: torch.Tensor) -> torch.Tensor:
    """Zero out the first token (CLS) and the last attended token (SEP) per row
    (reference helper_embedding_metric semantics), as float32."""
    mask = attention_mask.to(torch.float32).clone()
    mask[:, 0] = 0
    last = (attention_mask.sum(dim=1) - 1).clamp(min=0)
    mask[torch.arange(mask.shape[0], device=mask.device), last] = 0
    return mask


def _idf_weights(input_ids: np.ndarray, attention_mask: np.ndarray) -> Dict[int, float]:
    """log((N+1)/(df+1)) document-frequency IDF over the corpus rows; unseen tokens
    default to log(N+1) (reference helper_embedding_metric.py:259-261)."""
    num_docs = input_ids.shape[0]
    df: Counter = Counter()
    for row, mask in zip(input_ids, attention_mask):
        df.update(set(row[mask.astype(bool)].tolist()))
    weights = {tok: float(np.log((num_docs + 1) / (cnt + 1))) for tok, cnt in df.items()}
    weights["__default__"] = float(np.log(num_docs + 1))
    return weights


def _apply_idf(input_ids: np.ndarray, weights: Dict[int, float]) -> np.ndarray:
    default = weights.get("__default__", 0.0)
    lookup = np.vectorize(lambda t: weights.get(int(t), default), otypes=[np.float32])
    return lookup(input_ids)


def _attended_width(attention_mask: np.ndarray) -> int:
    return int(attention_mask.sum(1).max()) if attention_mask.size else 0


def _embed(
    forward: Callable,
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    idf: bool,
    idf_lookup: Optional[Dict[int, float]],
    batch_size: int,
    device: torch.device,
):
    """Normalised, special-token-masked embeddings and per-token scale weights on
    ``device``, each embedder batch cut to its longest attended row and padded back with
    zero columns."""
    width = input_ids.shape[1]
    ids = torch.as_tensor(input_ids, device=device).long()
    mask = torch.as_tensor(attention_mask, device=device).long()
    chunks = []
    for start in range(0, ids.shape[0], batch_size):
        part = slice(start, start + batch_size)
        used = max(_attended_width(attention_mask[part]), 1)
        with _ieee_float32():
            emb = forward(ids[part, :used], mask[part, :used]).to(torch.float32)
        chunks.append(torch.nn.functional.pad(emb, (0, 0, 0, width - used)))
    emb = torch.cat(chunks)
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-12)
    processed_mask = _process_attention_mask_for_special_tokens(mask)
    emb = emb * processed_mask[:, :, None]
    if idf:
        scale = torch.as_tensor(_apply_idf(input_ids, idf_lookup), device=device) * processed_mask
    else:
        scale = processed_mask
    scale = scale / scale.sum(-1, keepdim=True).clamp(min=1e-12)
    return emb, scale


def _score_pairs(p_emb: torch.Tensor, p_scale: torch.Tensor, t_emb: torch.Tensor, t_scale: torch.Tensor):
    """Greedy cosine matching: each token's best match on the other side, weighted."""
    with _ieee_float32():
        cos = torch.einsum("bpd,brd->bpr", p_emb, t_emb)
    precision = (cos.max(dim=2).values * p_scale).sum(-1)
    recall = (cos.max(dim=1).values * t_scale).sum(-1)
    f1 = 2 * precision * recall / (precision + recall).clamp(min=1e-12)
    return precision, recall, f1


def _cut(tok: Dict[str, np.ndarray], width: int) -> Dict[str, np.ndarray]:
    return {k: v[:, :width] for k, v in tok.items()}


def bert_score(
    preds: Union[str, Sequence[str], Dict[str, np.ndarray]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]], Dict[str, np.ndarray]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Callable] = None,
    user_tokenizer: Any = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: Optional[Any] = None,
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 0,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
    truncation: bool = False,
    score_fn: Optional[Callable] = None,
    _forward: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """BERTScore precision/recall/F1 via greedy cosine matching of contextual
    embeddings, on ``device`` (the card when None). Multiple references per prediction
    score as the best F1. A user ``model`` is called as ``model(input_ids,
    attention_mask)`` on int64 tensors on ``device`` and returns ``(batch, tokens,
    dim)`` embeddings. ``score_fn(p_emb, p_scale, t_emb, t_scale) -> (precision, recall,
    f1)`` replaces the matching (:func:`_score_pairs`): the seam through which the
    ``BERTScore`` class runs its AOT-cacheable ``"escore"`` program.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.text import bert_score
        >>> table = torch.eye(8)
        >>> ids = {"input_ids": [[1, 2, 3, 7, 0]], "attention_mask": [[1, 1, 1, 1, 0]]}
        >>> same = bert_score(ids, ids, model=lambda i, m: table[i], device="cpu")
        >>> [round(float(v), 4) for v in same.values()]
        [1.0, 1.0, 1.0]
    """
    if all_layers:
        raise ValueError("`all_layers=True` is only meaningful with per-layer baselines; use num_layers instead.")
    if rescale_with_baseline:
        raise ModuleNotFoundError(
            "`rescale_with_baseline` requires downloading the published baseline files, which an "
            "air-gapped environment cannot do."
        )
    device = resolve_device(device)
    if isinstance(preds, str):
        preds = [preds]
    multi_ref = (
        not isinstance(target, (str, dict))
        and len(target) > 0
        and isinstance(target[0], (list, tuple))
    )
    if _forward is not None:
        forward, tokenizer = _forward, user_tokenizer
    elif model is not None:
        if user_tokenizer is None and not isinstance(preds, dict):
            raise ValueError("The model must be accompanied by a `user_tokenizer` (or pre-tokenized dict inputs).")
        forward, tokenizer = _user_forward(model, user_forward_fn, device), user_tokenizer
    else:
        tokenizer, forward = _load_hf(model_name_or_path or "roberta-large", num_layers, device)
    if multi_ref:
        results = []
        for ref_idx in range(max(len(t) for t in target)):
            flat_refs = [t[min(ref_idx, len(t) - 1)] for t in target]
            results.append(bert_score(preds, flat_refs, user_tokenizer=tokenizer, idf=idf, device=device,
                                      max_length=max_length, batch_size=batch_size, truncation=truncation,
                                      score_fn=score_fn, _forward=forward))
        f1s = torch.stack([r["f1"] for r in results])
        best = torch.argmax(f1s, dim=0)
        pick = lambda key: torch.stack([r[key] for r in results]).gather(0, best[None])[0]
        return {"precision": pick("precision"), "recall": pick("recall"), "f1": pick("f1")}
    if isinstance(target, str):
        target = [target]

    if isinstance(preds, dict):
        preds_tok = {"input_ids": np.asarray(preds["input_ids"]), "attention_mask": np.asarray(preds["attention_mask"])}
        target_tok = {"input_ids": np.asarray(target["input_ids"]), "attention_mask": np.asarray(target["attention_mask"])}
    else:
        preds_tok = _tokenize(tokenizer, list(preds), max_length, truncation)
        target_tok = _tokenize(tokenizer, list(target), max_length, truncation)
    if preds_tok["input_ids"].shape[0] != target_tok["input_ids"].shape[0]:
        raise ValueError("Number of predicted and reference sentences must be the same.")

    idf_lookup = _idf_weights(target_tok["input_ids"], target_tok["attention_mask"]) if idf else None
    width = max(_attended_width(preds_tok["attention_mask"]), _attended_width(target_tok["attention_mask"]), 1)
    preds_tok, target_tok = _cut(preds_tok, width), _cut(target_tok, width)
    p_emb, p_scale = _embed(forward, preds_tok["input_ids"], preds_tok["attention_mask"], idf, idf_lookup,
                            batch_size, device)
    t_emb, t_scale = _embed(forward, target_tok["input_ids"], target_tok["attention_mask"], idf, idf_lookup,
                            batch_size, device)
    precision, recall, f1 = (score_fn or _score_pairs)(p_emb, p_scale, t_emb, t_scale)
    out = {"precision": precision, "recall": recall, "f1": f1}
    if return_hash:
        out["hash"] = f"{model_name_or_path}_L{num_layers}_idf={idf}"
    return out
