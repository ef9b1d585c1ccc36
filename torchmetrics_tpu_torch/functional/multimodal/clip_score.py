"""CLIPScore (counterpart of ``torchmetrics_tpu/functional/multimodal/clip_score.py``).

The embedder is pluggable: ``model_name_or_path`` is a HF CLIP checkpoint, loaded with
``local_files_only=True`` onto ``device`` (the card when None) through the seam of
``functional/text/bert.py``, or any object exposing ``get_image_features(images) ->
(N, D)`` and ``get_text_features(texts) -> (N, D)``, taken as it is (an ``nn.Module``
is moved to ``device``). The HF processor runs on the host, as in the JAX package, and
its ``pixel_values`` and token ids move to the device once a batch; the model's
products run with TF32 off. The scoring, paired cosine similarity x 100 clamped at 0,
runs on the device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ...utilities.checks import resolve_device
from ...utilities.data import _jax_dtype
from ...utilities.imports import _TRANSFORMERS_AVAILABLE
from ..image.utils import _ieee_float32
from ..text.bert import _on


def _detect_modality(input_data) -> str:
    if hasattr(input_data, "shape"):
        return "image"
    if isinstance(input_data, list):
        if len(input_data) == 0:
            raise ValueError("Empty input list")
        if hasattr(input_data[0], "shape"):
            return "image"
        if isinstance(input_data[0], str):
            return "text"
    if isinstance(input_data, str):
        return "text"
    raise ValueError("Could not automatically determine modality for input_data")


def _process_image_data(images) -> List:
    images = [images] if hasattr(images, "shape") and images.ndim == 3 else list(images)
    if not all(hasattr(i, "shape") and i.ndim == 3 for i in images):
        raise ValueError("Expected all images to be 3d but found image that has either more or less")
    return images


def _process_text_data(texts) -> List[str]:
    return [texts] if not isinstance(texts, list) else texts


def _host_array(image: Any) -> np.ndarray:
    return image.detach().cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)


def _projected(out: Any) -> torch.Tensor:
    """The projected embeddings of ``get_*_features``: a tensor under transformers 4, the
    ``pooler_output`` of the output object that transformers 5 returns."""
    return out if isinstance(out, torch.Tensor) else out.pooler_output


class _HFClipWrapper:
    """Adapts a HF CLIPModel + CLIPProcessor to the pluggable embedder protocol, the
    model on ``device``. The image processor is the one that needs no torchvision
    (``CLIPImageProcessorPil`` where transformers has it, else ``CLIPImageProcessor``)."""

    def __init__(self, model_name_or_path: str, device: torch.device) -> None:
        if not _TRANSFORMERS_AVAILABLE:
            raise ModuleNotFoundError(
                "`clip_score` metric requires `transformers` package be installed."
                " Either install with `pip install transformers>=4.10.0` or `pip install torchmetrics[multimodal]`."
            )
        import transformers
        from transformers import AutoTokenizer, CLIPModel, CLIPProcessor

        image_processor_cls = getattr(transformers, "CLIPImageProcessorPil", transformers.CLIPImageProcessor)
        try:
            model = CLIPModel.from_pretrained(model_name_or_path, local_files_only=True)
            self.processor = CLIPProcessor(
                image_processor=image_processor_cls.from_pretrained(model_name_or_path, local_files_only=True),
                tokenizer=AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True),
            )
        except OSError as err:  # HF raises OSError subclasses for cache misses
            raise ModuleNotFoundError(
                f"CLIP checkpoint {model_name_or_path!r} is not in the local HF cache and this "
                "environment has no network egress to download it. Pre-populate the cache offline, "
                "or pass a custom embedder object with get_image_features/get_text_features."
            ) from err
        self.device = device
        self.model = _on(model, device)

    def to(self, device: torch.device) -> "_HFClipWrapper":
        self.device = device
        self.model.to(device)
        return self

    def pixel_values(self, images) -> torch.Tensor:
        processed = self.processor(images=[_host_array(i) for i in images], return_tensors="pt", padding=True)
        return processed["pixel_values"].to(self.device)

    def get_image_features(self, images) -> torch.Tensor:
        pixel_values = self.pixel_values(images)
        with torch.no_grad(), _ieee_float32():
            return _projected(self.model.get_image_features(pixel_values=pixel_values))

    def tokens(self, texts: List[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        processed = self.processor(text=texts, return_tensors="pt", padding=True)
        ids, mask = processed["input_ids"], processed["attention_mask"]
        max_pos = getattr(getattr(self.model.config, "text_config", None), "max_position_embeddings", None)
        if max_pos is not None and mask.shape[-1] > max_pos:
            ids, mask = ids[..., :max_pos], mask[..., :max_pos]
        return ids.to(self.device), mask.to(self.device)

    def get_text_features(self, texts: List[str]) -> torch.Tensor:
        ids, mask = self.tokens(texts)
        with torch.no_grad(), _ieee_float32():
            return _projected(self.model.get_text_features(input_ids=ids, attention_mask=mask))


def _move_clip(model: Any, device: torch.device) -> None:
    """A metric's embedder follows the metric to ``device`` (a FeatureShare cache or a
    plain callable stays as it is)."""
    if isinstance(model, (torch.nn.Module, _HFClipWrapper)):
        model.to(device)


def _resolve_clip(model_name_or_path: Union[str, Any], device: torch.device):
    if isinstance(model_name_or_path, str):
        return _HFClipWrapper(model_name_or_path, device)
    if hasattr(model_name_or_path, "get_image_features") and hasattr(model_name_or_path, "get_text_features"):
        return _on(model_name_or_path, device)
    raise ValueError(
        "Expected `model_name_or_path` to be a HF checkpoint string or an object with "
        "get_image_features/get_text_features."
    )


def _get_features(data, modality: str, model, device: torch.device) -> torch.Tensor:
    if modality == "image":
        feats = model.get_image_features(data)
    elif modality == "text":
        feats = model.get_text_features(data)
    else:
        raise ValueError(f"invalid modality {modality}")
    return _jax_dtype(torch.as_tensor(feats, device=device))


def _clip_score_features(source, target, model, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate one batch and run the embedder: the ``(N, D)`` feature pair on ``device``."""
    source_modality = _detect_modality(source)
    target_modality = _detect_modality(target)
    source_data = _process_image_data(source) if source_modality == "image" else _process_text_data(source)
    target_data = _process_image_data(target) if target_modality == "image" else _process_text_data(target)
    if len(source_data) != len(target_data):
        raise ValueError(
            "Expected the number of source and target examples to be the same but got "
            f"{len(source_data)} and {len(target_data)}"
        )
    return (_get_features(source_data, source_modality, model, device),
            _get_features(target_data, target_modality, model, device))


def _clip_score_update(source, target, model, device: torch.device) -> Tuple[torch.Tensor, int]:
    source_features, target_features = _clip_score_features(source, target, model, device)
    n_samples = source_features.shape[0]
    source_features = source_features / torch.linalg.vector_norm(source_features, dim=-1, keepdim=True)
    target_features = target_features / torch.linalg.vector_norm(target_features, dim=-1, keepdim=True)
    score = 100 * (source_features * target_features).sum(dim=-1)
    return score, n_samples


def clip_score(
    source,
    target,
    model_name_or_path: Union[str, Any] = "openai/clip-vit-large-patch14",
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    r"""CLIPScore: ``max(100 * cos(E_source, E_target), 0)`` averaged over pairs;
    source/target can each be images or texts. Runs on ``device`` (CUDA when None)."""
    device = resolve_device(device)
    model = _resolve_clip(model_name_or_path, device)
    score, _ = _clip_score_update(source, target, model, device)
    return torch.clamp(score.mean(), min=0.0)
