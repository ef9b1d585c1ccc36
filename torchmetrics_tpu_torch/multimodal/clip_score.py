"""CLIPScore metric class (counterpart of ``torchmetrics_tpu/multimodal/clip_score.py``)."""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from ..functional.multimodal.clip_score import _clip_score_features, _move_clip, _resolve_clip
from ..metric import Metric


class CLIPScore(Metric):
    """Running-mean CLIP score: a float32 ``score`` sum and an int32 ``n_samples``. The
    embedder is a HF checkpoint (local cache only) on the metric's device, or a custom
    object with ``get_image_features``/``get_text_features``.

    The JAX package pads each feature batch to a power-of-two bucket for ``jax.jit``
    and masks the padded rows out; the port scores the batch as it is, which gives the
    same sums (padded rows add exactly 0). The norm guard ``max(|x|, 1e-8)`` is the
    class's, as in the JAX package; the function has none.
    """

    # extractor attribute FeatureShare dedupes (the JAX package declares the same name)
    feature_network: str = "model"

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(
        self,
        model_name_or_path: Union[str, Any] = "openai/clip-vit-large-patch14",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model = _resolve_clip(model_name_or_path, self.device)
        self.add_state("score", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _on_device(self, args, kwargs):
        """Images stay where they are: the processor reads them on the host."""
        return tuple(args), dict(kwargs)

    def _prepare_inputs(self, source, target) -> Tuple[tuple, dict]:
        src, tgt = _clip_score_features(source, target, self.model, self.device)
        return (src.to(torch.float32), tgt.to(torch.float32)), {}

    def _batch_state(self, source_features, target_features) -> Dict[str, torch.Tensor]:
        s = source_features / torch.linalg.vector_norm(source_features, dim=-1, keepdim=True).clamp(min=1e-8)
        t = target_features / torch.linalg.vector_norm(target_features, dim=-1, keepdim=True).clamp(min=1e-8)
        score = (100 * (s * t).sum(dim=-1)).sum()
        n = torch.full((), source_features.shape[0], dtype=torch.int32, device=score.device)
        return {"score": score, "n_samples": n}

    def _compute(self, state):
        return torch.clamp(state["score"] / state["n_samples"], min=0.0)

    def to(self, device: Union[str, torch.device]) -> "CLIPScore":
        super().to(device)
        _move_clip(self.model, self.device)
        return self

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, id(self)))
