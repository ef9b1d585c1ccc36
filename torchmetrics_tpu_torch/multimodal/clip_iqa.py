"""CLIPImageQualityAssessment (counterpart of ``torchmetrics_tpu/multimodal/clip_iqa.py``).

CLIP-IQA scores an image against positive/negative prompt pairs, a two-way softmax over
the two prompt similarities. The embedder follows CLIPScore's pluggable protocol (HF
local cache on the metric's device, or a custom object); the prompt anchors are
computed once and kept on the device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from ..functional.multimodal.clip_score import _move_clip, _resolve_clip
from ..metric import HostMetric
from ..utilities.data import _jax_dtype

_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


class CLIPImageQualityAssessment(HostMetric):
    """Per-image two-way softmax(pos, neg) prompt-pair probabilities: ``(N,)`` for one
    prompt, else ``{prompt: (N,)}``. ``prompts`` entries are built-in names or custom
    ``(positive, negative)`` tuples, numbered ``user_defined_{i}`` among themselves."""

    # extractor attribute FeatureShare dedupes (the JAX package declares the same name)
    feature_network: str = "model"

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        model_name_or_path: Union[str, Any] = "clip_iqa",
        data_range: float = 1.0,
        prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not (isinstance(data_range, (int, float)) and data_range > 0):
            raise ValueError("Argument `data_range` should be a positive number.")
        self.data_range = data_range
        if model_name_or_path == "clip_iqa":
            raise ModuleNotFoundError(
                "The default `clip_iqa` checkpoint requires downloading CLIP-IQA weights, which "
                "an air-gapped environment cannot do. Pass a HF checkpoint present in the local "
                "cache or a custom embedder with get_image_features/get_text_features."
            )
        self.model = _resolve_clip(model_name_or_path, self.device)
        self.prompt_names = []
        self.prompt_pairs = []
        num_user_defined = 0
        for p in prompts:
            if isinstance(p, str):
                if p not in _PROMPTS:
                    raise ValueError(f"Unknown prompt {p}. Available: {sorted(_PROMPTS)}")
                self.prompt_names.append(p)
                self.prompt_pairs.append(_PROMPTS[p])
            elif isinstance(p, tuple) and len(p) == 2:
                self.prompt_names.append(f"user_defined_{num_user_defined}")
                num_user_defined += 1
                self.prompt_pairs.append(p)
            else:
                raise ValueError("Argument `prompts` must contain prompt names or (positive, negative) tuples")
        self._anchors = None
        self.add_state("probs_list", default=[], dist_reduce_fx="cat")

    def _on_device(self, args, kwargs):
        """Images stay where they are: the processor reads them on the host."""
        return tuple(args), dict(kwargs)

    def _prompt_anchors(self) -> torch.Tensor:
        """``(P, 2, D)`` unit text features of the prompt pairs, on the metric's device."""
        if self._anchors is None:
            texts = [t for pair in self.prompt_pairs for t in pair]
            feats = _jax_dtype(torch.as_tensor(self.model.get_text_features(texts), device=self.device))
            feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
            self._anchors = feats.reshape(len(self.prompt_pairs), 2, -1)
        return self._anchors

    def _per_image_probs(self, images) -> torch.Tensor:
        """(N, P) prompt probabilities, shared with the functional one-shot form."""
        from ..functional.multimodal.clip_iqa import _prompt_pair_probs

        return _prompt_pair_probs(self.model, self._prompt_anchors(), images, self.data_range)

    def _host_batch_state(self, images):
        return {"probs_list": self._per_image_probs(images)}

    def _compute(self, state):
        probs = state["probs_list"].reshape(-1, len(self.prompt_names))
        if len(self.prompt_names) == 1:
            return probs.squeeze()  # 0-d for a single image, like the reference
        return {name: probs[:, i] for i, name in enumerate(self.prompt_names)}

    def to(self, device: Union[str, torch.device]) -> "CLIPImageQualityAssessment":
        super().to(device)
        _move_clip(self.model, self.device)
        self._anchors = None
        return self

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, id(self)))
