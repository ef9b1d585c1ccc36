"""One-shot functional CLIP-IQA (counterpart of
``torchmetrics_tpu/functional/multimodal/clip_iqa.py``).

Unlike the class metric (which averages over accumulated images), the functional
form returns PER-IMAGE prompt probabilities: a ``(N,)`` tensor for a single
prompt, else ``{prompt_name: (N,)}``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ...utilities.data import _jax_dtype
from ..image.utils import _ieee_float32
from .clip_score import _host_array


def _prompt_pair_probs(model, anchors: torch.Tensor, images, data_range: float) -> torch.Tensor:
    """(N, P) probabilities that each image matches the positive prompt of each pair.

    Stable two-way softmax: the sigmoid of the logit difference (a raw exp overflows
    float32 for |cosine| > ~0.887 at the x100 scale). The images are scaled on the host
    in float32, where the processor reads them.
    """
    if isinstance(images, torch.Tensor):
        host = images.detach().cpu()
    elif isinstance(images, (list, tuple)):
        host = torch.as_tensor(np.stack([_host_array(i) for i in images]))
    else:
        host = torch.as_tensor(np.asarray(images))
    host = host.to(torch.float32) / data_range
    img_feats = _jax_dtype(torch.as_tensor(model.get_image_features(list(host)), device=anchors.device))
    img_feats = img_feats / torch.linalg.vector_norm(img_feats, dim=-1, keepdim=True)
    with _ieee_float32():
        logits = 100 * torch.einsum("nd,pcd->npc", img_feats, anchors)
    return torch.sigmoid(logits[..., 0] - logits[..., 1])


def clip_image_quality_assessment(
    images,
    model_name_or_path: Union[str, Any] = "clip_iqa",
    data_range: float = 1.0,
    prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
    device: Optional[Union[str, torch.device]] = None,
) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-image CLIP-IQA probabilities on ``device`` (CUDA when None)."""
    from ...multimodal.clip_iqa import CLIPImageQualityAssessment

    metric = CLIPImageQualityAssessment(
        model_name_or_path=model_name_or_path, data_range=data_range, prompts=prompts, device=device
    )
    probs = _prompt_pair_probs(metric.model, metric._prompt_anchors(), images, metric.data_range)
    if len(metric.prompt_names) == 1:
        return probs.squeeze()  # 0-d for a single image, like the reference
    return {name: probs[:, i] for i, name in enumerate(metric.prompt_names)}
