"""Model-backed metrics with user-supplied extractors: FID and CLIPScore
(counterpart of ``examples/fid_clipscore_custom_extractor.py``).

Every model-backed metric takes its network through a seam — any callable (an
``nn.Module``, a function of tensors, a converted pipeline) — so air-gapped
environments and custom backbones work identically to the stock pretrained path: pass
nothing and the stock InceptionV3 / CLIP loads from converted weights or the local HF
cache instead.

The toy CLIP embeds a word by ``zlib.crc32``, the same in every process (Python's
``hash`` of a string changes with ``PYTHONHASHSEED``).

Run: ``python -m torchmetrics_tpu_torch.examples.fid_clipscore_custom_extractor --device cpu``
(the card without ``--device``).
"""

from __future__ import annotations

import argparse
import json
import sys
import zlib

import numpy as np
import torch

PROJECTION_SEED = 1


def tiny_projection() -> np.ndarray:
    """The extractor's fixed (6, 64) projection of the per-channel moments."""
    return (np.random.default_rng(PROJECTION_SEED).normal(size=(6, 64)) / 6.0).astype(np.float32)


class TinyExtractor:
    """``(N, 3, H, W) -> (N, 64)``: per-channel mean and standard deviation, projected."""

    def __init__(self, device) -> None:
        self.proj = torch.from_numpy(tiny_projection()).to(device)

    def __call__(self, imgs: torch.Tensor) -> torch.Tensor:
        pooled = imgs.reshape(imgs.shape[0], 3, -1).float()
        moments = torch.cat([pooled.mean(-1), pooled.std(-1, correction=0)], dim=-1)  # (N, 6)
        return moments @ self.proj


class ToyClip:
    """A CLIP stand-in: an image by its first 48 values, a caption by the sum of its
    words' rows of ``emb`` (a word's row by ``zlib.crc32``)."""

    def __init__(self, emb: np.ndarray, device) -> None:
        self.emb, self.device = emb, device

    def get_image_features(self, images):
        return torch.stack([torch.as_tensor(i, dtype=torch.float32, device=self.device).reshape(-1)[:48]
                            for i in images])

    def get_text_features(self, texts):
        rows = [self.emb[[zlib.crc32(w.encode()) % 512 for w in t.split()]].sum(0) for t in texts]
        return torch.from_numpy(np.stack(rows)).to(self.device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchmetrics_tpu_torch.examples.fid_clipscore_custom_extractor",
        description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)

    from ..image import FrechetInceptionDistance
    from ..multimodal import CLIPScore
    from ..utilities.checks import cli_device

    device = cli_device(parser, args.device)
    rng = np.random.default_rng(0)

    # ---- FID with a custom feature extractor ------------------------------------
    fid = FrechetInceptionDistance(feature=TinyExtractor(device), normalize=True, device=device)
    real = rng.random((64, 3, 32, 32)).astype(np.float32)
    fake = (rng.random((64, 3, 32, 32)) * 0.8).astype(np.float32)
    fid.update(torch.from_numpy(real).to(device), real=True)
    fid.update(torch.from_numpy(fake).to(device), real=False)
    fid_value = float(fid.compute())
    print("FID (custom extractor):", round(fid_value, 4))

    # ---- CLIPScore with a custom image/text embedder ----------------------------
    emb = rng.normal(size=(512, 48)).astype(np.float32)
    clip_score = CLIPScore(model_name_or_path=ToyClip(emb, device), device=device)
    images = [torch.from_numpy(rng.random((3, 16, 16)).astype(np.float32)).to(device) for _ in range(8)]
    captions = [f"a photo of object {i}" for i in range(8)]
    clip_score.update(images, captions)
    clip_value = float(clip_score.compute())
    print("CLIPScore (custom embedder):", round(clip_value, 4))
    print(json.dumps({"fid": fid_value, "clip_score": clip_value}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
