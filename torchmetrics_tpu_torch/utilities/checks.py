"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Without CUDA, only an explicit CPU device is accepted: the port never falls back
    to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torchmetrics_tpu_torch runs on CUDA by default, but no CUDA device is available. "
            "Pass device='cpu' to run on the CPU explicitly."
        )
    return dev

