"""Device resolution for the port's entry points, and input checks (counterpart of
``torchmetrics_tpu/utilities/checks.py``)."""

from __future__ import annotations

from typing import Any, Optional, Union

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


def _as_tensor(x: Any) -> torch.Tensor:
    """A tensor stays where it is; anything else becomes a tensor on the default device
    (``resolve_device(None)``), so nothing runs on the CPU unless asked."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=resolve_device(None))


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise if the shapes differ (metadata only: no sync with the device)."""
    if tuple(preds.shape) != tuple(target.shape):
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
