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


def _tree_allclose(a: Any, b: Any) -> bool:
    """Whether two values (tensors, or dicts, lists and tuples of them) agree to 1e-6."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_allclose(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_allclose(x, y) for x, y in zip(a, b))
    x, y = torch.as_tensor(a).cpu().double(), torch.as_tensor(b).cpu().double()
    return x.shape == y.shape and bool(torch.allclose(x, y, atol=1e-6, equal_nan=True))


def check_forward_full_state_property(
    metric_class,
    init_args: Optional[dict] = None,
    input_args: Optional[dict] = None,
    num_update_to_compare=(10, 100, 1000),
    reps: int = 5,
) -> None:
    """Check whether ``full_state_update=False`` is safe for ``metric_class`` (reference
    ``utilities/checks.py:171``), as the JAX package does it: ``forward``'s batch value
    against a fresh metric's value after one update of the same batch, three times, then
    the timing sweep, printed in the reference's format. ``forward`` computes the batch
    value from the batch's own state, so both of the reference's strategies are the one
    timed here; pass ``device`` in ``init_args`` (the card by default).
    """
    import time as _time

    init_args = init_args or {}
    input_args = input_args or {}
    metric = metric_class(**init_args)
    for _ in range(3):
        batch_val = metric(**input_args)
        fresh = metric_class(**init_args)
        fresh.update(**input_args)
        if not _tree_allclose(batch_val, fresh.compute()):
            print("Recommended setting `full_state_update=True`")
            return
    for steps in num_update_to_compare:
        best = float("inf")
        for _ in range(reps):
            m = metric_class(**init_args)
            start = _time.perf_counter()
            for _ in range(steps):
                m(**input_args)
            if m.device.type == "cuda":
                torch.cuda.synchronize(m.device)
            best = min(best, _time.perf_counter() - start)
        print(f"Full state for {steps} steps took: {best}")
        print(f"Partial state for {steps} steps took: {best}")
    print("Recommended setting `full_state_update=False`")
