"""MultioutputWrapper (counterpart of ``torchmetrics_tpu/wrappers/multioutput.py``): one
copy of a single-output metric per slice of an output dimension, with NaN rows removed
per output.

Each output's slice is an ``index_select``; the rows kept are a ``nonzero`` of the NaN
mask, one host read per output per update, as the JAX package's ``flatnonzero``."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..metric import Metric, _to_device
from .abstract import WrapperMetric


def _nan_rows(*tensors: torch.Tensor) -> torch.Tensor:
    """Rows (dim-0 indices) where any input holds a NaN."""
    mask = None
    for a in tensors:
        flat = torch.isnan(a.reshape(a.shape[0], -1)).any(dim=-1) if a.ndim > 1 else torch.isnan(a)
        mask = flat if mask is None else (mask | flat)
    return mask


class MultioutputWrapper(WrapperMetric):
    """Evaluate ``base_metric`` independently along ``output_dim`` slices.

    Args:
        base_metric: single-output metric to replicate.
        num_outputs: number of slices along ``output_dim``.
        output_dim: dimension to slice inputs along.
        remove_nans: drop dim-0 rows holding a NaN in any input (per output slice).
        squeeze_outputs: squeeze the selected slice's output dim before updating.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MultioutputWrapper
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> preds = torch.tensor([[1.0, 10.0], [2.0, 20.0], [3.0, 30.0]])
        >>> target = torch.tensor([[1.0, 11.0], [2.0, 22.0], [3.0, 33.0]])
        >>> metric = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2)
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([0.0000, 4.6667])
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(base_metric, **kwargs)
        self.metrics = [base_metric.clone() for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs
        self._adopt_device()

    def _slice_inputs(self, *args: Any, **kwargs: Any) -> List[Tuple[tuple, dict]]:
        args = tuple(_to_device(a, self.device) for a in args)
        kwargs = {k: _to_device(v, self.device) for k, v in kwargs.items()}
        out = []
        for i in range(len(self.metrics)):
            index = torch.tensor([i], device=self.device)

            def sel(a):
                return a.index_select(self.output_dim, index) if isinstance(a, torch.Tensor) else a

            sargs = tuple(sel(a) for a in args)
            skwargs = {k: sel(v) for k, v in kwargs.items()}
            if self.remove_nans:
                tensors = [a for a in (*sargs, *skwargs.values()) if isinstance(a, torch.Tensor)]
                keep = torch.nonzero(~_nan_rows(*tensors)).flatten()
                sargs = tuple(a[keep] if isinstance(a, torch.Tensor) else a for a in sargs)
                skwargs = {k: (v[keep] if isinstance(v, torch.Tensor) else v) for k, v in skwargs.items()}
            if self.squeeze_outputs:
                sargs = tuple(a.squeeze(self.output_dim) if isinstance(a, torch.Tensor) else a for a in sargs)
                skwargs = {k: (v.squeeze(self.output_dim) if isinstance(v, torch.Tensor) else v)
                           for k, v in skwargs.items()}
            out.append((sargs, skwargs))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        for metric, (sargs, skwargs) in zip(self.metrics, self._slice_inputs(*args, **kwargs)):
            metric.update(*sargs, **skwargs)
        self._update_count += 1
        self._computed = None

    def compute(self) -> torch.Tensor:
        return torch.stack([torch.as_tensor(m.compute(), device=self.device) for m in self.metrics], dim=0)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        results = [
            metric.forward(*sargs, **skwargs)
            for metric, (sargs, skwargs) in zip(self.metrics, self._slice_inputs(*args, **kwargs))
        ]
        self._update_count += 1
        if any(r is None for r in results):
            return None
        return torch.stack([torch.as_tensor(r, device=self.device) for r in results], 0)

    __call__ = forward

    def _merge_children(self) -> list:
        return list(self.metrics)

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        self._update_count = 0
        self._computed = None

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.metrics[0]._filter_kwargs(**kwargs)
