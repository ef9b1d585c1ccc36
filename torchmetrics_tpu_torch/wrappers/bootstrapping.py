"""BootStrapper (counterpart of ``torchmetrics_tpu/wrappers/bootstrapping.py``):
``num_bootstraps`` replicas of a base metric, each fed a resample of every batch drawn
with replacement; ``compute`` reports the mean, std, quantiles or raw values over them.

Two paths, chosen as the JAX package chooses them (its ``_use_vmap``):

- **stacked**: multinomial sampling over a base with tensor states only, a jittable
  compute (``_jittable_compute``) and no bare ``"mean"`` state unless its merge is its
  own. The replicas are one ``(k, ...)`` tensor per state. Each update draws one
  ``(k, batch)`` index matrix, gathers every input by it once, then runs the base's
  ``update_state`` on each replica's slice and stacks the results: ``k`` eager updates
  rather than one vectorised one, because some updates read the host (validation,
  domain checks), which ``torch.func.vmap`` cannot run through.
- **list**: one clone per replica, each updated on its own draw (Poisson draws skip an
  empty one). Sample lists (detection's list of image dicts) resample whole elements.

The draws are the JAX package's calls on ``np.random.default_rng(seed)`` in its order,
so every replica sees the same rows in both packages, and ``forward`` draws twice (the
global update, then the batch-only estimate). The checkpoint keeps the stacked states
under ``_wrapper_extra.`` and the list path's clones under ``_child{i}.``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..metric import Metric, _to_device
from ..parallel import sync as _sync
from .abstract import WrapperMetric


def _bootstrap_sampler(rng: np.random.Generator, size: int, sampling_strategy: str = "multinomial") -> np.ndarray:
    """Row indices resampled with replacement."""
    if sampling_strategy == "poisson":
        counts = rng.poisson(1.0, size=size)
        return np.repeat(np.arange(size), counts)
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size=size)
    raise ValueError("Unknown sampling strategy")


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_stack(trees: list, device: torch.device) -> Any:
    """Stack a list of equally shaped outputs (tensors, dicts, tuples) leaf by leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_stack([t[i] for t in trees], device) for i in range(len(first)))
    return torch.stack([torch.as_tensor(t, device=device) for t in trees], dim=0)


def _as_floating(v: torch.Tensor) -> torch.Tensor:
    return v if v.is_floating_point() else v.to(torch.float32)


class BootStrapper(WrapperMetric):
    """Bootstrap resampling wrapper for confidence estimation.

    Args:
        base_metric: metric instance to bootstrap.
        num_bootstraps: number of replicas.
        mean/std: include mean/std over replicas in the output dict.
        quantile: optional quantile(s) to report (float or sequence).
        raw: include the raw per-replica values.
        sampling_strategy: ``"poisson"`` (default) or ``"multinomial"``; multinomial
            draws keep the replicas stacked where the base allows it.
        seed: seed of the host generator that draws the resamples.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import BootStrapper
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> metric = BootStrapper(BinaryAccuracy(device="cpu"), num_bootstraps=4, sampling_strategy='multinomial', seed=7)
        >>> metric.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'mean': 1.0, 'std': 0.0}
    """

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float]]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of torchmetrics_tpu.Metric but received {base_metric}"
            )
        super().__init__(base_metric, **kwargs)
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.base_metric = base_metric.clone()
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        self.sampling_strategy = sampling_strategy
        self._rng = np.random.default_rng(seed)
        self._use_stacked = (
            sampling_strategy == "multinomial"
            and not base_metric._list_state_names
            and base_metric._jittable_compute
            # a bare "mean" state cannot fold without an update count (update_state raises)
            and (base_metric._has_custom_merge() or not any(fx == "mean" for fx in base_metric._reductions.values()))
        )
        self.metrics = [] if self._use_stacked else [base_metric.clone() for _ in range(num_bootstraps)]
        self._adopt_device()
        self._stacked = self._fresh_stack() if self._use_stacked else {}

    # ------------------------------------------------------------------ stacked

    def _fresh_stack(self) -> Dict[str, torch.Tensor]:
        k = self.num_bootstraps
        return {name: v.unsqueeze(0).expand(k, *v.shape).clone() for name, v in self.base_metric.init_state().items()}

    def _replica(self, stacked: Dict[str, torch.Tensor], r: int) -> Dict[str, torch.Tensor]:
        return {name: v[r] for name, v in stacked.items()}

    def _restack(self, replicas: list) -> Dict[str, torch.Tensor]:
        # the dtype the base's update gives, as under JAX's vmap (a float32 confusion
        # matrix from the pure update, say)
        return {name: torch.stack([rep[name] for rep in replicas]) for name in self._stacked}

    def _stacked_update(self, size: int, args: tuple, kwargs: dict) -> None:
        idx = torch.as_tensor(self._rng.integers(0, size, size=(self.num_bootstraps, size)), device=self.device)
        args = tuple(_to_device(a, self.device) for a in args)
        kwargs = {k: _to_device(v, self.device) for k, v in kwargs.items()}
        # one gather of every input by the (k, batch) index matrix
        args = tuple(a[idx] if isinstance(a, torch.Tensor) else a for a in args)
        kwargs = {k: (v[idx] if isinstance(v, torch.Tensor) else v) for k, v in kwargs.items()}
        base = self.base_metric
        replicas = []
        for r in range(self.num_bootstraps):
            r_args = tuple(a[r] if isinstance(a, torch.Tensor) else a for a in args)
            r_kwargs = {k: (v[r] if isinstance(v, torch.Tensor) else v) for k, v in kwargs.items()}
            replicas.append(base.update_state(self._replica(self._stacked, r), *r_args, **r_kwargs))
        self._stacked = self._restack(replicas)

    # ------------------------------------------------------------------ lifecycle

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Feed each replica a resample of this batch. Tensors resample along dim 0;
        sample lists (detection's list of image dicts) resample whole elements."""
        sizes = [len(a) for a in args if hasattr(a, "shape")]
        sizes += [len(v) for v in kwargs.values() if hasattr(v, "shape")]
        if not sizes:
            sizes = [len(a) for a in args if isinstance(a, (list, tuple))]
            sizes += [len(v) for v in kwargs.values() if isinstance(v, (list, tuple))]
        if not sizes:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        size = sizes[0]
        if self._use_stacked:
            self._stacked_update(size, args, kwargs)
            self._update_count += 1
            self._computed = None
            return
        args = tuple(_to_device(a, self.device) for a in args)
        kwargs = {k: _to_device(v, self.device) for k, v in kwargs.items()}
        for idx in range(self.num_bootstraps):
            sample_idx = _bootstrap_sampler(self._rng, size, self.sampling_strategy)
            if sample_idx.size == 0:
                continue
            index = torch.as_tensor(sample_idx, device=self.device)

            def take(a):
                if isinstance(a, torch.Tensor):
                    return a[index]
                if isinstance(a, (list, tuple)):
                    return [a[int(i)] for i in sample_idx]
                return a

            self.metrics[idx].update(*(take(a) for a in args), **{k: take(v) for k, v in kwargs.items()})
        self._update_count += 1
        self._computed = None

    def compute(self) -> Dict[str, Any]:
        """The replicas' values, aggregated; a dict output (detection's mAP) leaf by leaf."""
        if self._use_stacked:
            vals = [self.base_metric.compute_state(self._replica(self._stacked, r)) for r in range(self.num_bootstraps)]
        else:
            vals = [m.compute() for m in self.metrics]
        computed_vals = _tree_stack(vals, self.device)
        output: Dict[str, Any] = {}
        if self.mean:
            output["mean"] = _tree_map(lambda v: _as_floating(v).mean(dim=0), computed_vals)
        if self.std:
            output["std"] = _tree_map(lambda v: v.to(torch.float32).std(dim=0, correction=1), computed_vals)
        if self.quantile is not None:
            output["quantile"] = _tree_map(
                lambda v: torch.quantile(
                    v.to(torch.float32), torch.as_tensor(self.quantile, dtype=torch.float32, device=v.device), dim=0
                ),
                computed_vals,
            )
        if self.raw:
            output["raw"] = computed_vals
        return output

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Accumulate the batch, and return the bootstrap of this batch alone (a second,
        fresh resample), as every metric's ``forward`` covers its batch."""
        self.update(*args, **kwargs)
        if self._use_stacked:
            saved_stacked = self._stacked
            self._stacked = self._fresh_stack()
            self.update(*args, **kwargs)
            self._update_count -= 1
            out = self.compute()
            self._computed = None
            self._stacked = saved_stacked
            return out
        saved = [{k: (list(v) if isinstance(v, list) else v) for k, v in m._state.items()} for m in self.metrics]
        saved_counts = [m._update_count for m in self.metrics]
        for m in self.metrics:
            m.reset()
        self.update(*args, **kwargs)
        self._update_count -= 1
        out = self.compute()
        self._computed = None
        for m, st, cnt in zip(self.metrics, saved, saved_counts):
            m._state = st
            m._update_count = cnt
            m._computed = None
        return out

    __call__ = forward

    # ------------------------------------------------------------- merge, devices

    def _merge_children(self) -> list:
        return [] if self._use_stacked else list(self.metrics)

    def _merge_wrapper_extra(self, incoming: "BootStrapper") -> None:
        if not self._use_stacked:
            return
        theirs = {k: v.to(self.device) for k, v in incoming._stacked.items()}
        if self.base_metric._has_custom_merge():
            # a base with its own merge (dist_reduce_fx=None states, e.g. Pearson's
            # moments) folds replica by replica through it
            self._stacked = self._restack([
                self.base_metric._merge(self._replica(self._stacked, r), self._replica(theirs, r))
                for r in range(self.num_bootstraps)
            ])
        else:
            self._stacked = _sync.merge_states(
                self._stacked, theirs, self.base_metric._reductions,
                weights=(float(self._update_count), float(incoming._update_count)),
            )

    def _device_children(self) -> list:
        return [self.base_metric, *self.metrics]

    def _move_extra(self) -> None:
        if "_stacked" in self.__dict__:
            self._stacked = {k: v.to(self.device) for k, v in self._stacked.items()}

    def _checkpoint_extra(self) -> dict:
        return dict(self._stacked) if self._use_stacked else {}

    def _load_checkpoint_extra(self, extra: dict) -> None:
        if self._use_stacked:
            self._stacked = {k: extra[k].to(v.dtype) for k, v in self._stacked.items()}

    def reset(self) -> None:
        if self._use_stacked:
            self._stacked = self._fresh_stack()
        for m in self.metrics:
            m.reset()
        self._update_count = 0
        self._computed = None

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.base_metric._filter_kwargs(**kwargs)
