"""Running (counterpart of ``torchmetrics_tpu/wrappers/running.py``): the metric's value
over the last ``window`` updates.

A ring of ``window`` per-update state dicts, each the base metric's state after one
update from a fresh state; ``compute`` folds the ring into a scratch base. The
checkpoint flattens the ring to the JAX package's keys, ``_ring{i}.{key}`` (list states
as ``_ring{i}.{key}.{j}`` and ``._len``), ``_ring_len`` and ``_wrapper_update_count``.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Optional, Union

import torch

from ..metric import Metric
from ..utilities.exceptions import StateCorruptionError, TorchMetricsUserError
from .abstract import WrapperMetric


def _snapshot(metric: Metric) -> dict:
    return {k: (list(v) if isinstance(v, list) else v) for k, v in metric._state.items()}


class Running(WrapperMetric):
    """Wrap a metric so ``compute()`` covers only the last ``window`` updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import Running
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> metric = Running(SumMetric(device="cpu"), window=2)
        >>> for batch in [1.0, 2.0, 3.0]:
        ...     metric.update(batch)
        >>> metric.compute()
        tensor(5.)
    """

    def __init__(self, base_metric: Metric, window: int = 5,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected argument `base_metric` to be an instance of `torchmetrics_tpu.Metric` but got {base_metric}"
            )
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        super().__init__(base_metric, device=device)
        self.base_metric = base_metric
        self.window = window
        self._ring: list = []  # newest last: one state dict per update
        self._adopt_device()

    @contextmanager
    def _scratch_base(self):
        """Run the base metric from a fresh state, restoring its real state after."""
        saved, saved_count = _snapshot(self.base_metric), self.base_metric._update_count
        self.base_metric.reset()
        try:
            yield self.base_metric
        finally:
            self.base_metric._state = saved
            self.base_metric._update_count = saved_count
            self.base_metric._computed = None

    def _push(self, contrib: dict) -> None:
        self._ring.append(contrib)
        if len(self._ring) > self.window:
            self._ring.pop(0)
        self._update_count += 1
        self._computed = None

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Keep this update's own state in the ring."""
        with self._scratch_base() as probe:
            probe.update(*args, **kwargs)
            self._push(_snapshot(probe))

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The batch's value from the base metric; the ring is updated as in ``update``."""
        with self._scratch_base() as probe:
            val = probe.forward(*args, **kwargs)
            self._push(_snapshot(probe))
        return val

    __call__ = forward

    def compute(self) -> Any:
        """Fold the ring into a fresh state and compute."""
        with self._scratch_base() as probe:
            for contrib in self._ring:
                probe.merge_state({k: (list(v) if isinstance(v, list) else v) for k, v in contrib.items()})
            probe._update_count = max(1, len(self._ring))
            return probe.compute()

    def merge_state(self, incoming_state: Any) -> None:
        """A window belongs to one stream of updates: merging two has no defined order,
        so this raises. Sync the base metric directly for values across processes."""
        raise TorchMetricsUserError(
            "Running metrics hold a stream-local window of the last updates; merging windows across "
            "ranks has no defined update order. Compute per-rank or wrap an unsynced base metric."
        )

    def _device_children(self) -> list:
        return [self.base_metric]

    def _move_extra(self) -> None:
        if "_ring" in self.__dict__:
            self._ring = [{k: [t.to(self.device) for t in v] if isinstance(v, list) else v.to(self.device)
                           for k, v in contrib.items()} for contrib in self._ring]

    # ------------------------------------------------------------- checkpoint

    def persistent(self, mode: bool = False) -> None:
        self._wrapper_persistent = mode
        self.base_metric.persistent(mode)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        destination = {} if destination is None else destination
        if not self._wrapper_persistent:
            return destination
        for i, contrib in enumerate(self._ring):
            for key, value in contrib.items():
                if isinstance(value, list):
                    destination[f"{prefix}_ring{i}.{key}._len"] = len(value)
                    for j, row in enumerate(value):
                        destination[f"{prefix}_ring{i}.{key}.{j}"] = row.clone()
                else:
                    destination[f"{prefix}_ring{i}.{key}"] = value.clone()
        destination[prefix + "_ring_len"] = len(self._ring)
        destination[prefix + "_wrapper_update_count"] = int(self._update_count)
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "", validate: bool = True) -> None:
        if prefix + "_ring_len" not in state_dict:
            if validate and prefix + "_wrapper_update_count" in state_dict:
                # the update count proves this wrapper was saved: a missing ring length
                # means the checkpoint lost keys
                raise StateCorruptionError(
                    f"Checkpoint slice '{prefix}*' for {type(self).__name__} is truncated: "
                    f"'_wrapper_update_count' is present but '_ring_len' is missing. "
                    f"Pass validate=False to skip the load."
                )
            return
        ring = []
        try:
            for i in range(int(state_dict[prefix + "_ring_len"])):
                contrib = {}
                for key, default in self.base_metric._defaults.items():
                    stem = f"{prefix}_ring{i}.{key}"
                    if isinstance(default, list):
                        contrib[key] = [
                            torch.as_tensor(state_dict[f"{stem}.{j}"], device=self.device)
                            for j in range(int(state_dict[f"{stem}._len"]))
                        ]
                    else:
                        contrib[key] = torch.as_tensor(state_dict[stem], device=self.device)
                ring.append(contrib)
        except KeyError as err:
            if validate:
                raise StateCorruptionError(
                    f"Checkpoint slice '{prefix}*' for {type(self).__name__} is truncated: "
                    f"ring entry key {err} is missing (partially-written ring)."
                ) from err
            raise
        count_key = prefix + "_wrapper_update_count"
        if count_key not in state_dict and validate:
            raise StateCorruptionError(
                f"Checkpoint slice '{prefix}*' for {type(self).__name__} is truncated: "
                f"the ring is present but '_wrapper_update_count' is missing."
            )
        self._ring = ring
        if count_key in state_dict:
            self._update_count = int(state_dict[count_key])
        self._computed = None

    def reset(self) -> None:
        self.base_metric.reset()
        self._ring = []
        self._update_count = 0
        self._computed = None

    def _filter_kwargs(self, **kwargs: Any) -> dict:
        return self.base_metric._filter_kwargs(**kwargs)
