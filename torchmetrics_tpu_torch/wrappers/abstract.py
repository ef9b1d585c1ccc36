"""Wrapper base class (counterpart of ``torchmetrics_tpu/wrappers/abstract.py``).

A wrapper owns no states of its own: its accumulation lives in child metrics (or, for
``BootStrapper``'s stacked replicas, ``MinMaxMetric``'s extrema and ``Running``'s ring,
in wrapper-level tensors), so ``merge_state`` pairs the children and the checkpoint
recurses into them under the JAX package's keys: ``_child{i}.``, ``_wrapper_extra.{k}``
and ``_wrapper_update_count``. Nothing is written unless ``persistent(True)`` was
called, as for any metric.

Device: a wrapper runs on its wrapped metric's device unless ``device=`` is given, and a
given device moves the children there. A wrapper around a metric on the default device
(CUDA) runs on the card, or raises where there is no CUDA, as that metric does.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional

import torch

from ..metric import Metric


def _devices_of(wrapped: Iterable[Any]) -> List[torch.device]:
    """The devices of the metrics and collections among ``wrapped``, in order, each once."""
    devices: List[torch.device] = []
    for item in wrapped:
        device = getattr(item, "device", None)
        if isinstance(device, torch.device) and device not in devices:
            devices.append(device)
    return devices


class WrapperMetric(Metric):
    """Abstract base class for wrapper metrics.

    ``wrapped`` are the metrics (or collections) the subclass wraps: the wrapper takes
    their device unless ``device=`` is given, and raises if they lie on different
    devices. A subclass sets its children, then calls ``_adopt_device()``.
    """

    def __init__(self, *wrapped: Any, **kwargs: Any) -> None:
        device = kwargs.pop("device", None)
        self_placed = device is not None
        if not self_placed:
            devices = _devices_of(wrapped)
            if len(devices) > 1:
                raise ValueError(
                    f"The wrapped metrics lie on different devices ({', '.join(map(str, devices))}); "
                    "move them to one device or pass `device=`."
                )
            device = devices[0] if devices else None
        super().__init__(device=device, **kwargs)
        self._move_children = self_placed

    def _adopt_device(self) -> None:
        """Move the children to a ``device=`` given at construction."""
        if self._move_children:
            self.to(self.device)

    # ------------------------------------------------------------------ devices

    def _device_children(self) -> list:
        """Children that live on the wrapper's device; wrappers with others override."""
        return list(self._merge_children())

    def _move_extra(self) -> None:
        """Move wrapper-level tensors (extrema, stacked replicas, the ring) to the device."""

    def to(self, device: Any) -> "WrapperMetric":
        """Move the wrapper, its children and its own tensors to ``device``."""
        super().to(device)
        for child in self._device_children():
            child.to(self.device)
        self._move_extra()
        return self

    # ------------------------------------------------------------------ merge

    def _merge_children(self) -> list:
        """Ordered child metrics to pair-merge; wrappers override."""
        raise NotImplementedError(f"{type(self).__name__} does not define its children for merge_state.")

    def _merge_wrapper_extra(self, incoming: "WrapperMetric") -> None:
        """Hook for wrapper-level state that is no child (MinMax's running extrema)."""

    def merge_state(self, incoming_state: Any) -> None:
        if not isinstance(incoming_state, WrapperMetric) or type(incoming_state) is not type(self):
            raise ValueError(
                f"Expected incoming state to be an instance of {type(self).__name__}; wrapper metrics "
                "merge wrapper-to-wrapper (their accumulation lives in child metrics, not a state dict)."
            )
        mine = list(self._merge_children())
        theirs = list(incoming_state._merge_children())
        if len(mine) != len(theirs):
            raise ValueError(
                f"Cannot merge {type(self).__name__}: child metric counts differ ({len(mine)} vs {len(theirs)})."
            )
        for child, other in zip(mine, theirs):
            child.merge_state(other)
        self._merge_wrapper_extra(incoming_state)
        self._update_count += incoming_state._update_count
        self._computed = None

    # ------------------------------------------------------------- checkpoint

    _wrapper_persistent = False

    def persistent(self, mode: bool = False) -> None:
        super().persistent(mode)
        self._wrapper_persistent = mode
        for child in self._merge_children():
            child.persistent(mode)

    def _checkpoint_extra(self) -> dict:
        """Wrapper-level state that is no child, to persist (MinMax's extrema)."""
        return {}

    def _load_checkpoint_extra(self, extra: dict) -> None:
        """Restore what ``_checkpoint_extra`` saved; wrappers with extra state override."""

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        destination = {} if destination is None else destination
        before = len(destination)
        super().state_dict(destination, prefix)
        for i, child in enumerate(self._merge_children()):
            # a MetricCollection child's state_dict takes no arguments, so this raises
            # TypeError for it, as in the JAX package
            child.state_dict(destination, f"{prefix}_child{i}.")
        if self._wrapper_persistent:
            for k, v in self._checkpoint_extra().items():
                destination[f"{prefix}_wrapper_extra.{k}"] = v.clone()
        if len(destination) > before:
            destination[prefix + "_wrapper_update_count"] = int(self._update_count)
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "", validate: bool = True) -> None:
        super().load_state_dict(state_dict, prefix, validate=validate)
        for i, child in enumerate(self._merge_children()):
            child.load_state_dict(state_dict, f"{prefix}_child{i}.", validate=validate)
        count_key = prefix + "_wrapper_update_count"
        if count_key in state_dict:
            self._update_count = int(state_dict[count_key])
            self._computed = None
        extra_prefix = prefix + "_wrapper_extra."
        extra = {
            k[len(extra_prefix):]: torch.as_tensor(v, device=self.device)
            for k, v in state_dict.items()
            if k.startswith(extra_prefix)
        }
        if extra:
            self._load_checkpoint_extra(extra)
            self._computed = None

    def _batch_state(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(f"{type(self).__name__} drives its children directly.")

    def _compute(self, state: Any) -> Any:
        raise NotImplementedError(f"{type(self).__name__} drives its children directly.")

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Wrappers define forward in terms of their children's forward."""
        raise NotImplementedError

    __call__ = forward
