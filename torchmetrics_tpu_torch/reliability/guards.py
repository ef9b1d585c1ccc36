"""State-integrity guards (counterpart of ``torchmetrics_tpu/reliability/guards.py``).

``validate_state`` checks a metric's state dict against the invariants its
``init_state()`` spec implies: every registered leaf present, tensor leaves with a
shape-preserving reduction tag matching the default's shape and dtype, and (on request)
floating aggregate leaves finite. ``validate_restored`` checks a checkpoint slice before
``load_state_dict`` adopts it. Both raise
:class:`~torchmetrics_tpu_torch.utilities.exceptions.StateCorruptionError` naming the
offending leaf.

Guards run at the boundaries where a state crosses a trust domain (checkpoint restore,
sync, merge), never per update: each finiteness scan reads one bool back from the
device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..utilities.exceptions import StateCorruptionError

# reduction tags under which a tensor leaf keeps its default shape forever
_SHAPE_PRESERVING = ("sum", "mean", "min", "max")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _is_array(value: Any) -> bool:
    return isinstance(value, (torch.Tensor, np.ndarray)) or np.isscalar(value)


def _check_tensor_leaf(name: str, value: Any, default: Any, fx: Any, context: str, check_finite: bool) -> None:
    if isinstance(value, list):
        raise StateCorruptionError(f"{context}: state '{name}' is a list but its spec is a tensor state.")
    if not _is_array(value):
        raise StateCorruptionError(f"{context}: state '{name}' is {type(value).__name__}, expected an array.")
    value = torch.as_tensor(value)
    if isinstance(fx, str) and fx in _SHAPE_PRESERVING:
        spec = torch.as_tensor(default)
        if tuple(value.shape) != tuple(spec.shape):
            raise StateCorruptionError(
                f"{context}: state '{name}' has shape {tuple(value.shape)}, "
                f"spec requires {tuple(spec.shape)} (reduction '{fx}' preserves shape)."
            )
        if value.dtype != spec.dtype:
            raise StateCorruptionError(  # dtype names as numpy (and the JAX package) print them
                f"{context}: state '{name}' has dtype {_dtype_name(value.dtype)}, "
                f"spec requires {_dtype_name(spec.dtype)}."
            )
        # finiteness is an invariant of aggregate leaves only: raw-data leaves (cat
        # lists, None-tagged gathers) may carry NaN by construction
        if check_finite and value.is_floating_point() and not bool(torch.isfinite(value).all()):
            raise StateCorruptionError(f"{context}: state '{name}' contains non-finite values (NaN/Inf).")


def validate_state(
    metric: Any,
    state: Optional[Dict[str, Any]] = None,
    context: str = "validate_state",
    check_finite: bool = True,
) -> None:
    """Validate ``state`` (the metric's live state if None) against the metric's
    ``init_state()`` spec; raise :class:`StateCorruptionError` naming the first leaf that
    violates it.

    Sync can legitimately reshape ``None``-tagged leaves and grow ``cat`` leaves, so shape
    and dtype are enforced only under the shape-preserving reduction tags; presence is
    enforced for every leaf, finiteness only for aggregate leaves.
    """
    state = metric._state if state is None else state
    for name, default in metric._defaults.items():
        if name not in state:
            raise StateCorruptionError(
                f"{context}: state '{name}' of {type(metric).__name__} is missing (truncated or partially-written state)."
            )
        value = state[name]
        if isinstance(default, list):
            for i, elem in enumerate(value if isinstance(value, list) else [value]):
                if not _is_array(elem):
                    raise StateCorruptionError(f"{context}: state '{name}[{i}]' is {type(elem).__name__}, expected an array.")
        else:
            _check_tensor_leaf(name, value, default, metric._reductions.get(name), context, check_finite)


def validate_restored(metric: Any, state_dict: Mapping[str, Any], prefix: str = "", check_finite: bool = False) -> None:
    """Structural validation of a checkpoint slice before it is adopted.

    The ``_saved_states`` manifest records how many state leaves the save wrote: fewer
    surviving means the file lost keys, while a partial but complete save (persistent and
    non-persistent states mixed) validates cleanly. Without a manifest, a slice whose
    ``_update_count`` proves the metric was saved must hold all of its states or none.
    Present tensor leaves under shape-preserving tags must match the spec's shape and
    dtype. ``check_finite`` also scans floating leaves, list elements included.
    """
    names = list(metric._defaults)
    present = [n for n in names if prefix + n in state_dict]
    manifest_key = prefix + "_saved_states"
    if manifest_key in state_dict:
        expected = int(state_dict[manifest_key])
        if len(present) < expected:
            raise StateCorruptionError(
                f"Checkpoint slice '{prefix}*' for {type(metric).__name__} is truncated: "
                f"{expected} state(s) were saved but only {len(present)} ({sorted(present)}) survived. "
                "Pass validate=False to force a partial load."
            )
    elif present and prefix + "_update_count" in state_dict:
        missing = [n for n in names if prefix + n not in state_dict]
        if missing:
            raise StateCorruptionError(
                f"Checkpoint slice '{prefix}*' for {type(metric).__name__} is truncated: "
                f"has {sorted(present)} but is missing {sorted(missing)} "
                "(its '_update_count' metadata proves the metric was saved whole). "
                "Pass validate=False to force a partial load."
            )
    for name in present:
        default = metric._defaults[name]
        value = state_dict[prefix + name]
        if isinstance(default, list):
            if not isinstance(value, (list, tuple)):
                raise StateCorruptionError(
                    f"Checkpoint state '{prefix}{name}' should be a list of arrays, got {type(value).__name__}."
                )
            if check_finite:
                for i, elem in enumerate(value):
                    elem = torch.as_tensor(elem)
                    if elem.is_floating_point() and not bool(torch.isfinite(elem).all()):
                        raise StateCorruptionError(f"Checkpoint state '{prefix}{name}[{i}]' contains non-finite values.")
        else:
            _check_tensor_leaf(
                name, value, default, metric._reductions.get(name), f"checkpoint restore ('{prefix}{name}')", check_finite
            )
