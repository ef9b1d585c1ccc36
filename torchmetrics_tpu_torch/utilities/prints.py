"""Rank-zero-gated logging and warnings (counterpart of ``torchmetrics_tpu/utilities/prints.py``).

The rank is the ``torch.distributed`` rank when a process group is initialised, else 0.
"""

from __future__ import annotations

import logging
import warnings
from functools import wraps
from typing import Any, Callable

import torch.distributed as dist


_logger = logging.getLogger("torchmetrics_tpu_torch")


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on rank 0."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, kind: type = UserWarning, **kwargs: Any) -> None:
    warnings.warn(message, kind, stacklevel=kwargs.pop("stacklevel", 5), **kwargs)


@rank_zero_only
def rank_zero_debug(*args: Any, **kwargs: Any) -> None:
    _logger.debug(*args, **kwargs)


@rank_zero_only
def rank_zero_info(*args: Any, **kwargs: Any) -> None:
    _logger.info(*args, **kwargs)
