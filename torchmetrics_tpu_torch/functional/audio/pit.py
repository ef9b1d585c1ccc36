"""Permutation Invariant Training (counterpart of ``torchmetrics_tpu/functional/audio/pit.py``).

The speaker-wise metric matrix is one batched ``metric_func`` call over every (target,
prediction) speaker pair, and the exhaustive search over permutations one gather and a
mean, in ``itertools.permutations`` order; ``torch.argmax``/``torch.argmin`` take the
first best permutation (a NaN counting as the best, as ``jnp.argmax`` counts it). At 2
and 3 speakers nothing is read back to the host. Above 3 speakers scipy's Hungarian
solver runs on the host, one read of the ``(batch, spk, spk)`` matrix, as in the JAX
package.
"""

from __future__ import annotations

from itertools import permutations
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ...utilities.checks import _as_tensor
from ...utilities.data import _jax_dtype


_ps_cache: dict = {}


def _gen_permutations(spk_num: int, device) -> torch.Tensor:
    """``(spk_num!, spk_num)`` permutations in ``itertools.permutations`` order, made on
    ``device`` once (a copy from the host waits for the device; later updates reuse it).
    The best one is returned as int32, the JAX package's dtype."""
    key = (spk_num, str(device))
    if key not in _ps_cache:
        _ps_cache[key] = torch.tensor(list(permutations(range(spk_num))), dtype=torch.long, device=device)
    return _ps_cache[key]


def _find_best_perm_by_linear_sum_assignment(metric_mtx: torch.Tensor, maximize: bool
                                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    from scipy.optimize import linear_sum_assignment

    mmtx = metric_mtx.detach().cpu().numpy()
    best_perm = np.stack([linear_sum_assignment(pwm, maximize)[1] for pwm in mmtx])
    best_perm = torch.as_tensor(best_perm, device=metric_mtx.device)
    best_metric = metric_mtx.gather(2, best_perm[:, :, None]).mean(dim=(-1, -2))
    return best_metric, best_perm.to(torch.int32)


def _best_of(metric_of_ps: torch.Tensor, perms: torch.Tensor, eval_func: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best value of each row of ``(batch, perm)`` scores and its permutation."""
    if eval_func == "max":
        best_indexes, best_metric = metric_of_ps.argmax(dim=1), metric_of_ps.amax(dim=1)
    else:
        best_indexes, best_metric = metric_of_ps.argmin(dim=1), metric_of_ps.amin(dim=1)
    return best_metric, perms[best_indexes].to(torch.int32)


def _find_best_perm_by_exhaustive_method(metric_mtx: torch.Tensor, eval_func: str
                                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    batch_size, spk_num = metric_mtx.shape[:2]
    ps = _gen_permutations(spk_num, metric_mtx.device)  # (perm_num, spk_num)
    bps = ps.T[None].expand(batch_size, spk_num, ps.shape[0])
    metric_of_ps = metric_mtx.gather(2, bps).mean(dim=1)  # (batch, perm)
    return _best_of(metric_of_ps, ps, eval_func)


def permutation_invariant_training(
    preds,
    target,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best metric value and speaker permutation per sample.

    ``metric_func(preds, target)`` must return per-sample values; ``mode`` decides
    whether it sees speaker pairs or whole permutations.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import permutation_invariant_training
        >>> from torchmetrics_tpu_torch.functional import scale_invariant_signal_noise_ratio
        >>> t = torch.arange(100.0)
        >>> preds = torch.stack([torch.sin(t / 9), torch.cos(t / 7)])[None]
        >>> target = torch.stack([torch.cos(t / 8), torch.sin(t / 10)])[None]
        >>> best, perm = permutation_invariant_training(preds, target, scale_invariant_signal_noise_ratio)
        >>> [round(float(x), 4) for x in best], perm.tolist()
        ([-0.1867], [[1, 0]])
    """
    preds, target = _jax_dtype(_as_tensor(preds)), _jax_dtype(_as_tensor(target))
    if tuple(preds.shape[0:2]) != tuple(target.shape[0:2]):
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ["speaker-wise", "permutation-wise"]:
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    batch_size, spk_num = target.shape[0:2]
    if mode == "permutation-wise":
        perms = _gen_permutations(spk_num, preds.device)
        perm_num = perms.shape[0]
        ppreds = preds[:, perms.reshape(-1)].reshape(batch_size * perm_num, *preds.shape[1:])
        ptarget = target.repeat_interleave(perm_num, dim=0)
        metric_of_ps = _as_tensor(metric_func(ppreds, ptarget, **kwargs))
        metric_of_ps = metric_of_ps.reshape(batch_size, perm_num, -1).mean(dim=-1)
        return _best_of(metric_of_ps, perms, eval_func)

    # speaker-wise: one batched metric call over all (target_idx, preds_idx) pairs
    index = torch.arange(spk_num, device=preds.device)
    ti, pi = torch.meshgrid(index, index, indexing="ij")
    pair_preds = preds[:, pi.reshape(-1)].reshape(batch_size * spk_num * spk_num, *preds.shape[2:])
    pair_target = target[:, ti.reshape(-1)].reshape(batch_size * spk_num * spk_num, *target.shape[2:])
    metric_mtx = _as_tensor(metric_func(pair_preds, pair_target, **kwargs)).reshape(batch_size, spk_num, spk_num)
    if spk_num > 3:
        return _find_best_perm_by_linear_sum_assignment(metric_mtx, maximize=eval_func == "max")
    return _find_best_perm_by_exhaustive_method(metric_mtx, eval_func)


def pit_permutate(preds, perm) -> torch.Tensor:
    """Reorder the speaker axis of ``preds`` by the best permutation from PIT.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pit_permutate
        >>> pit_permutate(torch.tensor([[[1.0, 2.0], [3.0, 4.0]]]), torch.tensor([[1, 0]]))
        tensor([[[3., 4.],
                 [1., 2.]]])
    """
    preds, perm = _as_tensor(preds), _as_tensor(perm)
    index = perm.long().reshape(*perm.shape, *([1] * (preds.ndim - 2))).expand(*perm.shape, *preds.shape[2:])
    return preds.gather(1, index)
