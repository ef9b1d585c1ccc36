"""F-beta and F1 (counterpart of ``torchmetrics_tpu/functional/classification/f_beta.py``):
``_fbeta_reduce``, the six task entry points and the ``fbeta_score``/``f1_score`` dispatch."""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.compute import _adjust_weights_safe_divide, _safe_divide
from ...utilities.enums import ClassificationTask
from ._family import make_binary, make_multiclass, make_multilabel, make_task_dispatch
from .stat_scores import _check_task_args


def _fbeta_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
    zero_division: float = 0,
) -> torch.Tensor:
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp_s, fn_s, fp_s = tp.sum(dim), fn.sum(dim), fp.sum(dim)
        return _safe_divide((1 + beta2) * tp_s, (1 + beta2) * tp_s + beta2 * fn_s + fp_s, zero_division)
    fbeta_score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    return _adjust_weights_safe_divide(fbeta_score, average, multilabel, tp, fp, fn, top_k)


def _validate_beta(beta: float) -> None:
    if not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a positive float, but got {beta}.")


def _make_fbeta_entry(maker, name: str, beta_arg: bool):
    """An entry point from a task factory: F1 fixes beta at 1.0, F-beta takes ``beta``
    as the argument after ``target``."""

    def reduce_with_beta(beta):
        return lambda tp, fp, tn, fn, average, mda="global", ml=False, top_k=1, zd=0: _fbeta_reduce(
            tp, fp, tn, fn, beta, average, mda, ml, top_k, zd
        )

    if not beta_arg:
        return maker(reduce_with_beta(1.0), name)

    def fn(preds, target, beta: float = 1.0, *args, **kwargs):
        _validate_beta(beta)
        return maker(reduce_with_beta(beta), name)(preds, target, *args, **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    return fn


binary_fbeta_score = _make_fbeta_entry(make_binary, "binary_fbeta_score", beta_arg=True)
multiclass_fbeta_score = _make_fbeta_entry(make_multiclass, "multiclass_fbeta_score", beta_arg=True)
multilabel_fbeta_score = _make_fbeta_entry(make_multilabel, "multilabel_fbeta_score", beta_arg=True)

binary_f1_score = _make_fbeta_entry(make_binary, "binary_f1_score", beta_arg=False)
multiclass_f1_score = _make_fbeta_entry(make_multiclass, "multiclass_f1_score", beta_arg=False)
multilabel_f1_score = _make_fbeta_entry(make_multilabel, "multilabel_f1_score", beta_arg=False)

f1_score = make_task_dispatch(binary_f1_score, multiclass_f1_score, multilabel_f1_score, "f1_score")


def fbeta_score(
    preds,
    target,
    task: str,
    beta: float = 1.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: Optional[str] = "global",
    top_k: Optional[int] = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0,
) -> torch.Tensor:
    """Task dispatch over the three F-beta entry points, with an explicit ``beta``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import fbeta_score
        >>> fbeta_score(torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 1]), task="binary", beta=2.0)
        tensor(1.)
    """
    task = ClassificationTask.from_str(task)
    _check_task_args(task, num_classes, num_labels, top_k)
    if task == ClassificationTask.BINARY:
        return binary_fbeta_score(preds, target, beta, threshold, multidim_average, ignore_index, validate_args,
                                  zero_division)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_fbeta_score(
            preds, target, beta, num_classes, average, top_k, multidim_average, ignore_index, validate_args, zero_division
        )
    return multilabel_fbeta_score(
        preds, target, beta, num_labels, threshold, average, multidim_average, ignore_index, validate_args, zero_division
    )
