"""Cohen's kappa (counterpart of ``torchmetrics_tpu/functional/classification/cohen_kappa.py``).

The expected matrix is the outer product of the marginals, taken as a broadcast product,
not a matmul: a float32 matmul may run as TF32 on the card (when the caller allows it),
whose 10-bit mantissa rounds counts above 2048. Each entry is then one float32 product,
as the JAX package's ``(C, 1) @ (1, C)`` is on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utilities.checks import _as_tensor
from ...utilities.enums import ClassificationTaskNoMultilabel
from .confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
)

_WEIGHTS = ("linear", "quadratic", "none", None)


def _cohen_kappa_reduce(confmat: torch.Tensor, weights: Optional[str] = None) -> torch.Tensor:
    """Unnormalised ``(C, C)`` confusion matrix -> kappa, float32."""
    confmat = confmat.to(torch.float32)
    num_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 * sum0 / sum0.sum()
    if weights is None or weights == "none":
        w_mat = 1 - torch.eye(num_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(num_classes, dtype=confmat.dtype, device=confmat.device)
        w_mat = (idx[None, :] - idx[:, None]).abs()
        if weights == "quadratic":
            w_mat = w_mat**2
    else:
        raise ValueError(f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'")
    return 1 - (w_mat * confmat).sum() / (w_mat * expected).sum()


def _check_weights(weights: Optional[str]) -> None:
    if weights not in _WEIGHTS:
        raise ValueError(f"Expected argument `weight` to be one of {_WEIGHTS}, but got {weights}.")


def _binary_cohen_kappa_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, weights: Optional[str] = None
) -> None:
    _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
    _check_weights(weights)


def _multiclass_cohen_kappa_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, weights: Optional[str] = None
) -> None:
    _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
    _check_weights(weights)


def binary_cohen_kappa(
    preds,
    target,
    threshold: float = 0.5,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Binary Cohen's kappa.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_cohen_kappa
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> target = torch.tensor([0, 0, 1, 1, 0, 1])
        >>> binary_cohen_kappa(preds, target)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_cohen_kappa_arg_validation(threshold, ignore_index, weights)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, w = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _cohen_kappa_reduce(_binary_confusion_matrix_update(preds, target, w), weights)


def multiclass_cohen_kappa(
    preds,
    target,
    num_classes: int,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Multiclass Cohen's kappa.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_cohen_kappa
        >>> preds = torch.tensor([[0.75, 0.05, 0.20], [0.10, 0.80, 0.10], [0.20, 0.30, 0.50], [0.25, 0.40, 0.35]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> multiclass_cohen_kappa(preds, target, num_classes=3)
        tensor(1.)
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_cohen_kappa_arg_validation(num_classes, ignore_index, weights)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, w = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    return _cohen_kappa_reduce(_multiclass_confusion_matrix_update(preds, target, w, num_classes), weights)


def cohen_kappa(
    preds,
    target,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task dispatch (binary or multiclass).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cohen_kappa
        >>> cohen_kappa(torch.tensor([0.2, 0.8, 0.6, 0.1]), torch.tensor([0, 1, 1, 1]), task="binary")
        tensor(0.5000)
    """
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
    return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args)
