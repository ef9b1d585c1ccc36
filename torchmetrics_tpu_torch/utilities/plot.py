"""Plotting backend, matplotlib optional (counterpart of ``torchmetrics_tpu/utilities/plot.py``).

matplotlib is imported only when a figure is drawn (``_get_ax``), so the package imports
and runs without it. Values may be tensors on any device, in any floating type, and may
require grad: ``_to_np`` detaches them, casts bfloat16 and float16 to float32 and brings
them to the host before numpy reads them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .imports import _MATPLOTLIB_AVAILABLE

_error_msg = "matplotlib is required to plot metrics, install it to use the `.plot` method"


def _get_ax(ax=None):
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(_error_msg)
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.get_figure()
    return fig, ax


def _tensor_np(val):
    """What ``np.asarray`` takes, plus tensors on the card, in bfloat16 or float16, or
    that require grad."""
    if isinstance(val, torch.Tensor):
        val = val.detach()
        if val.dtype in (torch.bfloat16, torch.float16):
            val = val.float()
        return val.cpu().numpy()
    return np.asarray(val)


def _to_np(val):
    if isinstance(val, dict):
        return {k: _to_np(v) for k, v in val.items()}
    if isinstance(val, (list, tuple)):
        return [_tensor_np(v) for v in val]
    return _tensor_np(val)


def plot_single_or_multi_val(
    val,
    ax=None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Scalar → point; vector → bars; dict or list over steps → lines."""
    fig, ax = _get_ax(ax)
    val = _to_np(val)
    if isinstance(val, dict):
        for i, (k, v) in enumerate(val.items()):
            v = np.atleast_1d(v)
            if v.size == 1:
                ax.plot([i], v, "o", label=str(k))
            else:
                ax.plot(v, label=str(k))
        ax.legend()
    elif isinstance(val, list):
        arr = np.stack([np.atleast_1d(v) for v in val])
        if arr.ndim == 2 and arr.shape[1] > 1:
            for c in range(arr.shape[1]):
                ax.plot(arr[:, c], label=f"{legend_name or 'dim'} {c}")
            ax.legend()
        else:
            ax.plot(arr.reshape(arr.shape[0], -1))
        ax.set_xlabel("Step")
    else:
        arr = np.atleast_1d(val)
        if arr.size == 1:
            ax.plot([0], arr, "o")
        else:
            labels = [f"{legend_name or 'dim'} {i}" for i in range(arr.size)]
            ax.bar(np.arange(arr.size), arr.reshape(-1), tick_label=labels)
    if lower_bound is not None and upper_bound is not None:
        ax.set_ylim(lower_bound, upper_bound)
    if name:
        ax.set_title(name)
    return fig, ax


def plot_confusion_matrix(
    confmat,
    ax=None,
    add_text: bool = True,
    labels: Optional[Sequence] = None,
    cmap: Optional[str] = None,
):
    """Heatmap of a (C, C) confusion matrix, or of the first of (N, 2, 2) ones."""
    fig, ax = _get_ax(ax)
    cm = _to_np(confmat)
    if cm.ndim == 3:  # multilabel: the first label's matrix
        cm = cm[0]
    im = ax.imshow(cm, cmap=cmap or "Blues")
    fig.colorbar(im, ax=ax)
    n = cm.shape[0]
    ticks = labels if labels is not None else list(range(n))
    ax.set_xticks(range(n), ticks)
    ax.set_yticks(range(n), ticks)
    ax.set_xlabel("Predicted class")
    ax.set_ylabel("True class")
    if add_text:
        for i in range(n):
            for j in range(cm.shape[1]):
                ax.text(j, i, f"{cm[i, j]:.2g}", ha="center", va="center")
    return fig, ax


def plot_curve(
    curve: Tuple,
    score=None,
    ax=None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """A ROC- or PR-style curve: one line, or one per class of stacked curves."""
    fig, ax = _get_ax(ax)
    # a list of per-class curves stacks, as np.asarray stacks it
    x, y = np.asarray(_to_np(curve[0])), np.asarray(_to_np(curve[1]))
    if x.ndim == 1:
        ax.plot(x, y)
    else:
        for c in range(x.shape[0]):
            ax.plot(x[c], y[c], label=f"{legend_name or 'class'} {c}")
        ax.legend()
    if label_names:
        ax.set_xlabel(label_names[0])
        ax.set_ylabel(label_names[1])
    if score is not None:
        ax.set_title(f"{name or 'curve'} (score={_to_np(score):.3f})")
    elif name:
        ax.set_title(name)
    return fig, ax
