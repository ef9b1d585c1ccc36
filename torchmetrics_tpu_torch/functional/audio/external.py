"""Audio metrics backed by third-party native code (counterpart of
``torchmetrics_tpu/functional/audio/external.py``): PESQ through the ``pesq`` wheel and
STOI through ``pystoi``, both on host numpy, as in the JAX package. Where the wheel is
absent they raise the JAX package's ``ModuleNotFoundError``. The results come back as
float32 on the device of the input. SRMR, DNSMOS and NISQA are in-tree pipelines
(``srmr.py``, ``dnsmos.py``, ``nisqa.py``), re-exported here as there.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utilities.checks import _as_tensor, _check_same_shape
from ...utilities.imports import _module_available

_PESQ_AVAILABLE = _module_available("pesq")
_PYSTOI_AVAILABLE = _module_available("pystoi")


def _host_pair(preds, target):
    """Both inputs as float32 host arrays, and the device the result goes back to."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    host = [x.detach().to(torch.float32).cpu().numpy() for x in (preds, target)]
    return host[0], host[1], preds.device


def perceptual_evaluation_speech_quality(
    preds,
    target,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
) -> torch.Tensor:
    """PESQ via the ``pesq`` C extension on host numpy (ITU-T P.862): a flat batch of
    scores."""
    preds_np, target_np, device = _host_pair(preds, target)
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed."
            " Either install as `pip install torchmetrics[audio]` or `pip install pesq`."
        )
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    import pesq as pesq_backend

    if preds_np.ndim == 1:
        scores = np.asarray(pesq_backend.pesq(fs, target_np, preds_np, mode))
    else:
        flat_p = preds_np.reshape(-1, preds_np.shape[-1])
        flat_t = target_np.reshape(-1, target_np.shape[-1])
        scores = np.asarray([pesq_backend.pesq(fs, t, p, mode) for p, t in zip(flat_p, flat_t)])
    return torch.as_tensor(scores, dtype=torch.float32, device=device)


def short_time_objective_intelligibility(preds, target, fs: int, extended: bool = False) -> torch.Tensor:
    """STOI via ``pystoi`` on host numpy."""
    preds_np, target_np, device = _host_pair(preds, target)
    if not _PYSTOI_AVAILABLE:
        raise ModuleNotFoundError(
            "ShortTimeObjectiveIntelligibility metric requires that `pystoi` is installed."
            " Either install as `pip install torchmetrics[audio]` or `pip install pystoi`."
        )
    from pystoi import stoi as stoi_backend

    if preds_np.ndim == 1:
        scores = np.asarray(stoi_backend(target_np, preds_np, fs, extended))
    else:
        flat_p = preds_np.reshape(-1, preds_np.shape[-1])
        flat_t = target_np.reshape(-1, target_np.shape[-1])
        scores = np.asarray(
            [stoi_backend(t, p, fs, extended) for p, t in zip(flat_p, flat_t)]
        ).reshape(preds_np.shape[:-1])
    return torch.as_tensor(scores, dtype=torch.float32, device=device)


from .dnsmos import deep_noise_suppression_mean_opinion_score  # noqa: F401,E402
from .nisqa import non_intrusive_speech_quality_assessment  # noqa: F401,E402
from .srmr import speech_reverberation_modulation_energy_ratio  # noqa: F401,E402
