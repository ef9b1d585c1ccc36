"""Runtime identity for the AOT compile cache (counterpart of ``runtime_fingerprint`` in
``torchmetrics_tpu/parallel/mesh.py``; the mesh helpers of that module are not ported).
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _device_identity() -> str:
    """The parts of the fingerprint that cannot change within a process: versions, the
    backend, the first card's name and compute capability, and the device count."""
    parts = [f"torch={torch.__version__}", f"cuda={torch.version.cuda}"]
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        parts += [
            "backend=cuda",
            f"device={torch.cuda.get_device_name(0)}",
            f"cc={major}.{minor}",
            f"ndev={torch.cuda.device_count()}",
        ]
    else:
        parts += ["backend=cpu", "device=cpu", "cc=none", "ndev=1"]
    return "|".join(parts)


def runtime_fingerprint() -> str:
    """Backend and topology identity for AOT compile-cache keys (``aot/``).

    An AOTInductor package is native code for one runtime: a different torch or CUDA
    version, backend, card or compute capability, device count or process-group size
    must make the cache key miss. So must every process-wide setting that changes the
    program generated for the same input signature (the counterpart of the JAX
    package's ``x64=``): TF32 in cuBLAS and cuDNN, the float32 matmul precision and the
    default dtype. Reads metadata only: no tensor is made and no memory touched.
    """
    world = torch.distributed.get_world_size() if (
        torch.distributed.is_available() and torch.distributed.is_initialized()) else 1
    return "|".join([
        _device_identity(),
        f"world={world}",
        f"tf32_matmul={int(torch.backends.cuda.matmul.allow_tf32)}",
        f"tf32_cudnn={int(torch.backends.cudnn.allow_tf32)}",
        f"matmul_precision={torch.get_float32_matmul_precision()}",
        f"default_dtype={str(torch.get_default_dtype()).replace('torch.', '')}",
    ])


__all__ = ["runtime_fingerprint"]
