"""Runtime identity for the AOT compile cache and the serving engine's tenant placement
(counterpart of ``runtime_fingerprint``, ``DEFAULT_TENANT_AXIS`` and ``tenant_sharding``
in ``torchmetrics_tpu/parallel/mesh.py``). The JAX mesh helpers that have no torch
meaning (``shard_map``, ``make_data_mesh``, ``make_2d_mesh``, ``batch_sharding``,
``replicated``, ``DEFAULT_AXIS``, and ``sync.reduce_over_axis``) are not ported: a
process group and ``reduce_over_group`` take their place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import torch

#: the mesh dimension name :func:`tenant_sharding` shards the serving stacks over
DEFAULT_TENANT_AXIS = "tenants"


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


@dataclasses.dataclass(frozen=True)
class TenantSharding:
    """Shard-by-tenant placement of a serving stack: every stack leaf's leading
    tenant-row axis split along one named dimension of a ``DeviceMesh`` (the DTensor
    placement ``Shard(0)``). Over a dimension of size one (one card) :meth:`place`
    leaves a leaf as it is, so every tenant's values stay bit for bit; over more it
    returns the ``DTensor`` that ``distribute_tensor`` builds."""

    mesh: Any
    axis_name: str
    placements: Tuple[Any, ...]

    @property
    def size(self) -> int:
        return int(self.mesh.size(self.mesh.mesh_dim_names.index(self.axis_name)))

    def place(self, leaf: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return leaf
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(leaf, self.mesh[self.axis_name], list(self.placements))


def tenant_sharding(mesh: Any, axis_name: str = DEFAULT_TENANT_AXIS) -> TenantSharding:
    """Shard-by-tenant placement for the serving engine's stacked states: pass the
    result as ``ServingConfig(sharding=...)``. ``mesh`` is a
    ``torch.distributed.device_mesh.DeviceMesh`` with named dimensions; pick a stack row
    count (``capacity + 1``, the scratch row rides along) divisible by the dimension's
    size. Raises ``ValueError`` for a dimension the mesh does not have."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r}; axes: {names}")
    from torch.distributed.tensor import Shard

    return TenantSharding(mesh, axis_name, (Shard(0),))


__all__ = ["DEFAULT_TENANT_AXIS", "TenantSharding", "runtime_fingerprint", "tenant_sharding"]
