"""``torch.export`` and AOTInductor across torch versions: the AOT plane's portability
seam (counterpart of ``torchmetrics_tpu/aot/compat.py``).

The entry points moved between releases: ``torch.export.export`` made ``strict=False``
the default, ``aoti_compile_and_package`` and ``aoti_load_package`` live under
``torch._inductor`` and changed their keywords, and an ``ExportedProgram`` learned to
drop its example inputs before saving. And the machine's toolchain shapes what
packaging costs and whether it works at all (:func:`_inductor_configs`). Every export, package, load and save call of
the plane goes through these helpers, so the codecs run on either runtime (the card's
torch 2.11 and newer).
"""

from __future__ import annotations

import functools
import io
import os
import subprocess
import threading
from typing import Any, Dict, Optional


def export_available() -> bool:
    try:
        import torch.export as export_mod
    except ImportError:
        return False
    return hasattr(export_mod, "export") and hasattr(export_mod, "save") and hasattr(export_mod, "load")


def aoti_available() -> bool:
    try:
        import torch._inductor as inductor
    except ImportError:
        return False
    return hasattr(inductor, "aoti_compile_and_package") and hasattr(inductor, "aoti_load_package")


def export_program(module: Any, args: tuple, kwargs: Optional[Dict[str, Any]] = None) -> Any:
    """Export ``module`` for the example ``args``/``kwargs`` (non-strict tracing: the
    metric's Python runs as written) → ``ExportedProgram``. Shapes are static: one
    program per input signature, as the cache key is."""
    import torch

    try:
        return torch.export.export(module, args, kwargs, strict=False)
    except TypeError:  # a runtime without the strict keyword
        return torch.export.export(module, args, kwargs)


def serialize_exported(exported: Any) -> bytes:
    """``ExportedProgram`` → the bytes of ``torch.export.save``, without its example
    inputs (a program is keyed by shapes; the example values are dead weight). The
    program keeps them: AOTInductor reads them."""
    import torch

    examples = getattr(exported, "example_inputs", None)
    buf = io.BytesIO()
    try:
        exported.example_inputs = None
    except (AttributeError, TypeError):
        examples = None
    try:
        torch.export.save(exported, buf)
    finally:
        if examples is not None:
            exported.example_inputs = examples
    return buf.getvalue()


# torch.export's deserializer keeps the graph it is building in a module global: two
# threads that load at once (MetricCollection.precompile's prefetch pool) fail the second
_DESERIALIZE_LOCK = threading.Lock()


def deserialize_exported(blob: bytes) -> Any:
    import torch

    with _DESERIALIZE_LOCK:
        return torch.export.load(io.BytesIO(bytes(blob)))


def _has_openmp(cxx: str) -> bool:
    try:
        out = subprocess.run([cxx, "-print-file-name=libgomp.spec"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return out.returncode == 0 and os.path.isabs(out.stdout.strip())


@functools.lru_cache(maxsize=None)
def _inductor_configs() -> tuple:
    """Inductor settings for packaging and loading on the running host.

    - Inductor links every package's host wrapper with ``-fopenmp``; a GCC built
      without libgomp cannot, and the wrapper it builds does not load. Where the
      configured compiler is such a GCC, the first ``g++`` or ``c++`` that can link
      OpenMP is used instead.
    - With CUDA present the CPU's vector ISA is not probed (``cpp.vec_isa_ok=False``):
      the probe compiles a test program per ISA with torch's headers (about 14 s each on
      the card's host, at a package's first compile and again at its first load), and a
      CUDA package's kernels do not use it. CPU code Inductor generates in such a
      process afterwards is not vectorized.
    - Kernels compile in-process (``compile_threads=1``): a fold program has a handful
      of kernels, fewer than it takes to pay for starting a worker pool.
    """
    import torch
    from torch._inductor.cpp_builder import get_cpp_compiler

    configs = [("compile_threads", 1)]
    if torch.cuda.is_available():
        configs.append(("cpp.vec_isa_ok", False))
    try:
        default = get_cpp_compiler()
    except Exception:  # noqa: BLE001 — no compiler found: Inductor reports it itself
        return tuple(configs)
    if not _has_openmp(default):
        for name in ("g++", "c++"):
            found = [os.path.join(folder, name) for folder in os.environ.get("PATH", "").split(os.pathsep) + ["/usr/bin"]]
            usable = [cxx for cxx in found if os.access(cxx, os.X_OK) and _has_openmp(cxx)]
            if usable:
                configs.append(("cpp.cxx", (None, usable[0])))
                break
    return tuple(configs)


def aoti_package(exported: Any, path: str) -> str:
    """AOTInductor-compile ``exported`` into a package at ``path``; returns the path."""
    import torch._inductor as inductor

    return inductor.aoti_compile_and_package(exported, package_path=path, inductor_configs=dict(_inductor_configs()))


def aoti_load(path: str) -> Any:
    """Load a package written by :func:`aoti_package` → a callable with the exported
    program's calling convention (no trace, no compile)."""
    import torch._inductor as inductor
    from torch._inductor import config

    # the load compares the package's CPU ISA with the host's: the same settings
    # keep that comparison from compiling ISA probes with a compiler that cannot
    with config.patch(dict(_inductor_configs())):
        return inductor.aoti_load_package(path)


__all__ = [
    "aoti_available",
    "aoti_load",
    "aoti_package",
    "deserialize_exported",
    "export_available",
    "export_program",
    "serialize_exported",
]
