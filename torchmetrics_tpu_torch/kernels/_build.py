"""Build the port's CUDA sources with ``nvcc`` at first use and bind them with ctypes.

Each source under ``torchmetrics_tpu_torch/csrc/`` has a plain C entry point. It is
compiled for Hopper (``sm_90a``) into ``build/torch_kernels/`` at the repository root,
under a name that carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for candidate in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc was not found on PATH or under CUDA_HOME; the port's CUDA kernels cannot be built.")


class NativeKernel:
    """One CUDA source, compiled at first use and loaded with ctypes.

    ``argtypes`` must give ``ctypes.c_void_p`` for every pointer and the stream, or
    ctypes passes them as 32-bit ints. The entry point returns a ``cudaError_t``.
    """

    def __init__(self, source: str, entry: str, argtypes: Sequence) -> None:
        self.source = CSRC_DIR / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.build_seconds: Optional[float] = None
        self.build_log = ""  # nvcc's stderr: ptxas registers, shared memory and spills
        self._lib: Optional[ctypes.CDLL] = None
        self._fn: Optional[Callable[..., int]] = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def build(self) -> Path:
        """Compile the source unless a library of the same hash exists; returns its path."""
        lib = self.library_path()
        start = time.perf_counter()
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)], capture_output=True, text=True
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stderr}")
            os.replace(tmp, lib)  # atomic: a concurrent builder never loads a torn library
            self.build_log = proc.stderr
        self.build_seconds = time.perf_counter() - start
        return lib

    def symbol(self, name: str) -> Callable[..., int]:
        """A C function of the library (int result), building and loading it on first call."""
        if self._lib is None:
            self._lib = ctypes.CDLL(str(self.build()))
        fn = getattr(self._lib, name)
        fn.restype = ctypes.c_int
        return fn

    def function(self) -> Callable[..., int]:
        """The bound C entry point, building and loading the library on first call."""
        if self._fn is None:
            fn = self.symbol(self.entry)
            fn.argtypes = self.argtypes
            self._fn = fn
        return self._fn
