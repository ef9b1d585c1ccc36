"""Serialization codecs for compiled metric programs (counterpart of
``torchmetrics_tpu/aot/codecs.py``).

Two codecs, layered by what they can skip at load time:

- :data:`CODEC_EXEC` (``"aoti"``) — the bytes of an AOTInductor package
  (``aoti_compile_and_package`` of the ``torch.export`` program): generated kernels
  and their C++ launcher, compiled. Loading skips EVERYTHING: no Python trace, no
  export, no Inductor compile. It is valid only for the runtime generation in the
  cache key's fingerprint.
- :data:`CODEC_HLO` (``"torch_export"``) — the portable ``torch.export.save``
  archive. Loading skips the trace; the program runs as
  ``ExportedProgram.module()``, the exported graph's ATen ops one by one. It is the
  fallback when the native payload fails to load (a runtime that changed its package
  format under the same fingerprint) and the answer where AOTInductor cannot compile.

Both payloads carry their own calling convention (the exported input and output tree
specs), so a load needs nothing else.

Trust: decoding unpickles and loads native code. A cache directory is as trusted as
the installed packages: point it at operator-owned storage, never at a world-writable
drop box.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Tuple

from . import compat

CODEC_EXEC = "aoti"
CODEC_HLO = "torch_export"

#: load preference order — native first, portable fallback
CODEC_ORDER: Tuple[str, ...] = (CODEC_EXEC, CODEC_HLO)


class CodecError(Exception):
    """A payload could not be produced or decoded (callers treat decode failures as
    cache misses)."""


def _first_line(err: BaseException) -> str:
    text = str(err).strip().splitlines()
    return f"{type(err).__name__}: {text[0] if text else ''}"[:200]


# ---------------------------------------------------------------------- aoti


def encode_executable(exported: Any) -> bytes:
    """``ExportedProgram`` → the bytes of its AOTInductor package."""
    if not compat.aoti_available():
        raise CodecError("no AOTInductor on this runtime")
    try:
        with tempfile.TemporaryDirectory(prefix="tm-aoti-") as tmp:
            path = compat.aoti_package(exported, os.path.join(tmp, "program.pt2"))
            with open(path, "rb") as fh:
                return fh.read()
    except Exception as err:  # noqa: BLE001 — a compiler that refuses degrades to portable
        raise CodecError(f"AOTInductor packaging failed: {_first_line(err)}") from err


def decode_executable(blob: bytes) -> Callable[..., Any]:
    """Package bytes → the loaded program. The loader takes a path, so the bytes go to
    a private temporary file that is removed once loaded."""
    try:
        fd, path = tempfile.mkstemp(prefix="tm-aoti-", suffix=".pt2")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(blob)
            return compat.aoti_load(path)
        finally:
            os.unlink(path)
    except Exception as err:  # noqa: BLE001 — any decode failure is a miss
        raise CodecError(f"AOTInductor package load failed: {_first_line(err)}") from err


# -------------------------------------------------------------- torch_export


def encode_exported(exported: Any) -> bytes:
    if not compat.export_available():
        raise CodecError("no torch.export on this runtime")
    try:
        return compat.serialize_exported(exported)
    except Exception as err:  # noqa: BLE001
        raise CodecError(f"torch.export serialization failed: {_first_line(err)}") from err


def decode_exported(blob: bytes) -> Callable[..., Any]:
    """Portable payload → the exported graph as a callable module (no trace)."""
    try:
        return compat.deserialize_exported(blob).module()
    except Exception as err:  # noqa: BLE001
        raise CodecError(f"torch.export deserialization failed: {_first_line(err)}") from err


def encode_sections(exported: Any, store_portable: bool = True) -> Tuple[Dict[str, bytes], Dict[str, Any]]:
    """Build the cache sections for one exported program. Each codec is best-effort —
    a runtime whose AOTInductor cannot compile still gets a portable entry, and vice
    versa; only BOTH failing is an error. What failed and why lands in the entry
    metadata. The native package is built first: the portable codec drops the
    program's example inputs."""
    sections: Dict[str, bytes] = {}
    meta: Dict[str, Any] = {"codecs": []}
    try:
        sections[CODEC_EXEC] = encode_executable(exported)
        meta["codecs"].append(CODEC_EXEC)
    except CodecError as err:
        meta["native_error"] = str(err)[:200]
    if store_portable or not sections:
        try:
            sections[CODEC_HLO] = encode_exported(exported)
            meta["codecs"].append(CODEC_HLO)
        except CodecError as err:
            meta["portable_error"] = str(err)[:200]
    if not sections:
        raise CodecError(
            "no codec could serialize this program: "
            f"native={meta.get('native_error')!r} portable={meta.get('portable_error')!r}"
        )
    return sections, meta


def decode_entry(sections: Dict[str, bytes]) -> Tuple[Any, str]:
    """Load the best available payload → ``(callable, codec_name)``.

    Tries codecs in :data:`CODEC_ORDER`; raises :class:`CodecError` only when every
    present section fails (the caller turns that into a cache miss).
    """
    last = None
    for codec in CODEC_ORDER:
        blob = sections.get(codec)
        if not blob:
            continue
        try:
            if codec == CODEC_EXEC:
                return decode_executable(blob), codec
            return decode_exported(blob), codec
        except CodecError as err:
            last = err
    raise last or CodecError("entry carries no known codec section")
