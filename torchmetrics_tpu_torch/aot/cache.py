"""Content-addressed on-disk store for serialized metric programs (a copy of
``torchmetrics_tpu/aot/cache.py``: stdlib only, the same container byte for byte).

One cache entry per file, named by the SHA-256 of its full cache key
(``keys.cache_key``) — content addressing means concurrent writers of the
same program write the same bytes, and a key change IS a new file. The
container is deliberately paranoid about partial state:

- **Atomic publication.** Entries are written to a same-directory temp file,
  flushed + fsynced, then ``os.replace``'d into place — a reader never sees a
  half-written entry under the final name, and concurrent writers last-win
  with identical content. A crashed writer leaves only a ``.tmp-*`` file,
  which ``prune_tmp`` (and every ``put`` to the same key) sweeps.
- **Corruption is a miss, never an error.** Every read validates magic,
  header shape, section lengths, the stored key (hash collisions and
  truncations die here) and a SHA-256 over the payload bytes (bitflips die
  here). Anything wrong → ``None`` — the dispatch path falls back to the
  eager program exactly as if the entry never existed.

Container layout::

    b"TMAOT1\\0"  | u32 header length | header JSON | section payloads

with the header carrying ``{"version", "key", "meta", "sections": [[name,
length], ...], "sha256"}`` and payloads concatenated in section order.

The payloads themselves are produced by ``aot.codecs`` (AOTInductor packages /
``torch.export`` archives). Deserializing them executes pickle and loads native
code: treat a cache directory with the same trust as the installed packages —
i.e. point it at operator-owned storage, not a world-writable drop box.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import uuid
from typing import Any, Dict, Iterator, List, Optional, Tuple

MAGIC = b"TMAOT1\x00"
_HEADER_LEN_FMT = ">I"
_MAX_HEADER_BYTES = 1 << 20  # a sane header is a few hundred bytes


class CacheEntry:
    """One decoded cache entry: header metadata + raw codec sections."""

    __slots__ = ("key", "meta", "sections", "nbytes", "path")

    def __init__(self, key: str, meta: Dict[str, Any], sections: Dict[str, bytes], nbytes: int, path: str) -> None:
        self.key = key
        self.meta = meta
        self.sections = sections
        self.nbytes = nbytes
        self.path = path


class AotCache:
    """Filesystem-backed cache rooted at ``root`` (created on first use)."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(os.path.expanduser(str(root)))
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------- addressing

    @staticmethod
    def entry_name(key: str) -> str:
        return hashlib.sha256(key.encode("utf-8")).hexdigest()

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, self.entry_name(key) + ".aot")

    def has(self, key: str) -> bool:
        return os.path.exists(self.path_for(key))

    # ---------------------------------------------------------------- writing

    def put(self, key: str, sections: Dict[str, bytes], meta: Optional[Dict[str, Any]] = None) -> str:
        """Publish one entry atomically; returns its final path."""
        order: List[Tuple[str, bytes]] = [(name, bytes(blob)) for name, blob in sections.items()]
        payload = b"".join(blob for _, blob in order)
        header = {
            "version": 1,
            "key": key,
            "meta": dict(meta or {}),
            "sections": [[name, len(blob)] for name, blob in order],
            "sha256": hashlib.sha256(payload).hexdigest(),
        }
        header_bytes = json.dumps(header, sort_keys=True).encode("utf-8")
        final = self.path_for(key)
        tmp = os.path.join(self.root, f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        try:
            with open(tmp, "wb") as fh:
                fh.write(MAGIC)
                fh.write(struct.pack(_HEADER_LEN_FMT, len(header_bytes)))
                fh.write(header_bytes)
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):  # publish failed after write — sweep
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return final

    # ---------------------------------------------------------------- reading

    def get(self, key: str) -> Optional[CacheEntry]:
        """Load and validate one entry; ``None`` on absence OR any corruption."""
        path = self.path_for(key)
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return None
        entry = self._decode(raw, path)
        if entry is None or entry.key != key:
            # key mismatch: truncated-to-another-entry or a hash collision —
            # either way this is not the requested program
            return None
        try:
            # refresh mtime as a last-hit stamp: the size-budget pruner evicts
            # least-recently-LOADED entries, not least-recently-written ones
            os.utime(path)
        except OSError:
            pass
        return entry

    @staticmethod
    def _decode(raw: bytes, path: str) -> Optional[CacheEntry]:
        try:
            if not raw.startswith(MAGIC):
                return None
            off = len(MAGIC)
            (hlen,) = struct.unpack_from(_HEADER_LEN_FMT, raw, off)
            off += struct.calcsize(_HEADER_LEN_FMT)
            if hlen <= 0 or hlen > _MAX_HEADER_BYTES or off + hlen > len(raw):
                return None
            header = json.loads(raw[off : off + hlen].decode("utf-8"))
            off += hlen
            if header.get("version") != 1 or not isinstance(header.get("sections"), list):
                return None
            payload = raw[off:]
            total = sum(int(n) for _, n in header["sections"])
            if len(payload) != total:
                return None
            if hashlib.sha256(payload).hexdigest() != header.get("sha256"):
                return None
            sections: Dict[str, bytes] = {}
            at = 0
            for name, n in header["sections"]:
                sections[str(name)] = payload[at : at + int(n)]
                at += int(n)
            return CacheEntry(
                key=str(header.get("key", "")), meta=dict(header.get("meta", {})),
                sections=sections, nbytes=len(raw), path=path,
            )
        except Exception:  # noqa: BLE001 — any malformed byte is a miss
            return None

    # ------------------------------------------------------------- inspection

    def entries(self) -> Iterator[CacheEntry]:
        """Iterate decodable entries (corrupt files are silently skipped —
        ``scan()`` reports them)."""
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".aot"):
                continue
            path = os.path.join(self.root, name)
            try:
                with open(path, "rb") as fh:
                    raw = fh.read()
            except OSError:
                continue
            entry = self._decode(raw, path)
            if entry is not None:
                yield entry

    def scan(self) -> Dict[str, Any]:
        """Cache health report: entry/byte totals plus undecodable files."""
        ok, corrupt, total_bytes = 0, [], 0
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if name.startswith(".tmp-"):
                corrupt.append(name)
                continue
            if not name.endswith(".aot"):
                continue
            try:
                with open(path, "rb") as fh:
                    raw = fh.read()
            except OSError:
                corrupt.append(name)
                continue
            if self._decode(raw, path) is None:
                corrupt.append(name)
            else:
                ok += 1
                total_bytes += len(raw)
        return {"root": self.root, "entries": ok, "bytes": total_bytes, "undecodable": corrupt}

    def prune(self, max_bytes: int) -> Dict[str, Any]:
        """LRU size budget: delete entries, least-recently-hit first, until
        the cache's decodable bytes fit ``max_bytes``.

        Recency is the file mtime, which :meth:`get` refreshes on every
        validated load — so a self-warming fleet's hot programs survive and
        the long tail of one-off shapes gets reclaimed. Undecodable ``.aot``
        files are deleted unconditionally (they can never serve a load), as
        are orphaned temp files. Returns a report dict.
        """
        if max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        swept_tmp = self.prune_tmp()
        live: List[Tuple[float, int, str]] = []  # (mtime, size, path)
        removed: List[str] = []
        freed = 0
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".aot"):
                continue
            path = os.path.join(self.root, name)
            try:
                stat = os.stat(path)
                with open(path, "rb") as fh:
                    raw = fh.read()
            except OSError:
                continue
            if self._decode(raw, path) is None:
                try:
                    os.unlink(path)
                    removed.append(name)
                    freed += len(raw)
                except OSError:
                    pass
                continue
            live.append((stat.st_mtime, len(raw), path))
        total = sum(size for _, size, _ in live)
        live.sort()  # oldest last-hit first
        for _, size, path in live:
            if total <= max_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            removed.append(os.path.basename(path))
            freed += size
            total -= size
        return {
            "root": self.root, "max_bytes": int(max_bytes), "removed": removed,
            "freed_bytes": freed, "kept_entries": sum(1 for _, s, p in live if os.path.exists(p)),
            "kept_bytes": total, "swept_tmp": swept_tmp,
        }

    def prune_tmp(self) -> int:
        """Sweep orphaned temp files from crashed writers."""
        swept = 0
        for name in os.listdir(self.root):
            if name.startswith(".tmp-"):
                try:
                    os.unlink(os.path.join(self.root, name))
                    swept += 1
                except OSError:
                    pass
        return swept

    def clear(self) -> int:
        removed = 0
        for name in os.listdir(self.root):
            if name.endswith(".aot") or name.startswith(".tmp-"):
                try:
                    os.unlink(os.path.join(self.root, name))
                    removed += 1
                except OSError:
                    pass
        return removed
