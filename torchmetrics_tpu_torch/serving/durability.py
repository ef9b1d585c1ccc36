"""Durability plane: crash-consistent snapshots and a write-ahead traffic journal
(counterpart of ``torchmetrics_tpu/serving/durability.py``; stdlib and numpy, copied).

- :class:`SnapshotStore`: a generation-numbered container for whole-engine snapshots,
  written with the ``aot/cache.py`` discipline (magic, a length-prefixed sorted-JSON
  header, a sha256-verified payload, staged to a same-dir ``.tmp-*`` file, flushed and
  fsynced, then ``os.replace``'d). A torn or corrupt snapshot is a recovery failure:
  every decode problem raises
  :class:`~torchmetrics_tpu_torch.utilities.exceptions.StateCorruptionError`. Older
  generations stay on disk until :meth:`SnapshotStore.prune`.
- :class:`TrafficJournal`: an append-only write-ahead log of ``(seq, tenant_id,
  batch-digest, clock)`` records, CRC-framed, segment-rotated and fsync-batched. It
  stores digests, not payloads: replay fetches each batch from the traffic source's
  retention buffer and the digest proves it is the batch the primary admitted. A
  truncated tail of the last segment is the bounded-loss crash window and is
  tolerated; a damaged complete record, or damage to an earlier segment, raises.

Replay is exactly-once by sequence number: a snapshot records the highest applied
``seq`` and replay skips everything at or below it. The on-disk formats and
:func:`batch_digest` equal the JAX package's byte for byte for the same numpy batch and
records (the digest hashes the tree structure as JAX prints its ``PyTreeDef``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import struct
import uuid
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..aot import keys as _keys
from ..utilities.exceptions import StateCorruptionError, TorchMetricsUserError

SNAPSHOT_MAGIC = b"TMSNAP1\x00"
SNAPSHOT_VERSION = 1
JOURNAL_MAGIC = b"TMJRNL1\x00"
JOURNAL_VERSION = 1
_HEADER_LEN_FMT = ">I"
# snapshots carry the whole tenant roster in the header; journals a few keys
_MAX_HEADER_BYTES = 1 << 22
_REC_FRAME_FMT = "<II"  # [body_len, crc32(body)]
_REC_FRAME_LEN = struct.calcsize(_REC_FRAME_FMT)


def _fsync_write(path_dir: str, final: str, payload: bytes) -> None:
    """The aot/cache.py publish discipline: same-dir tmp, flush + fsync,
    ``os.replace`` — a reader never sees a half-written file."""
    tmp = os.path.join(path_dir, f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    try:
        with open(tmp, "wb") as fh:
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


def _array_blob(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _blob_array(blob: bytes, context: str) -> np.ndarray:
    try:
        return np.lib.format.read_array(io.BytesIO(blob), allow_pickle=False)
    except Exception as err:  # noqa: BLE001 — any decode problem is corruption
        raise StateCorruptionError(f"{context}: section payload is not a valid array: {err}") from err


def encode_tenant_id(tid: Any) -> List[Any]:
    """JSON-safe tenant id encoding. Snapshots/journals support the id types
    real services key sessions on (str/int); anything fancier must be mapped
    by the caller before it reaches the durability plane."""
    if isinstance(tid, bool) or not isinstance(tid, (int, str)):
        raise TorchMetricsUserError(
            f"durable serving requires str or int tenant ids, got {type(tid).__name__}"
        )
    return ["i", int(tid)] if isinstance(tid, int) else ["s", tid]


def decode_tenant_id(enc: Any) -> Any:
    if not (isinstance(enc, (list, tuple)) and len(enc) == 2 and enc[0] in ("i", "s")):
        raise StateCorruptionError(f"malformed tenant id encoding {enc!r}")
    return int(enc[1]) if enc[0] == "i" else str(enc[1])


def _leaf_bytes(leaf: Any) -> Tuple[str, np.ndarray]:
    """A leaf's dtype name and host array as the JAX package hashes it (a bfloat16
    tensor hashes as its ``ml_dtypes`` array would: its name and its raw bytes)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", leaf.contiguous().view(torch.int16).numpy()
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    return str(arr.dtype), arr


def batch_digest(args: tuple, kwargs: dict) -> str:
    """Content digest of one (prepared) batch: the pytree structure plus every leaf's
    dtype, shape and bytes. The journal stores this instead of the payload; replay
    verifies the refetched batch against it bit for bit."""
    inputs = (args, kwargs)
    h = hashlib.sha256()
    h.update(f"PyTreeDef({_keys._structure(inputs)})".encode("utf-8"))
    for leaf in _keys._leaves(inputs):
        name, arr = _leaf_bytes(leaf)
        h.update(name.encode("utf-8"))
        h.update(str(arr.shape).encode("utf-8"))
        h.update(arr.tobytes())
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


class SnapshotStore:
    """Generation-numbered, content-addressed snapshot container.

    Each generation is ONE file (``snap-<n>.tmsnap``): magic, a u32
    length-prefixed sorted-JSON header carrying the engine bookkeeping plus a
    ``[name, len]`` section table and the payload's sha256, then the raw
    section blobs. Writes are atomic (tmp + fsync + ``os.replace``); reads
    validate magic → header bounds → version → section totals → sha256 and
    raise :class:`StateCorruptionError` on ANY mismatch."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path_for(self, generation: int) -> str:
        return os.path.join(self.root, f"snap-{int(generation):08d}.tmsnap")

    def generations(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.startswith("snap-") and name.endswith(".tmsnap"):
                try:
                    out.append(int(name[5:-7]))
                except ValueError:
                    continue
        return sorted(out)

    def write(self, meta: Dict[str, Any], sections: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Publish the next generation atomically; returns
        ``{"generation", "path", "bytes"}``."""
        order: List[Tuple[str, bytes]] = [
            (name, _array_blob(np.asarray(arr))) for name, arr in sections.items()
        ]
        payload = b"".join(blob for _, blob in order)
        gens = self.generations()
        generation = (gens[-1] if gens else 0) + 1
        header = {
            "version": SNAPSHOT_VERSION,
            "generation": generation,
            "meta": dict(meta),
            "sections": [[name, len(blob)] for name, blob in order],
            "sha256": hashlib.sha256(payload).hexdigest(),
        }
        header_bytes = json.dumps(header, sort_keys=True).encode("utf-8")
        blob = SNAPSHOT_MAGIC + struct.pack(_HEADER_LEN_FMT, len(header_bytes)) + header_bytes + payload
        final = self.path_for(generation)
        _fsync_write(self.root, final, blob)
        return {"generation": generation, "path": final, "bytes": len(blob)}

    def prune(self, keep_last: int = 1) -> List[int]:
        """Delete all but the newest ``keep_last`` generations; returns the
        generations removed (oldest first).

        The newest generation is never removable (``keep_last`` must be
        >= 1): pruning bounds disk growth, it must not take away the only
        snapshot a restore could start from. Deleting an old generation is
        safe at any time — generations are immutable once published, and
        nothing references one except an explicit ``read(generation=)``."""
        if keep_last < 1:
            raise TorchMetricsUserError(f"keep_last must be >= 1, got {keep_last}")
        gens = self.generations()
        doomed = gens[:-int(keep_last)] if len(gens) > keep_last else []
        for gen in doomed:
            try:
                os.unlink(self.path_for(gen))
            except OSError:
                pass  # already gone — pruning is idempotent
        return doomed

    def read(self, generation: Optional[int] = None) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """Decode one generation (latest by default) → ``(meta, sections)``.

        Unlike the AOT cache's miss-on-damage ``get``, every validation
        failure here raises ``StateCorruptionError``: a restore must never
        silently load a torn snapshot."""
        gens = self.generations()
        if not gens:
            raise TorchMetricsUserError(f"no snapshot generations in {self.root!r}")
        gen = int(generation) if generation is not None else gens[-1]
        path = self.path_for(gen)
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError as err:
            raise StateCorruptionError(f"snapshot generation {gen} unreadable: {err}") from err
        ctx = f"snapshot {path!r}"
        if not raw.startswith(SNAPSHOT_MAGIC):
            raise StateCorruptionError(f"{ctx}: bad magic")
        off = len(SNAPSHOT_MAGIC)
        if len(raw) < off + struct.calcsize(_HEADER_LEN_FMT):
            raise StateCorruptionError(f"{ctx}: truncated before the header length")
        (hlen,) = struct.unpack_from(_HEADER_LEN_FMT, raw, off)
        off += struct.calcsize(_HEADER_LEN_FMT)
        if hlen <= 0 or hlen > _MAX_HEADER_BYTES or off + hlen > len(raw):
            raise StateCorruptionError(f"{ctx}: header length {hlen} out of bounds")
        try:
            header = json.loads(raw[off : off + hlen].decode("utf-8"))
        except Exception as err:  # noqa: BLE001
            raise StateCorruptionError(f"{ctx}: undecodable header: {err}") from err
        if not isinstance(header, dict) or header.get("version") != SNAPSHOT_VERSION:
            raise StateCorruptionError(
                f"{ctx}: unsupported snapshot version {header.get('version') if isinstance(header, dict) else '?'}"
            )
        payload = raw[off + hlen :]
        table = header.get("sections")
        if not isinstance(table, list) or any(
            not (isinstance(e, list) and len(e) == 2 and isinstance(e[1], int) and e[1] >= 0)
            for e in table
        ):
            raise StateCorruptionError(f"{ctx}: malformed section table")
        if sum(e[1] for e in table) != len(payload):
            raise StateCorruptionError(f"{ctx}: section table does not cover the payload")
        if hashlib.sha256(payload).hexdigest() != header.get("sha256"):
            raise StateCorruptionError(f"{ctx}: payload sha256 mismatch")
        sections: Dict[str, np.ndarray] = {}
        at = 0
        for name, length in table:
            sections[str(name)] = _blob_array(payload[at : at + length], ctx)
            at += length
        return dict(header.get("meta") or {}), sections


# ---------------------------------------------------------------------------
# write-ahead traffic journal
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One journal entry.

    ``kind="admit"`` (the default) records an admitted batch: its sequence
    number, tenant, content digest and the admission-clock timestamp (so
    replay can rebuild the token bucket). ``kind="quarantine"`` records the
    engine quarantining a tenant mid-run — ``digest`` carries the error text
    (there is no batch) and ``rolled_back`` the seqs of the tenant's
    admitted-but-never-folded batches, which the primary rolled back and a
    replaying standby must therefore skip, not fold."""

    seq: int
    tenant_id: Any
    digest: str
    t: float = 0.0
    kind: str = "admit"
    rolled_back: Tuple[int, ...] = ()


class TrafficJournal:
    """Append-only, segment-rotated, fsync-batched write-ahead journal.

    ``append`` frames each record as ``u32 len + u32 crc32 + JSON body`` and
    fsyncs every ``fsync_every`` records (plus on rotation/close). A fresh
    instance always opens a NEW segment numbered after any existing ones, so
    a standby taking over after :meth:`read` keeps appending to the same
    journal directory without rewriting history."""

    def __init__(self, root: str, fsync_every: int = 1, segment_records: int = 512) -> None:
        if fsync_every < 1:
            raise TorchMetricsUserError(f"fsync_every must be >= 1, got {fsync_every}")
        if segment_records < 1:
            raise TorchMetricsUserError(f"segment_records must be >= 1, got {segment_records}")
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.fsync_every = int(fsync_every)
        self.segment_records = int(segment_records)
        self.records = 0
        self.fsyncs = 0
        self._pending = 0  # appended since the last fsync
        self._segment = max(self._segments() or [0]) + 1
        self._seg_records = 0
        self._fh = None
        self._open_segment()

    def _segments(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.startswith("seg-") and name.endswith(".tmj"):
                try:
                    out.append(int(name[4:-4]))
                except ValueError:
                    continue
        return sorted(out)

    def _seg_path(self, segment: int) -> str:
        return os.path.join(self.root, f"seg-{int(segment):08d}.tmj")

    def _open_segment(self) -> None:
        header = json.dumps(
            {"version": JOURNAL_VERSION, "segment": self._segment}, sort_keys=True
        ).encode("utf-8")
        self._fh = open(self._seg_path(self._segment), "wb")
        self._fh.write(JOURNAL_MAGIC)
        self._fh.write(struct.pack(_HEADER_LEN_FMT, len(header)))
        self._fh.write(header)
        self._seg_records = 0
        self._synced_bytes = 0  # durable high-water mark of the active segment

    def append(
        self,
        tenant_id: Any,
        digest: str,
        seq: int,
        t: float = 0.0,
        kind: str = "admit",
        rolled_back: Optional[Iterable[int]] = None,
    ) -> bool:
        """Append one record; returns whether this append fsynced (the
        caller's RPO accounting). ``kind``/``rolled_back`` frame non-admission
        state transitions (see :class:`JournalRecord`); admission records keep
        the original byte layout."""
        doc: Dict[str, Any] = {
            "seq": int(seq), "tenant": encode_tenant_id(tenant_id), "digest": str(digest),
            "t": float(t),
        }
        if kind != "admit":
            doc["kind"] = str(kind)
        if rolled_back:
            doc["rolled_back"] = [int(s) for s in rolled_back]
        body = json.dumps(doc, sort_keys=True).encode("utf-8")
        self._fh.write(struct.pack(_REC_FRAME_FMT, len(body), zlib.crc32(body)))
        self._fh.write(body)
        self.records += 1
        self._seg_records += 1
        self._pending += 1
        synced = False
        if self._pending >= self.fsync_every:
            self.flush()
            synced = True
        if self._seg_records >= self.segment_records:
            self._rotate()
        return synced

    def flush(self) -> None:
        """Push the pending tail to stable storage (one fsync)."""
        if self._fh is None or self._fh.closed:
            return
        self._fh.flush()
        os.fsync(self._fh.fileno())
        if self._pending:
            self.fsyncs += 1
        self._pending = 0
        self._synced_bytes = self._fh.tell()

    def _rotate(self) -> None:
        self.flush()
        self._fh.close()
        self._segment += 1
        self._open_segment()

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self.flush()
            self._fh.close()

    def crash(self) -> None:
        """Simulate process death at this instant: cut the active segment
        back to its last fsync, discarding every record past the durable
        high-water mark — exactly the torn tail :meth:`read` tolerates on
        the final segment. With ``fsync_every=1`` nothing is lost (RPO=0);
        larger batches lose at most the pending ``fsync_every - 1``
        records. The fleet soak's ``host_loss`` fault uses this so a killed
        host's journal looks like a real crash, not a clean shutdown."""
        if self._fh is None or self._fh.closed:
            return
        path = self._seg_path(self._segment)
        try:
            self._fh.close()  # flushes python buffers; durability is decided below
        finally:
            with open(path, "r+b") as fh:
                fh.truncate(self._synced_bytes)

    def __enter__(self) -> "TrafficJournal":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ------------------------------------------------------------------ read

    @classmethod
    def read(cls, root: str) -> List[JournalRecord]:
        """Decode every record in seq order.

        Truncation at the tail of the LAST segment — an incomplete frame, or
        a segment header cut short by a crash during rotation — is the
        bounded-loss window and is tolerated. A *complete* record whose CRC
        or JSON does not check out, anywhere, is corruption and raises
        :class:`StateCorruptionError`; so is any damage to a non-final
        segment (nothing was ever appended past a rotated segment's fsync)."""
        if not os.path.isdir(root):
            return []
        segments = []
        for name in sorted(os.listdir(root)):
            if name.startswith("seg-") and name.endswith(".tmj"):
                segments.append(os.path.join(root, name))
        out: List[JournalRecord] = []
        last_seq = 0
        for si, path in enumerate(segments):
            for rec in _decode_segment(path, is_last=si == len(segments) - 1):
                if rec.seq <= last_seq:
                    raise StateCorruptionError(
                        f"journal segment {path!r}: sequence regressed ({rec.seq} after {last_seq})"
                    )
                last_seq = rec.seq
                out.append(rec)
        return out

    # ----------------------------------------------------------------- prune

    def prune_covered(self, applied_seq: int) -> List[int]:
        """Delete rotated segments whose every record is already covered by a
        retained snapshot's seq cursor; returns the segments removed.

        Replay skips records at or below the snapshot's ``applied_seq``, so a
        segment whose last record's seq is ``<= applied_seq`` contributes
        nothing to any restore that starts from that snapshot (or a newer
        one) — it is dead weight. Seqs are monotone across segments, so
        pruning stops at the first segment with an uncovered record. The
        segment currently open for appends is never touched."""
        removed: List[int] = []
        for seg in self._segments():
            if seg >= self._segment:
                break
            recs = _decode_segment(self._seg_path(seg), is_last=False)
            if recs and recs[-1].seq > int(applied_seq):
                break
            try:
                os.unlink(self._seg_path(seg))
            except OSError:
                pass  # already gone — pruning is idempotent
            removed.append(seg)
        return removed


def _decode_segment(path: str, is_last: bool) -> List[JournalRecord]:
    """Decode one segment file. Torn tails are tolerated only when
    ``is_last`` (nothing was ever appended past a rotated segment's fsync);
    any complete-but-wrong frame raises :class:`StateCorruptionError`."""
    with open(path, "rb") as fh:
        raw = fh.read()
    ctx = f"journal segment {path!r}"
    out: List[JournalRecord] = []
    off = len(JOURNAL_MAGIC)
    if not raw.startswith(JOURNAL_MAGIC) or len(raw) < off + _REC_FRAME_LEN - 4:
        if is_last and len(raw) < off + struct.calcsize(_HEADER_LEN_FMT):
            return out  # rotation crashed before the header landed
        raise StateCorruptionError(f"{ctx}: bad magic")
    (hlen,) = struct.unpack_from(_HEADER_LEN_FMT, raw, off)
    off += struct.calcsize(_HEADER_LEN_FMT)
    if hlen <= 0 or hlen > _MAX_HEADER_BYTES:
        raise StateCorruptionError(f"{ctx}: header length {hlen} out of bounds")
    if off + hlen > len(raw):
        if is_last:
            return out  # torn header tail on the final segment
        raise StateCorruptionError(f"{ctx}: truncated header")
    try:
        header = json.loads(raw[off : off + hlen].decode("utf-8"))
    except Exception as err:  # noqa: BLE001
        raise StateCorruptionError(f"{ctx}: undecodable header: {err}") from err
    if header.get("version") != JOURNAL_VERSION:
        raise StateCorruptionError(f"{ctx}: unsupported version {header.get('version')}")
    off += hlen
    while off < len(raw):
        if off + _REC_FRAME_LEN > len(raw):
            if is_last:
                break  # torn frame tail — bounded loss
            raise StateCorruptionError(f"{ctx}: truncated record frame")
        blen, crc = struct.unpack_from(_REC_FRAME_FMT, raw, off)
        body_at = off + _REC_FRAME_LEN
        if body_at + blen > len(raw):
            if is_last:
                break  # torn body tail — bounded loss
            raise StateCorruptionError(f"{ctx}: truncated record body")
        body = raw[body_at : body_at + blen]
        if zlib.crc32(body) != crc:
            # a COMPLETE record that fails its CRC is a bitflip, not a
            # crash tail — never silently skipped
            raise StateCorruptionError(f"{ctx}: record CRC mismatch at offset {off}")
        try:
            doc = json.loads(body.decode("utf-8"))
            rec = JournalRecord(
                seq=int(doc["seq"]),
                tenant_id=decode_tenant_id(doc["tenant"]),
                digest=str(doc["digest"]),
                t=float(doc.get("t", 0.0)),
                kind=str(doc.get("kind", "admit")),
                rolled_back=tuple(int(s) for s in doc.get("rolled_back", ())),
            )
        except StateCorruptionError:
            raise
        except Exception as err:  # noqa: BLE001
            raise StateCorruptionError(f"{ctx}: undecodable record: {err}") from err
        out.append(rec)
        off = body_at + blen
    return out
