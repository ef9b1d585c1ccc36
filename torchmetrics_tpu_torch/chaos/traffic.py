"""Replayable production-shaped traffic (counterpart of ``torchmetrics_tpu/chaos/traffic.py``,
copied: numpy and the stdlib only, so a trace and its batches are the JAX package's byte
for byte).

A :class:`TrafficModel` turns one integer seed into the load pattern the
serving plane actually faces in production — and the same seed always turns
into the *same* pattern, event for event, byte for byte:

- **Zipf-skewed popularity**: tenant ``i``'s arrival weight is
  ``1/(rank+1)^s`` over the live roster, so a handful of head tenants stay
  resident while the long tail churns through the LRU spill plane.
- **Bursty arrivals** (doubly stochastic): each step draws a Poisson event
  count whose rate itself switches between a base level and a
  ``burst_factor`` multiple via a seeded burst state machine — the load
  shape that makes admission control and shed accounting interesting.
- **Mixed shape-classes**: each tenant is pinned to one batch size (the
  engine's stable-shape contract), so traffic exercises several compiled
  megabatch programs concurrently.
- **Scripted churn**: every ``churn_every`` steps a slice of the roster
  departs and a mix of brand-new and *readmitted* (previously departed)
  tenants arrives — deliberately thrashing spill/readmit.

Determinism has two layers. The **schedule** (which tenant fires at which
step) is simulated once with a Philox generator keyed on the seed. Each
event's **batch payload** is generated independently from a counter-based
Philox key ``(seed, event_index)`` — order-independent, so a replayed trace
regenerates identical batches without storing them. A trace file therefore
stores only the schedule arrays plus the config (a few bytes per event) in
a flat binary container with no timestamps: saving the same model twice
produces identical bytes, the replay contract ``docs/chaos.md`` documents.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utilities.exceptions import TorchMetricsUserError

_MAGIC = b"CHAOSTRC"
_VERSION = 1
# multiplicative hash constant (Knuth) — per-tenant accuracy profiles
_HASH = 2654435761


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Knobs for one seeded traffic stream (all defaults CPU-test sized).

    Args:
        seed: the whole stream — schedule AND per-event batches — is a pure
            function of this integer.
        tenants: initial roster size (churn grows ids past this).
        steps: simulated steps (one virtual clock tick each).
        zipf_exponent: popularity skew ``s`` in ``1/(rank+1)^s``; higher
            concentrates traffic on the head tenants.
        base_rate: mean events per step outside bursts (Poisson).
        burst_factor: rate multiplier while a burst is active.
        burst_prob: per-step probability a burst starts.
        burst_length: steps a burst lasts once started.
        shape_classes: batch sizes; tenant ``t`` is pinned to
            ``shape_classes[t % len(shape_classes)]`` forever.
        num_classes: label arity of the generated classification batches.
        churn_every: churn the roster every this many steps (0 disables).
        churn_count: tenants departed (and replaced) per churn event.
    """

    seed: int = 0
    tenants: int = 24
    steps: int = 120
    zipf_exponent: float = 1.1
    base_rate: float = 4.0
    burst_factor: float = 4.0
    burst_prob: float = 0.08
    burst_length: int = 6
    shape_classes: Tuple[int, ...] = (4, 8)
    num_classes: int = 3
    churn_every: int = 30
    churn_count: int = 4

    def __post_init__(self) -> None:
        if not (isinstance(self.seed, int) and 0 <= self.seed < 2 ** 64):
            raise ValueError(f"seed must be an integer in [0, 2**64), got {self.seed}")
        if not (isinstance(self.tenants, int) and self.tenants >= 1):
            raise ValueError(f"tenants must be a positive integer, got {self.tenants}")
        if not (isinstance(self.steps, int) and self.steps >= 1):
            raise ValueError(f"steps must be a positive integer, got {self.steps}")
        if self.zipf_exponent <= 0:
            raise ValueError(f"zipf_exponent must be > 0, got {self.zipf_exponent}")
        if self.base_rate <= 0 or self.burst_factor < 1.0:
            raise ValueError(
                f"base_rate must be > 0 and burst_factor >= 1, got "
                f"{self.base_rate}/{self.burst_factor}"
            )
        if not 0.0 <= self.burst_prob <= 1.0:
            raise ValueError(f"burst_prob must be in [0, 1], got {self.burst_prob}")
        if not self.shape_classes or any(int(b) < 1 for b in self.shape_classes):
            raise ValueError(f"shape_classes must be positive batch sizes, got {self.shape_classes}")
        if self.num_classes < 2:
            raise ValueError(f"num_classes must be >= 2, got {self.num_classes}")
        if self.churn_every < 0 or self.churn_count < 0:
            raise ValueError("churn_every/churn_count must be >= 0")


@dataclasses.dataclass(frozen=True)
class TrafficEvent:
    """One admitted-or-shed unit of load: a tenant's batch at a step."""

    index: int
    step: int
    tenant_id: int
    shape_class: int  # index into TrafficConfig.shape_classes
    batch: Tuple[np.ndarray, np.ndarray]  # (preds, target) labels


def _zipf_weights(n: int, exponent: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), exponent)
    return w / w.sum()


class TrafficModel:
    """The seeded stream. Construction simulates the full schedule (two
    int32 arrays: step and tenant per event); batches are generated lazily
    per event from the counter-based key, so iteration is cheap to restart.
    """

    def __init__(
        self,
        config: TrafficConfig,
        _schedule: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> None:
        self.config = config
        if _schedule is not None:
            self._steps, self._tenants = _schedule
        else:
            self._steps, self._tenants = self._simulate()
        self.replayed = _schedule is not None

    # ------------------------------------------------------------- simulation

    def _simulate(self) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.config
        rng = np.random.Generator(np.random.Philox(key=np.uint64(cfg.seed)))
        active: List[int] = list(range(cfg.tenants))
        departed: List[int] = []
        next_id = cfg.tenants
        burst_left = 0
        ev_steps: List[int] = []
        ev_tenants: List[int] = []
        for step in range(cfg.steps):
            if cfg.churn_every and step and step % cfg.churn_every == 0 and cfg.churn_count:
                # depart from the tail half (head tenants are the hot set that
                # must stay resident for the Zipf skew to mean anything)
                k = min(cfg.churn_count, max(len(active) - 1, 0))
                if k:
                    tail = active[len(active) // 2:]
                    out_idx = rng.choice(len(tail), size=min(k, len(tail)), replace=False)
                    leaving = {tail[i] for i in out_idx}
                    active = [t for t in active if t not in leaving]
                    departed.extend(sorted(leaving))
                    # arrivals: readmit up to half from the departed pool
                    # (their spilled state thaws), fill the rest with new ids
                    readmit = min(len(departed) - len(leaving), k // 2)
                    for _ in range(max(readmit, 0)):
                        active.append(departed.pop(0))
                    while len(active) < cfg.tenants:
                        active.append(next_id)
                        next_id += 1
            if burst_left > 0:
                burst_left -= 1
                rate = cfg.base_rate * cfg.burst_factor
            elif rng.random() < cfg.burst_prob:
                burst_left = cfg.burst_length - 1
                rate = cfg.base_rate * cfg.burst_factor
            else:
                rate = cfg.base_rate
            n = int(rng.poisson(rate))
            if n == 0:
                continue
            weights = _zipf_weights(len(active), cfg.zipf_exponent)
            picks = rng.choice(len(active), size=n, p=weights)
            for i in picks:
                ev_steps.append(step)
                ev_tenants.append(active[int(i)])
        return (
            np.asarray(ev_steps, np.int32),
            np.asarray(ev_tenants, np.int32),
        )

    # --------------------------------------------------------------- batches

    def shape_class(self, tenant_id: int) -> int:
        return int(tenant_id) % len(self.config.shape_classes)

    def _batch(self, index: int, tenant_id: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.config
        size = cfg.shape_classes[self.shape_class(tenant_id)]
        key = (np.uint64(cfg.seed).item() << 64) | np.uint64(index).item()
        rng = np.random.Generator(np.random.Philox(key=key))
        target = rng.integers(0, cfg.num_classes, size=size).astype(np.int32)
        # per-tenant accuracy profile: stable agreement probability per id
        agree = 0.45 + 0.5 * (((tenant_id * _HASH) & 0xFFFF) / 0xFFFF)
        flip = rng.random(size) >= agree
        offset = rng.integers(1, cfg.num_classes, size=size).astype(np.int32)
        preds = np.where(flip, (target + offset) % cfg.num_classes, target).astype(np.int32)
        return preds, target

    def events(self) -> Iterator[TrafficEvent]:
        """Iterate the stream; batches regenerate identically every pass."""
        for i in range(self._steps.shape[0]):
            tid = int(self._tenants[i])
            yield TrafficEvent(
                index=i,
                step=int(self._steps[i]),
                tenant_id=tid,
                shape_class=self.shape_class(tid),
                batch=self._batch(i, tid),
            )

    @property
    def num_events(self) -> int:
        return int(self._steps.shape[0])

    def schedule(self) -> Tuple[np.ndarray, np.ndarray]:
        """Copies of the (step, tenant) schedule arrays."""
        return self._steps.copy(), self._tenants.copy()

    # ----------------------------------------------------------------- traces

    def trace_bytes(self) -> bytes:
        """The canonical trace encoding: magic + version + sorted-key JSON
        header + raw little-endian int32 schedule arrays. No timestamps, no
        compression dictionaries — identical model ⇒ identical bytes."""
        header = json.dumps(
            {
                "config": dataclasses.asdict(self.config),
                "events": self.num_events,
            },
            sort_keys=True,
            separators=(",", ":"),
        ).encode("utf-8")
        out = bytearray()
        out += _MAGIC
        out += struct.pack("<II", _VERSION, len(header))
        out += header
        out += self._steps.astype("<i4", copy=False).tobytes()
        out += self._tenants.astype("<i4", copy=False).tobytes()
        return bytes(out)

    def save_trace(self, path: str) -> int:
        """Write the trace file atomically; returns bytes written.

        tmp + fsync + ``os.replace``: a crash mid-write leaves either the
        previous trace or none — never a torn file that ``load_trace`` would
        half-parse into a silently different replay.
        """
        import uuid

        payload = self.trace_bytes()
        path = str(path)
        tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "wb") as fh:
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return len(payload)

    @classmethod
    def load_trace(cls, path: str) -> "TrafficModel":
        """Rebuild a model from a trace file — the schedule is read back
        verbatim (no re-simulation), batches regenerate from the counter
        keys, so the replay is byte-for-byte the recorded run."""
        with open(path, "rb") as fh:
            raw = fh.read()
        if raw[: len(_MAGIC)] != _MAGIC:
            raise TorchMetricsUserError(f"{path!r} is not a chaos trace (bad magic).")
        version, hlen = struct.unpack_from("<II", raw, len(_MAGIC))
        if version != _VERSION:
            raise TorchMetricsUserError(f"unsupported trace version {version} in {path!r}")
        off = len(_MAGIC) + 8
        header = json.loads(raw[off : off + hlen].decode("utf-8"))
        off += hlen
        cfg_dict = dict(header["config"])
        cfg_dict["shape_classes"] = tuple(cfg_dict["shape_classes"])
        config = TrafficConfig(**cfg_dict)
        n = int(header["events"])
        need = off + 2 * 4 * n
        if len(raw) < need:
            raise TorchMetricsUserError(
                f"trace {path!r} is truncated: {len(raw)} bytes, need {need}."
            )
        steps = np.frombuffer(raw, dtype="<i4", count=n, offset=off).astype(np.int32)
        tenants = np.frombuffer(raw, dtype="<i4", count=n, offset=off + 4 * n).astype(np.int32)
        return cls(config, _schedule=(steps, tenants))

    def __repr__(self) -> str:
        return (
            f"TrafficModel(seed={self.config.seed}, events={self.num_events}, "
            f"steps={self.config.steps}, replayed={self.replayed})"
        )
