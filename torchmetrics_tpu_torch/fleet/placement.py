"""Deterministic tenant→host placement: weighted rendezvous hashing (counterpart of
``torchmetrics_tpu/fleet/placement.py``, copied: every tenant lands where the JAX
package places it).

Every router must answer "which host owns tenant T?" identically, with no
coordination and no shared table — the placement is a pure function of the
tenant id and the live host set. Rendezvous (highest-random-weight) hashing
gives exactly that: score every ``(host, tenant)`` pair with a keyed hash
and seat the tenant on the highest-scoring host. Its defining property is
*minimal disruption*: when a host joins or leaves, the only tenants that
move are the ones whose argmax changed — on a leave, exactly the dead
host's tenants (they redistribute across the survivors in hash proportion);
on a join, an ≈``w/(W+w)`` fraction of everyone's tenants (the new host's
fair share) and nobody else.

Weights use the classical ``-w / ln(u)`` transform (Thaler & Ravishankar):
``u`` is the pair hash mapped into ``(0, 1)``, so a host with twice the
weight wins twice the tenants in expectation, and weight changes reshuffle
only the proportional difference. Hashes are sha256 over the UTF-8 encoded
``host\\x00tenant`` pair — deterministic across processes and platforms
(no ``PYTHONHASHSEED`` dependence), which the fleet soak's determinism
contract requires.

:func:`rebalance_plan` turns a membership change into the explicit minimal
move set: recompute the placement under the new host set, diff against the
current assignment, and emit one :class:`Move` per tenant whose owner
changed. The controller feeds these straight into ``migrate``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Hashable, List, Mapping, Optional, Sequence

from ..utilities.exceptions import TorchMetricsUserError

__all__ = ["Move", "placement_score", "place", "place_all", "rebalance_plan"]


def _pair_hash(host_id: str, tenant_id: Hashable) -> float:
    """Keyed hash of one (host, tenant) pair mapped into the open interval
    (0, 1). Tenant ids hash by ``repr`` so ints and strs cannot collide
    (``1`` vs ``"1"``), matching the durability plane's id discipline."""
    h = hashlib.sha256(f"{host_id}\x00{tenant_id!r}".encode("utf-8")).digest()
    # 53 bits -> the full double mantissa; +1/+2 keeps u strictly inside (0,1)
    u = (int.from_bytes(h[:8], "big") >> 11) + 1
    return u / float((1 << 53) + 2)


def placement_score(host_id: str, tenant_id: Hashable, weight: float = 1.0) -> float:
    """The weighted rendezvous score of seating ``tenant_id`` on ``host_id``
    (higher wins). ``-w / ln(u)`` preserves proportional balance: doubling a
    host's weight doubles its expected tenant share without moving any
    tenant whose argmax did not change."""
    if not weight > 0:
        raise TorchMetricsUserError(f"host weight must be > 0, got {weight}")
    return -float(weight) / math.log(_pair_hash(host_id, tenant_id))


def place(tenant_id: Hashable, hosts: Mapping[str, float]) -> str:
    """The owning host for ``tenant_id`` under the live ``hosts`` (host id →
    weight) map. Ties (practically impossible with a 53-bit hash) break by
    host id so every router still agrees."""
    if not hosts:
        raise TorchMetricsUserError("cannot place a tenant on an empty host set")
    return max(
        sorted(hosts),
        key=lambda h: (placement_score(h, tenant_id, hosts[h]), h),
    )


def place_all(
    tenant_ids: Sequence[Hashable], hosts: Mapping[str, float]
) -> Dict[Hashable, str]:
    """Vector form of :func:`place` (one deterministic pass)."""
    return {tid: place(tid, hosts) for tid in tenant_ids}


@dataclasses.dataclass(frozen=True)
class Move:
    """One tenant the rebalance must migrate: ``src`` currently holds it,
    ``dst`` owns it under the new placement. ``src`` is ``None`` for a
    tenant whose current host is gone (a failover adoption, not a live
    migration — there is nothing to drain)."""

    tenant_id: Hashable
    src: Optional[str]
    dst: str


def rebalance_plan(
    assignment: Mapping[Hashable, str], hosts: Mapping[str, float]
) -> List[Move]:
    """The minimal move set from the current ``assignment`` (tenant → host)
    to the rendezvous placement under ``hosts``.

    Rendezvous hashing guarantees minimality by construction: a tenant moves
    only if its argmax host changed, so the plan after a join is the new
    host's fair share and after a leave exactly the lost host's roster.
    Moves sort by ``(dst, repr(tenant))`` — a deterministic migration order
    for the soak's determinism contract."""
    moves = [
        Move(tenant_id=tid, src=cur if cur in hosts else None, dst=want)
        for tid, cur in assignment.items()
        for want in (place(tid, hosts),)
        if want != cur
    ]
    moves.sort(key=lambda m: (m.dst, repr(m.tenant_id)))
    return moves
