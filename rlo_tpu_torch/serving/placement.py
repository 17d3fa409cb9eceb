"""Placement and routing for the serving fabric (docs/DESIGN.md §11).

The port's own copy of ``rlo_tpu/serving/placement.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_fabric.py`` holds them equal).

A ``Placement`` is the fleet's agreed slot-ownership record: the set of
serving members (and, implicitly, their KV slot pools) that request
ownership is computed against. Records are DECIDED by the paper's own
IAR consensus — a survivor proposes the record, every member judges it
against its own membership view, and the AND-merged decision makes it
authoritative — so routing changes are agreed by the same rootless
protocol that agrees on membership itself (the fabric's whole point).

Routing is two-layered, both layers deterministic:

  - admit-time: the gateway that accepted the request picks the owner
    from its (gossiped) load view — least-loaded wins — and embeds the
    choice in the ADMIT record, so every rank agrees on the owner
    without any extra coordination;
  - re-placement: when the admit-time owner leaves the member set, the
    owner is recomputed by rendezvous (highest-random-weight) hashing
    of the request id over the CURRENT placement members — a pure
    function, so every survivor independently agrees on who re-queues
    the orphan without a per-request consensus round.

All hashing is ``zlib.crc32`` (process-stable); ``hash()`` is salted
per interpreter and would break cross-rank agreement.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Placement:
    """One agreed slot-ownership record. ``version`` is the proposer's
    membership epoch at proposal time; ``(version, proposer)`` totally
    orders records (epochs converge upward across heals, rank id
    breaks exact ties), and adoption is newest-wins so a stale record
    re-flooded out of an old view can never regress routing."""
    version: int
    proposer: int
    members: Tuple[int, ...]

    def key(self) -> Tuple[int, int]:
        return (self.version, self.proposer)

    def encode(self) -> bytes:
        m = tuple(self.members)
        return struct.pack(f"<iii{len(m)}i", self.version,
                           self.proposer, len(m), *m)

    @classmethod
    def decode(cls, raw: bytes, off: int = 0) -> Optional["Placement"]:
        if len(raw) - off < 12:
            return None
        version, proposer, n = struct.unpack_from("<iii", raw, off)
        if n < 0 or len(raw) - off - 12 < 4 * n:
            return None
        members = struct.unpack_from(f"<{n}i", raw, off + 12)
        return cls(version, proposer, tuple(sorted(members)))


def rendezvous_owner(gateway: int, seq: int,
                     members: Sequence[int]) -> int:
    """Highest-random-weight owner of request id ``(gateway, seq)``
    over ``members`` — the deterministic re-placement rule every
    survivor computes independently (identical inputs => identical
    owner, no coordination)."""
    if not members:
        raise ValueError("rendezvous over an empty member set")
    key = struct.pack("<ii", gateway, seq)
    best, best_w = -1, -1
    for m in members:
        w = zlib.crc32(key + struct.pack("<i", m))
        if w > best_w or (w == best_w and (best < 0 or m < best)):
            best_w, best = w, m
    return best


def healthy_members(members: Sequence[int],
                    quarantined: Sequence[int] = ()
                    ) -> Tuple[int, ...]:
    """Members minus the fleet-agreed quarantine set. Never empty:
    when quarantine would exclude everyone, the full member set wins —
    serving degraded beats not serving at all (and the blast-radius
    judges make this branch unreachable in a healthy fleet)."""
    if not quarantined:
        return tuple(members)
    out = tuple(m for m in members if m not in set(quarantined))
    return out if out else tuple(members)


def owner_of(rid: Tuple[int, int], admit_owner: int,
             placement: Placement,
             quarantined: Sequence[int] = (),
             avoid: Sequence[int] = ()) -> int:
    """Current owner of a request: the admit-time owner while it is
    still a HEALTHY placement member (the record is authoritative —
    ownership does not churn under load changes), else the rendezvous
    re-placement over the current healthy members (the fail-over
    rule).

    ``quarantined`` is the fleet-AGREED quarantine set (an IAR-decided
    record — identical at every rank, so filtering by it preserves the
    all-ranks-agree property). ``avoid`` is this rank's ADVISORY
    health filter (FleetView epoch-lag / digest staleness — per-rank,
    possibly divergent). Advisory filtering must never wedge the
    fleet, so two fallbacks apply: a rank never avoids itself out of
    the candidate set's perspective (callers strip self from ``avoid``
    — see fabric._advisory_avoid), and when avoidance would empty the
    candidate set it is ignored entirely. Divergent ``avoid`` views
    cost at most a duplicate decode (rid-level dedup absorbs it),
    never a dropped request: HRW weights are per-member, so the winner
    over the agreed set still claims the work even if others skip it.
    """
    healthy = healthy_members(placement.members, quarantined)
    if admit_owner in healthy and admit_owner not in set(avoid):
        return admit_owner
    if admit_owner in healthy and not \
            [m for m in healthy if m not in set(avoid)]:
        return admit_owner  # avoidance would empty the set: ignore it
    cands = [m for m in healthy if m not in set(avoid)] or list(healthy)
    return rendezvous_owner(rid[0], rid[1], cands)


def pick_owner(self_rank: int, members: Sequence[int],
               loads: Dict[int, Tuple[int, int]]) -> int:
    """Gateway-side admit routing: the member with the most free
    slots, then the shallowest queue, then the lowest rank (every tie
    broken deterministically). ``loads`` maps rank -> (free_slots,
    queue_depth) from the Tag.SERVE gossip; members with no report yet
    rank behind reported ones with free capacity but ahead of
    saturated ones (free=0 assumed, depth 0)."""
    best = None
    best_key = None
    for m in sorted(members):
        free, depth = loads.get(m, (0, 0))
        key = (-free, depth, m)
        if best_key is None or key < best_key:
            best_key, best = key, m
    return self_rank if best is None else best
