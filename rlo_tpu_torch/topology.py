"""Skip-ring overlay math and the static schedules the collectives run.

The port's own copy of the part of ``rlo_tpu/topology.py`` that the
device collectives, the progress engine and the cost ledgers use (the
port imports nothing of ``rlo_tpu``). Pure functions, no transport, no
state; ``tests/test_torch_topology.py`` holds every schedule equal to
the reference's for ws 1..16 and every origin.

Each schedule round is a list of (src, dst) edges in which every src and
every dst appears at most once, so a round is one ``Axis.ppermute``.
"""

from __future__ import annotations

import functools
from collections import deque
from dataclasses import dataclass
from typing import List, Sequence, Tuple


def is_power_of_2(n: int) -> bool:
    """True iff n is a positive power of two."""
    return n > 0 and (n & (n - 1)) == 0


def level(world_size: int, rank: int) -> int:
    """Skip-ring level of ``rank``: trailing zero bits for rank != 0;
    rank 0 is the hub at log2(ws)-1 (power-of-2 worlds) or
    floor(log2(ws))."""
    if rank == 0:
        ws_log = world_size.bit_length() - 1
        return ws_log - 1 if is_power_of_2(world_size) else ws_log
    return (rank & -rank).bit_length() - 1


def last_wall(world_size: int, rank: int) -> int:
    """Nearest rank with a strictly higher level (rank 0: 2**level)."""
    if rank == 0:
        return 1 << level(world_size, 0)
    return rank & (rank - 1)


@functools.lru_cache(maxsize=None)
def send_list(world_size: int, rank: int) -> Tuple[Tuple[int, ...], int]:
    """Per-rank forward targets ``(targets, send_channel_cnt)``: target i
    is (rank + 2**i) mod ws for i in [0, level]; non-power-of-2 worlds
    truncate at the first overflow and point that slot at rank 0."""
    lvl = level(world_size, rank)
    channel_cnt = lvl
    targets: List[int] = []
    if is_power_of_2(world_size):
        targets = [(rank + (1 << i)) % world_size for i in range(lvl + 1)]
    else:
        for i in range(lvl + 1):
            dest = rank + (1 << i)
            if dest >= world_size:
                if rank == world_size - 1:
                    channel_cnt = 0
                    targets = [0]
                else:
                    channel_cnt = i
                    targets = targets[:i] + [0]
                break
            targets.append(dest)
    return tuple(targets), channel_cnt


def check_passed_origin(world_size: int, my_rank: int, origin: int,
                        to_rank: int) -> bool:
    """True if forwarding to ``to_rank`` would wrap past the broadcast
    origin on the ring (a duplicate) and must be suppressed."""
    if to_rank == origin:
        return True
    if my_rank >= origin:
        if to_rank > my_rank:
            return False
        return not (0 <= to_rank < origin)
    return not (my_rank < to_rank < origin)


@functools.lru_cache(maxsize=1 << 16)
def fwd_targets(world_size: int, rank: int, origin: int,
                from_rank: int) -> Tuple[int, ...]:
    """Destinations ``rank`` forwards a broadcast to, furthest-first."""
    if level(world_size, rank) == 0:
        return ()
    targets, channel_cnt = send_list(world_size, rank)
    if from_rank > last_wall(world_size, rank):
        return tuple(reversed(targets))
    upper = channel_cnt - 1
    if upper < 0:
        return ()
    return tuple(t for t in (targets[j] for j in range(upper, -1, -1))
                 if not check_passed_origin(world_size, rank, origin, t))


def fwd_send_cnt(world_size: int, rank: int, origin: int,
                 from_rank: int) -> int:
    """Number of forwards `rank` performs for a broadcast — equivalently the
    number of child votes an IAR consensus participant must collect before
    voting back to its parent (rootless_ops.c:1559-1579)."""
    return len(fwd_targets(world_size, rank, origin, from_rank))


def initiator_targets(world_size: int, rank: int) -> Tuple[int, ...]:
    """Destinations the origin of a broadcast sends to, furthest-first."""
    targets, _ = send_list(world_size, rank)
    return tuple(reversed(targets))


# Membership-view helpers the progress engine uses, copied from the
# JAX package's topology.

def virtual_map(alive: Sequence[int]) -> dict:
    """real rank -> virtual rank over a sorted alive list — the
    translation the elastic overlay runs the skip-ring math through
    (identity while nothing has failed). One definition shared by the
    failure re-form and the rejoin admission paths, so both always
    rebuild the same view."""
    return {r: v for v, r in enumerate(alive)}


class _IdentityVMap:
    """Subscript-compatible identity rank->virtual map: the value
    every engine's ``_v`` holds until its first view change. A 10k-rank
    simulated fleet would otherwise materialize 10k copies of a
    10k-entry dict (gigabytes, tens of seconds) just to map r -> r;
    real dicts from ``virtual_map`` replace it the moment the view
    actually deviates from identity."""
    __slots__ = ()

    def __getitem__(self, rank: int) -> int:
        return rank

    def __repr__(self) -> str:
        return "IDENTITY_VMAP"


#: shared singleton — stateless, so one instance serves every engine
IDENTITY_VMAP = _IdentityVMap()


@functools.lru_cache(maxsize=1024)
def shared_view(alive: Tuple[int, ...]) -> Tuple[List[int], dict]:
    """``(member list, virtual map)`` for a sorted member tuple,
    cached and SHARED across engines. During a view change every
    surviving engine re-forms the same overlay over the same member
    set; building a private n-entry dict per engine is the O(n^2)
    fleet cost that dominates 10k-rank membership sims. Both returned
    objects must be treated as immutable (engines rebind, never
    mutate). Bounded cache: an evicted view is simply rebuilt — the
    engines only ever compare these by value."""
    members = list(alive)
    return members, virtual_map(members)


@functools.lru_cache(maxsize=None)
def identity_members(world_size: int) -> List[int]:
    """The full-world member list ``[0..world_size)``, cached and
    SHARED across engines (every engine of a big simulated world holds
    the same pre-failure view; per-engine copies are the construction
    bottleneck at n >= 10k ranks). Callers must treat it as immutable
    — the engine only ever REBINDS its ``_alive``/``group`` on view
    changes, never mutates them in place."""
    return list(range(world_size))


def ring_neighbors(alive: Sequence[int], rank: int) -> Tuple[int, int]:
    """(successor, predecessor) of ``rank`` on the alive ring — the
    heartbeat monitoring edges of the failure detector."""
    i = alive.index(rank)
    n = len(alive)
    return alive[(i + 1) % n], alive[(i - 1) % n]


@dataclass(frozen=True)
class BcastSchedule:
    """Precomputed broadcast wavefront: rounds of (src, dst) edges."""
    world_size: int
    origin: int
    rounds: Tuple[Tuple[Tuple[int, int], ...], ...]

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)


@functools.lru_cache(maxsize=None)
def skip_ring_bcast_schedule(world_size: int, origin: int) -> BcastSchedule:
    """The reactive skip-ring forwarding unrolled into static rounds:
    spanning-tree edges in BFS issue order, greedily packed into rounds
    (one send and one receive per rank per round, a src fires only after
    it has received)."""
    edges: List[Tuple[int, int]] = []
    q = deque([(origin, None)])
    seen = {origin}
    while q:
        rank, frm = q.popleft()
        targets = (initiator_targets(world_size, rank) if frm is None
                   else fwd_targets(world_size, rank, origin, frm))
        for dst in targets:
            if dst in seen:
                continue
            seen.add(dst)
            edges.append((rank, dst))
            q.append((dst, rank))

    ready = {origin: 0}
    rounds: List[Tuple[Tuple[int, int], ...]] = []
    pending = edges
    while pending:
        rnd: List[Tuple[int, int]] = []
        used_src, used_dst = set(), set()
        rest: List[Tuple[int, int]] = []
        for src, dst in pending:
            if (src in ready and ready[src] <= len(rounds)
                    and src not in used_src and dst not in used_dst):
                rnd.append((src, dst))
                used_src.add(src)
                used_dst.add(dst)
                ready[dst] = len(rounds) + 1
            else:
                rest.append((src, dst))
        if not rnd:
            raise RuntimeError("schedule packing stalled")
        rounds.append(tuple(rnd))
        pending = rest
    return BcastSchedule(world_size, origin, tuple(rounds))


@functools.lru_cache(maxsize=None)
def binomial_bcast_schedule(world_size: int, origin: int) -> BcastSchedule:
    """Binomial-tree broadcast in ceil(log2(ws)) rounds: round i, every
    rank at relative position r < 2**i sends to r + 2**i."""
    rounds = []
    i = 0
    while (1 << i) < world_size:
        step = 1 << i
        rounds.append(tuple(
            (((r + origin) % world_size), ((r + step + origin) % world_size))
            for r in range(step) if r + step < world_size))
        i += 1
    return BcastSchedule(world_size, origin, tuple(rounds))


def ring_perm(world_size: int, offset: int = 1) -> Tuple[Tuple[int, int], ...]:
    """The ring permutation rank -> rank+offset (mod ws)."""
    return tuple((i, (i + offset) % world_size) for i in range(world_size))


@functools.lru_cache(maxsize=None)
def recursive_doubling_rounds(
        world_size: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Round i swaps rank <-> rank XOR 2**i (power-of-2 worlds)."""
    if not is_power_of_2(world_size):
        raise ValueError("recursive doubling requires power-of-2 world size")
    rounds = []
    i = 0
    while (1 << i) < world_size:
        rounds.append(xor_perm(world_size, 1 << i))
        i += 1
    return tuple(rounds)


def xor_perm(world_size: int, dist: int) -> Tuple[Tuple[int, int], ...]:
    """The self-inverse pairwise exchange rank <-> rank XOR dist."""
    return tuple((r, r ^ dist) for r in range(world_size))


@functools.lru_cache(maxsize=None)
def halving_doubling_distances(world_size: int) -> Tuple[int, ...]:
    """Recursive-halving distances ws/2, ..., 1 (reversed: the doubling
    all-gather's)."""
    if not is_power_of_2(world_size):
        raise ValueError("halving/doubling requires power-of-2 world size")
    return tuple(world_size >> k for k in range(1, world_size.bit_length()))


def ring_reduce_scatter_chunk(world_size: int, rank: int, step: int) -> int:
    """Chunk index ``rank`` sends at ``step`` of a ring reduce-scatter.

    At step s (0-based, ws-1 steps) a rank sends chunk (rank - s) mod ws
    to rank+1 and accumulates chunk (rank - s - 1) mod ws; after ws-1
    steps it owns the full reduction of chunk (rank + 1) mod ws. The
    cost ledgers (``observe/ledger.py``) replay the ring through it.
    """
    return (rank - step) % world_size


def describe(world_size: int) -> str:
    """Human-readable topology table (a debugging aid)."""
    lines = [f"world_size={world_size} (pow2={is_power_of_2(world_size)})"]
    for r in range(world_size):
        targets, cc = send_list(world_size, r)
        lines.append(
            f"  rank {r:3d}: level={level(world_size, r)} "
            f"last_wall={last_wall(world_size, r)} "
            f"send_list={list(targets)} channels={cc}")
    return "\n".join(lines)
