"""rlo-scope cost ledgers: deterministic per-step byte x edge accounts
of the committed collective schedules (docs/DESIGN.md §21).

The port's own copy of ``rlo_tpu/observe/ledger.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_observe.py`` holds them equal).

Every schedule the executors run (binomial / skip-ring broadcast, ring
reduce-scatter / all-gather, recursive doubling, halving-doubling) is
generated by ``rlo_tpu_torch.topology`` and proven correct by rlo-prover P2's
symbolic token algebra.  This module replays the SAME generators with
the SAME algebra and records what the proofs only assert: for every
step, the exact (src -> dst) edges, the bytes each edge carries, and
the cumulative contribution mask the payload represents.  The result —
a :class:`Ledger` — is the single source of truth for predicted
collective bytes:

  - the executor instrumentation (ops/collectives.py step probes,
    ops/tpu_collectives.py trace-time step hooks) labels measured
    steps with ledger step identities;
  - the JAX package's ``tools/rlo_scope.py`` joins measured step
    timings against ledger bytes to attribute bandwidth per step;
  - ``bench.py`` sources its bus-byte figures from ledger totals
    instead of inline arithmetic;
  - ``benchmarks/collective_bench.py`` pins ledger-derived step/byte
    counts at zero tolerance.

Construction FAILS (:class:`LedgerError`) if the generators violate
the token algebra — misaligned chunks, double-counted or dropped
contributions, undelivered broadcasts — so a perturbed schedule
generator cannot produce a ledger at all, let alone a drifted one.
tests/test_ledger.py additionally cross-checks every ledger's final
algebra state against rlo-prover P2's simulators for all n <= 64.

Everything here is pure deterministic stdlib + ``rlo_tpu_torch.topology``
(no jax, no numpy, no wall clock, no randomness — the module is in
rlo-lint R5's determinism scope): ledgers for one (schedule, n,
nbytes) are bit-identical across runs and machines.

Byte model: ``nbytes`` is the logical per-rank payload;
chunk-granular schedules pad at ELEMENT granularity exactly as the
implementations do (``itemsize`` bytes per element, f32 default), so
ledger figures match both the lowered-HLO pins of
``tpu_collectives.allreduce_cost`` and the numpy payload sizes the
engine-substrate ``Comm`` actually sends.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

from rlo_tpu_torch import topology


class LedgerError(ValueError):
    """The schedule generators violated the token algebra (or the
    requested ledger is malformed) — the cross-check's failure mode."""


#: atomic schedule names, indexed by the Ev.STEP ``a`` field — the
#: executors emit these ids, timeline.py renders "name:step" slices
#: from this table, and rlo-scope joins on them.  Append-only.
ALGORITHMS = (
    "binomial_bcast",
    "skip_ring_bcast",
    "ring_reduce_scatter",
    "ring_all_gather",
    "recursive_doubling",
    "halving_reduce_scatter",
    "doubling_all_gather",
)

ALG_IDS = {name: i for i, name in enumerate(ALGORITHMS)}

#: composite schedules ``ledger()`` accepts in addition to the atomic
#: ones: each expands to its phases' atomic steps in execution order.
COMPOSITES = {
    "ring_allreduce": ("ring_reduce_scatter", "ring_all_gather"),
    "halving_doubling": ("halving_reduce_scatter",
                         "doubling_all_gather"),
}

SCHEDULES = ALGORITHMS + tuple(COMPOSITES)


@dataclass(frozen=True)
class Edge:
    """One directed transfer within a step.

    ``chunk`` is the first global chunk index the payload covers (-1
    for full-vector sends); ``mask`` is the cumulative contribution
    bitmask of the payload AFTER the merge at ``dst`` (for broadcast,
    ``1 << token``) — the "cumulative-reduced-chunks" signal the
    attribution analyzer surfaces."""
    src: int
    dst: int
    nbytes: int
    chunk: int
    mask: int


@dataclass(frozen=True)
class Step:
    """One dependent communication round of an atomic schedule."""
    algorithm: str
    index: int
    edges: Tuple[Edge, ...]

    @property
    def nbytes(self) -> int:
        """Total bytes on the wire this step (all edges)."""
        return sum(e.nbytes for e in self.edges)

    @property
    def edge_nbytes(self) -> int:
        """Bytes of the heaviest single edge — the step's serialized
        cost on a full-duplex fabric where edges run concurrently."""
        return max((e.nbytes for e in self.edges), default=0)


@dataclass(frozen=True)
class Ledger:
    """The complete per-step account of one committed schedule.

    ``final`` is the token-algebra end state, shaped exactly like the
    matching rlo-prover P2 simulator's return value so tests can
    assert equality verbatim:

      binomial/skip_ring bcast   -> per-rank token tuple
      ring_reduce_scatter        -> per-rank (owned_chunk, mask)
      ring_all_gather            -> per-rank token grid
      ring_allreduce             -> per-rank per-chunk mask grid
      recursive_doubling         -> per-rank mask tuple
      halving_doubling           -> per-rank per-chunk mask grid
    """
    algorithm: str
    n: int
    nbytes: int
    itemsize: int
    origin: int
    steps: Tuple[Step, ...]
    final: Tuple

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def total_bytes(self) -> int:
        """Fleet-wide bytes on the wire across the whole schedule."""
        return sum(s.nbytes for s in self.steps)

    def sent_bytes_by_rank(self) -> List[int]:
        """Bytes each rank sends across the schedule (broadcast
        schedules are the only non-uniform ones)."""
        out = [0] * self.n
        for s in self.steps:
            for e in s.edges:
                out[e.src] += e.nbytes
        return out

    @property
    def bytes_per_rank(self) -> int:
        """Serialized bytes through the busiest rank — the figure the
        analytic cost models (``allreduce_cost``) call total_bytes and
        bench.py calls bus bytes."""
        return max(self.sent_bytes_by_rank(), default=0)

    def step_table(self) -> List[Tuple[str, int, int, int]]:
        """(algorithm, step index, step bytes, heaviest edge bytes)
        per step — the rlo-scope join key + predicted-byte columns."""
        return [(s.algorithm, s.index, s.nbytes, s.edge_nbytes)
                for s in self.steps]

    def digest(self) -> str:
        """SHA-256 over the canonical step/edge listing.  Pure
        function of (algorithm, n, nbytes, itemsize, origin): the
        schedule-digest pin instrumented runs must leave unperturbed."""
        h = hashlib.sha256()
        h.update(f"{self.algorithm}/{self.n}/{self.nbytes}/"
                 f"{self.itemsize}/{self.origin}\n".encode())
        for s in self.steps:
            h.update(f"{s.algorithm}:{s.index}\n".encode())
            for e in s.edges:
                h.update(f"{e.src}>{e.dst}:{e.nbytes}:{e.chunk}:"
                         f"{e.mask:x}\n".encode())
        return h.hexdigest()


def chunk_nbytes(n: int, nbytes: int, itemsize: int) -> int:
    """Per-chunk bytes after element-granular padding to n chunks —
    the implementations' exact padding rule (``_chunk_shard`` /
    ``Comm._chunk`` / ``allreduce_cost``)."""
    if nbytes % itemsize:
        raise LedgerError(f"nbytes {nbytes} not a multiple of "
                          f"itemsize {itemsize}")
    nelems = nbytes // itemsize
    return -(-nelems // n) * itemsize


# ---------------------------------------------------------------------------
# Schedule replays — each mirrors its rlo-prover P2 simulator line for
# line, additionally recording edges, and RAISES where the prover
# would record a defect.
# ---------------------------------------------------------------------------

def _bcast_steps(kind: str, n: int, origin: int, nbytes: int,
                 topo) -> Tuple[List[Step], Tuple]:
    gen = (topo.binomial_bcast_schedule if kind == "binomial_bcast"
           else topo.skip_ring_bcast_schedule)
    sched = gen(n, origin)
    # simulate_bcast semantics: rank r starts holding token r; every
    # dst of a round unconditionally takes what its src held BEFORE
    # the round; delivered iff the end state is [origin] * n
    tok = list(range(n))
    steps: List[Step] = []
    for i, rnd in enumerate(sched.rounds):
        old = list(tok)
        edges = []
        for src, dst in rnd:
            edges.append(Edge(src, dst, nbytes, -1, 1 << old[src]))
            tok[dst] = old[src]
        steps.append(Step(kind, i, tuple(sorted(
            edges, key=lambda e: (e.src, e.dst)))))
    if tok != [origin] * n:
        bad = [r for r in range(n) if tok[r] != origin]
        raise LedgerError(
            f"{kind} at n={n} origin={origin}: ranks {bad[:6]} end "
            f"holding {[tok[r] for r in bad[:6]]}, not the origin's "
            f"token — broadcast does not deliver")
    return steps, tuple(tok)


def _ring_recv_from(n: int, topo) -> dict:
    recv_from = {d: s for s, d in topo.ring_perm(n, 1)}
    if sorted(recv_from) != list(range(n)):
        raise LedgerError(
            f"ring_perm(n={n}) is not a complete permutation "
            f"(receivers {sorted(recv_from)})")
    return recv_from


def _ring_rs_steps(n: int, cb: int, topo) -> Tuple[
        List[Step], List[List[int]]]:
    """Mask-algebra ring reduce-scatter (simulate_ring_allreduce's
    first phase).  Returns (steps, post-RS state grid)."""
    full = (1 << n) - 1
    recv_from = _ring_recv_from(n, topo)
    state = [[1 << r for _ in range(n)] for r in range(n)]
    steps: List[Step] = []
    for s in range(n - 1):
        old = [row[:] for row in state]
        edges = []
        for r in range(n):
            src = recv_from[r]
            send_idx = topo.ring_reduce_scatter_chunk(n, src, s)
            recv_idx = (r - s - 1) % n
            if send_idx != recv_idx:
                raise LedgerError(
                    f"ring RS step {s}: rank {src} sends chunk "
                    f"{send_idx} but rank {r} accumulates into chunk "
                    f"{recv_idx} — chunk misalignment")
            if old[src][send_idx] & old[r][recv_idx]:
                raise LedgerError(
                    f"ring RS step {s}: merging chunk {recv_idx} at "
                    f"rank {r} double-counts contributions "
                    f"{old[src][send_idx] & old[r][recv_idx]:#x}")
            state[r][recv_idx] = old[r][recv_idx] | old[src][send_idx]
            edges.append(Edge(src, r, cb, send_idx,
                              state[r][recv_idx]))
        steps.append(Step("ring_reduce_scatter", s, tuple(sorted(
            edges, key=lambda e: (e.src, e.dst)))))
    for r in range(n):
        own = (r + 1) % n
        if state[r][own] != full:
            raise LedgerError(
                f"ring RS: rank {r} owns chunk {own} with "
                f"contributions {state[r][own]:#x}, expected all "
                f"{n} ranks — dropped contribution")
    return steps, state


def _ring_ag_steps(n: int, cb: int, carry: List[Tuple[int, int]],
                   offset: int, topo) -> Tuple[
                       List[Step], List[List[int]]]:
    """Ring all-gather from per-rank (chunk, mask) carries.  ``offset``
    pins the expected filing index: 1 for the allreduce continuation
    (carry starts at chunk (r+1), arrivals file under (r - s) mod n),
    0 for the standalone gather (carry starts at chunk r, arrivals
    file under (r - s - 1) mod n) — exactly the two P2 simulators."""
    recv_from = _ring_recv_from(n, topo)
    out: List[List[Optional[int]]] = [[None] * n for _ in range(n)]
    carry = list(carry)
    for r in range(n):
        out[r][carry[r][0]] = carry[r][1]
    steps: List[Step] = []
    for s in range(n - 1):
        old_c = list(carry)
        edges = []
        for r in range(n):
            src = recv_from[r]
            idx, mask = old_c[src]
            arr_idx = (r - s - 1 + offset) % n
            if idx != arr_idx:
                raise LedgerError(
                    f"ring AG step {s}: rank {r} files arriving chunk "
                    f"{idx} under index {arr_idx}")
            out[r][idx] = mask
            carry[r] = (idx, mask)
            edges.append(Edge(src, r, cb, idx, mask))
        steps.append(Step("ring_all_gather", s, tuple(sorted(
            edges, key=lambda e: (e.src, e.dst)))))
    for r in range(n):
        if any(m is None for m in out[r]):
            missing = [c for c in range(n) if out[r][c] is None]
            raise LedgerError(
                f"ring AG: rank {r} never fills slots {missing[:6]}")
    return steps, [[m for m in row] for row in out]


def _rd_steps(n: int, nbytes: int, topo) -> Tuple[List[Step], Tuple]:
    """Recursive doubling (simulate_rd_allreduce): full-vector
    exchanges, one per round, contribution masks merged pairwise."""
    full = (1 << n) - 1
    acc = [1 << r for r in range(n)]
    rounds = topo.recursive_doubling_rounds(n)
    if len(rounds) != n.bit_length() - 1:
        raise LedgerError(
            f"recursive doubling at n={n}: {len(rounds)} rounds, "
            f"documented bound is log2(n) = {n.bit_length() - 1}")
    steps: List[Step] = []
    for i, rnd in enumerate(rounds):
        m = dict(rnd)
        old = list(acc)
        edges = []
        for r in range(n):
            if r not in m:
                raise LedgerError(
                    f"recursive doubling round {i}: rank {r} has no "
                    f"partner — its contribution is dropped")
            p = m[r]
            if old[r] & old[p]:
                raise LedgerError(
                    f"recursive doubling round {i}: ranks {r}<->{p} "
                    f"merge overlapping contribution sets — "
                    f"double-count")
            acc[r] = old[r] | old[p]
            edges.append(Edge(p, r, nbytes, -1, acc[r]))
        steps.append(Step("recursive_doubling", i, tuple(sorted(
            edges, key=lambda e: (e.src, e.dst)))))
    if any(a != full for a in acc):
        raise LedgerError(
            f"recursive doubling at n={n}: final contribution sets "
            f"{[hex(a) for a in acc[:4]]}... incomplete")
    return steps, tuple(acc)


def _halving_rs_steps(n: int, cb: int, topo) -> Tuple[
        List[Step], List[Tuple[int, int]]]:
    """Recursive-halving reduce-scatter
    (simulate_halving_reduce_scatter): shrinking (chunk, mask) runs."""
    full = (1 << n) - 1
    rows = {r: [(c, 1 << r) for c in range(n)] for r in range(n)}
    dists = list(topo.halving_doubling_distances(n))
    if dists != [n >> k for k in range(1, n.bit_length())]:
        raise LedgerError(
            f"halving_doubling_distances(n={n}) = {dists}, expected "
            f"{[n >> k for k in range(1, n.bit_length())]}")
    steps: List[Step] = []
    for si, dist in enumerate(dists):
        new = {}
        edges = []
        for r in range(n):
            p = r ^ dist
            cur, pcur = rows[r], rows[p]
            if len(cur) != 2 * dist:
                raise LedgerError(
                    f"halving RS dist {dist}: rank {r} holds "
                    f"{len(cur)} rows, expected {2 * dist}")
            upper = (r & dist) != 0
            keep = cur[dist:] if upper else cur[:dist]
            # partner sends the half of ITS range that my subtree owns
            psend = pcur[dist:] if upper else pcur[:dist]
            merged = []
            for (c1, m1), (c2, m2) in zip(keep, psend):
                if c1 != c2:
                    raise LedgerError(
                        f"halving RS dist {dist}: rank {r} combines "
                        f"chunk {c1} with partner chunk {c2} — "
                        f"misaligned exchange")
                if m1 & m2:
                    raise LedgerError(
                        f"halving RS dist {dist}: rank {r} chunk {c1} "
                        f"double-counts {m1 & m2:#x}")
                merged.append((c1, m1 | m2))
            new[r] = merged
            # merges within one rank's round share one mask (uniform
            # start, pairwise uniform merges keep it uniform)
            edges.append(Edge(p, r, dist * cb, psend[0][0],
                              merged[0][1]))
        rows = new
        steps.append(Step("halving_reduce_scatter", si, tuple(sorted(
            edges, key=lambda e: (e.src, e.dst)))))
    owned: List[Tuple[int, int]] = []
    for r in range(n):
        if len(rows[r]) != 1:
            raise LedgerError(f"halving RS: rank {r} ends with "
                              f"{len(rows[r])} chunks, expected 1")
        c, m = rows[r][0]
        if c != r or m != full:
            raise LedgerError(
                f"halving RS: rank {r} ends owning chunk {c} with "
                f"mask {m:#x}, expected chunk {r} with every "
                f"contribution")
        owned.append((c, m))
    return steps, owned


def _doubling_ag_steps(n: int, cb: int,
                       start: List[Tuple[int, int]], topo) -> Tuple[
                           List[Step], List[List[int]]]:
    """Recursive-doubling all-gather (simulate_doubling_all_gather)
    from per-rank (chunk, mask)."""
    out: List[List[Optional[Tuple[int, int]]]] = \
        [[None] * n for _ in range(n)]
    for r, (c, m) in enumerate(start):
        if 0 <= c < n:
            out[r][c] = (c, m)
    steps: List[Step] = []
    dists = list(reversed(list(topo.halving_doubling_distances(n))))
    for si, dist in enumerate(dists):
        snapshot = [list(row) for row in out]
        edges = []
        for r in range(n):
            p = r ^ dist
            # partner's assembled block of `dist` rows lands at my
            # block start XOR dist (== the partner's block start)
            p_start = (p // dist) * dist
            blk = snapshot[p][p_start:p_start + dist]
            dst = (r // dist) * dist ^ dist
            for i, cell in enumerate(blk):
                if cell is None:
                    raise LedgerError(
                        f"doubling AG dist {dist}: rank {r} receives "
                        f"an unassembled slot from rank {p}")
                out[r][dst + i] = cell
            edges.append(Edge(p, r, dist * cb, p_start, blk[0][1]))
        steps.append(Step("doubling_all_gather", si, tuple(sorted(
            edges, key=lambda e: (e.src, e.dst)))))
    final: List[List[int]] = []
    for r in range(n):
        row = []
        for c in range(n):
            cell = out[r][c]
            if cell is None:
                raise LedgerError(
                    f"doubling AG: rank {r} slot {c} never filled")
            if cell[0] != c:
                raise LedgerError(
                    f"doubling AG: rank {r} slot {c} holds chunk "
                    f"{cell[0]} — out of index order")
            row.append(cell[1])
        final.append(row)
    return steps, final


# ---------------------------------------------------------------------------
# Public constructor
# ---------------------------------------------------------------------------

def ledger(algorithm: str, n: int, nbytes: int, *,
           itemsize: int = 4, origin: int = 0,
           topo=None) -> Ledger:
    """Build the :class:`Ledger` for one committed schedule.

    ``algorithm`` is an atomic name from :data:`ALGORITHMS` or a
    composite from :data:`COMPOSITES`.  ``origin`` applies to the
    broadcast schedules only.  ``topo`` substitutes the schedule-
    generator module (default ``rlo_tpu_torch.topology``) — the mutation
    fixtures' hook: a perturbed generator raises :class:`LedgerError`
    here instead of producing silently wrong byte predictions."""
    if topo is None:
        topo = topology
    if algorithm not in SCHEDULES:
        raise LedgerError(f"unknown schedule {algorithm!r}; known: "
                          f"{', '.join(SCHEDULES)}")
    if n < 1:
        raise LedgerError(f"n must be >= 1, got {n}")
    if nbytes < 0:
        raise LedgerError(f"nbytes must be >= 0, got {nbytes}")
    if algorithm in ("binomial_bcast", "skip_ring_bcast"):
        if not 0 <= origin < n:
            raise LedgerError(f"origin {origin} out of range [0, {n})")
        steps, final = _bcast_steps(algorithm, n, origin, nbytes, topo)
        return Ledger(algorithm, n, nbytes, itemsize, origin,
                      tuple(steps), final)
    origin = -1
    if n == 1:
        return Ledger(algorithm, n, nbytes, itemsize, origin, (), ())
    cb = chunk_nbytes(n, nbytes, itemsize)
    if algorithm == "ring_reduce_scatter":
        steps, state = _ring_rs_steps(n, cb, topo)
        final = tuple((
            (r + 1) % n, state[r][(r + 1) % n]) for r in range(n))
        return Ledger(algorithm, n, nbytes, itemsize, origin,
                      tuple(steps), final)
    if algorithm == "ring_all_gather":
        # standalone gather: rank r contributes chunk r (token 1<<r)
        steps, grid = _ring_ag_steps(
            n, cb, [(r, 1 << r) for r in range(n)], 0, topo)
        # token-grid form, comparable to simulate_ring_all_gather
        final = tuple(tuple(row[c].bit_length() - 1
                            for c in range(n)) for row in grid)
        return Ledger(algorithm, n, nbytes, itemsize, origin,
                      tuple(steps), final)
    if algorithm == "ring_allreduce":
        rs_steps, state = _ring_rs_steps(n, cb, topo)
        carry = [((r + 1) % n, state[r][(r + 1) % n])
                 for r in range(n)]
        ag_steps, grid = _ring_ag_steps(n, cb, carry, 1, topo)
        final = tuple(tuple(row) for row in grid)
        return Ledger(algorithm, n, nbytes, itemsize, origin,
                      tuple(rs_steps + ag_steps), final)
    if algorithm == "recursive_doubling":
        steps, final = _rd_steps(n, nbytes, topo)
        return Ledger(algorithm, n, nbytes, itemsize, origin,
                      tuple(steps), final)
    if algorithm == "halving_reduce_scatter":
        steps, owned = _halving_rs_steps(n, cb, topo)
        return Ledger(algorithm, n, nbytes, itemsize, origin,
                      tuple(steps), tuple(owned))
    if algorithm == "doubling_all_gather":
        # canonical start: rank r holds fully-reduced chunk r
        full = (1 << n) - 1
        steps, final = _doubling_ag_steps(
            n, cb, [(r, full) for r in range(n)], topo)
        return Ledger(algorithm, n, nbytes, itemsize, origin,
                      tuple(steps), tuple(tuple(r) for r in final))
    # halving_doubling composite
    rs_steps, owned = _halving_rs_steps(n, cb, topo)
    ag_steps, final = _doubling_ag_steps(n, cb, owned, topo)
    return Ledger(algorithm, n, nbytes, itemsize, origin,
                  tuple(rs_steps + ag_steps),
                  tuple(tuple(r) for r in final))
