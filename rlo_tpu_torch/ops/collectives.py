"""Data-carrying collectives over the byte transport layer.

The port's copy of ``rlo_tpu/ops/collectives.py``: the host data plane
of the loopback facade (numpy in, numpy out; its frames byte-identical to
the JAX package's). The reference moves only opaque <=32 KB blobs (bcast)
and single-bit votes (IAR); the rebuild extends the op set to tensor
allreduce / reduce-scatter / all-gather / barrier over the same
substrate (BASELINE.json config 1: float32 allreduce, 8 ranks, 1 MB
buffer — here over the loopback transport; the device lowering lives in
rlo_tpu_torch.ops.device_collectives).

Algorithms (classic, schedule math shared with rlo_tpu_torch.topology):
  - allreduce: recursive doubling for power-of-2 worlds; non-power-of-2
    folds the surplus ranks onto the largest power-of-2 subset first and
    unfolds at the end. O(log n) rounds, full vector per round — right for
    small/medium payloads.
  - allreduce(algorithm='ring'): ring reduce-scatter + ring all-gather,
    2*(n-1) rounds of 1/n-sized chunks — bandwidth-optimal for large
    payloads.
  - reduce_scatter / all_gather: the ring halves exposed directly.
  - barrier: dissemination barrier, ceil(log2(n)) rounds, any world size.

Execution model: collectives are **coroutines** (generators). Each rank
builds its op via its `Comm`; a driver advances all ranks' coroutines
round-robin in one process (`run_collectives`), or each rank can spin its
own coroutine on a thread (`run_blocking`) — both drive the same state
machine, mirroring how the reference's progress engine is cooperatively
polled rather than threaded (rootless_ops.c:538-549).

Message matching: SPMD programs issue collectives in identical order on
every rank, so a per-Comm monotonically increasing op id (carried in the
frame `pid` field) plus the round number (in `vote`) uniquely identifies
every transfer; out-of-order arrivals are parked until their (src, op,
round) is awaited.
"""

from __future__ import annotations

import itertools
import struct
from typing import Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np

from rlo_tpu_torch.observe.ledger import ALG_IDS
from rlo_tpu_torch.topology import ring_reduce_scatter_chunk
from rlo_tpu_torch.transport.base import Transport
from rlo_tpu_torch.utils.tracing import TRACER, Ev
from rlo_tpu_torch.wire import Frame, Tag

#: hoisted schedule ids for the probe call sites (observe.ledger
#: ALGORITHMS order — the `a` field of every Ev.STEP event)
_ALG_RING_RS = ALG_IDS["ring_reduce_scatter"]
_ALG_RING_AG = ALG_IDS["ring_all_gather"]
_ALG_RD = ALG_IDS["recursive_doubling"]

OPS = {
    "sum": np.add,
    "prod": np.multiply,
    "min": np.minimum,
    "max": np.maximum,
    "and": np.bitwise_and,  # the IAR vote merge, generalized to tensors
    "or": np.bitwise_or,
}

#: Identity element per op — used to pad ragged chunks so padding never
#: perturbs the reduction (zeros would corrupt min/prod).
_IDENTITY = {"sum": 0, "prod": 1, "min": "maxval", "max": "minval",
             "and": 1, "or": 0}


def _identity_for(op: str, dtype: np.dtype):
    ident = _IDENTITY[op]
    if ident == "maxval":
        return np.inf if np.issubdtype(dtype, np.floating) else \
            np.iinfo(dtype).max
    if ident == "minval":
        return -np.inf if np.issubdtype(dtype, np.floating) else \
            np.iinfo(dtype).min
    return ident

_ARR_HEADER = struct.Struct("<B")  # ndim; then dtype-str, dims


def _pack_array(x: np.ndarray) -> bytes:
    dt = np.dtype(x.dtype).str.encode()
    dims = struct.pack(f"<{x.ndim}q", *x.shape)
    return (_ARR_HEADER.pack(x.ndim) + struct.pack("<B", len(dt)) + dt
            + dims + np.ascontiguousarray(x).tobytes())


def _unpack_array(raw: bytes) -> np.ndarray:
    ndim = _ARR_HEADER.unpack_from(raw, 0)[0]
    dtlen = struct.unpack_from("<B", raw, 1)[0]
    off = 2
    dt = np.dtype(raw[off:off + dtlen].decode())
    off += dtlen
    shape = struct.unpack_from(f"<{ndim}q", raw, off)
    off += 8 * ndim
    return np.frombuffer(raw, dtype=dt, offset=off).reshape(shape).copy()


class StepProbe:
    """Per-op step timer behind ``Comm.instrument`` (docs/DESIGN.md
    §21). ``begin()`` arms the clock at op start; ``note()`` emits one
    Ev.STEP at each schedule-step END with ``b`` = completion-to-
    completion delta at this rank — so the sum of a rank's step
    durations is the op's span on that rank's clock. The clock is
    injectable (SimWorld.clock under the simulator, time.monotonic on
    threads) and stamps ``ts_usec`` explicitly, keeping traced sim
    runs bit-for-bit deterministic (R5). Payload bytes are NOT in the
    event — rlo-scope joins them from the cost ledger."""

    __slots__ = ("clock", "tracer", "rank", "_prev")

    def __init__(self, clock, tracer, rank: int):
        self.clock = clock
        self.tracer = tracer
        self.rank = rank
        self._prev = 0.0

    def begin(self) -> None:
        self._prev = self.clock()

    def note(self, alg: int, opid: int, step: int,
             recv_from: int) -> None:
        now = self.clock()
        dur = int((now - self._prev) * 1e6)
        self._prev = now
        if dur > 0x7FFFFFFF:
            dur = 0x7FFFFFFF
        self.tracer.emit(self.rank, Ev.STEP, a=alg, b=dur,
                         c=opid * 1024 + step, d=recv_from,
                         ts_usec=int(now * 1e6))


class Comm:
    """One rank's collective communicator over a transport endpoint.

    ``members`` scopes the collectives to a RANK SUBSET (the Python
    mirror of rlo_coll_new_sub): every op's ring/rotation math and
    slot layout runs on virtual positions 0..len(members)-1; the
    _send/_recv boundary translates positions to real transport
    endpoints. ``self.rank``/``self.world_size`` are therefore the
    VIRTUAL position and group size inside the op code."""

    def __init__(self, transport: Transport,
                 members: Optional[Sequence[int]] = None):
        self.tp = transport
        self.real_rank = transport.rank
        if members is None:
            self.group = list(range(transport.world_size))
            self.rank = transport.rank
        else:
            self.group = sorted(set(int(r) for r in members))
            if len(self.group) < 2:
                raise ValueError(
                    f"a sub-communicator needs >= 2 members, got "
                    f"{self.group}")
            if any(r < 0 or r >= transport.world_size
                   for r in self.group):
                raise ValueError(f"members {self.group} out of range "
                                 f"[0, {transport.world_size})")
            if transport.rank not in self.group:
                raise ValueError(f"rank {transport.rank} is not in "
                                 f"members {self.group}")
            self.rank = self.group.index(transport.rank)
        self.world_size = len(self.group)
        self._opid = itertools.count()
        # parked out-of-order arrivals: (src, opid, round) -> payload
        self._pending: Dict[Tuple[int, int, int], bytes] = {}
        # data-plane load counters (always-live plain ints — the PR-2
        # counter contract): cumulative sends and tensor payload bytes,
        # surfaced to the telemetry digest as coll_steps/coll_bytes
        self.coll_steps = 0
        self.coll_bytes = 0
        # per-step timing probe; None = disabled (one hoisted branch
        # per schedule step — docs/DESIGN.md §21 overhead contract)
        self._probe: Optional[StepProbe] = None

    def instrument(self, clock, tracer=None) -> StepProbe:
        """Attach a per-step timing probe emitting Ev.STEP into
        ``tracer`` (default: the process tracer) with timestamps from
        the injectable ``clock`` (seconds — SimWorld.clock or
        time.monotonic). Returns the probe; ``comm._probe = None``
        detaches."""
        self._probe = StepProbe(clock, TRACER if tracer is None
                                else tracer, self.real_rank)
        return self._probe

    def telemetry_extra(self) -> Dict[str, int]:
        """Data-plane keys for a TelemetryPlane ``extra`` callable."""
        return {"coll_steps": self.coll_steps,
                "coll_bytes": self.coll_bytes}

    # -- plumbing ----------------------------------------------------------
    def _send(self, dst: int, opid: int, rnd: int, x: np.ndarray) -> None:
        self.coll_steps += 1
        self.coll_bytes += x.nbytes
        frame = Frame(origin=self.real_rank, pid=opid, vote=rnd,
                      payload=_pack_array(x))
        self.tp.isend(self.group[dst], int(Tag.DATA), frame.encode())

    def _recv(self, src: int, opid: int, rnd: int):
        """Coroutine: yield until the (src, opid, round) message arrives.
        ``src`` is a virtual position; arrivals are keyed by the real
        sender rank the transport reports."""
        key = (self.group[src], opid, rnd)
        while key not in self._pending:
            m = self.tp.poll()
            if m is None:
                yield
                continue
            s, tag, raw = m
            if tag != Tag.DATA:
                raise RuntimeError(
                    f"rank {self.rank}: unexpected tag {tag} on a "
                    f"collective-only Comm")
            f = Frame.decode(raw)
            self._pending[(s, f.pid, f.vote)] = f.payload
        return _unpack_array(self._pending.pop(key))

    def _exchange(self, peer: int, opid: int, rnd: int, x: np.ndarray):
        self._send(peer, opid, rnd, x)
        other = yield from self._recv(peer, opid, rnd)
        return other

    # -- ops ---------------------------------------------------------------
    def allreduce(self, x: np.ndarray, op: str = "sum",
                  algorithm: str = "auto"):
        """Coroutine computing the elementwise reduction of ``x`` across all
        ranks; every rank returns the full result."""
        x = np.asarray(x)
        if algorithm == "auto":
            algorithm = "ring" if x.nbytes >= (1 << 20) else \
                "recursive_doubling"
        if algorithm == "recursive_doubling":
            return (yield from self._allreduce_rd(x, op))
        if algorithm == "ring":
            return (yield from self._allreduce_ring(x, op))
        raise ValueError(f"unknown algorithm {algorithm!r}")

    def _allreduce_rd(self, x: np.ndarray, op: str):
        """Recursive doubling with non-power-of-2 fold/unfold."""
        fn = OPS[op]
        opid = next(self._opid)
        ws, rank = self.world_size, self.rank
        p = 1 << (ws.bit_length() - 1)  # largest power of 2 <= ws
        if p == ws:
            p_rank, in_core = rank, True
        else:
            surplus = ws - p
            # ranks [p, ws) fold onto [0, surplus)
            if rank >= p:
                self._send(rank - p, opid, 0, x)
                in_core = False
            else:
                if rank < surplus:
                    other = yield from self._recv(rank + p, opid, 0)
                    x = fn(x, other)
                in_core = True
            p_rank = rank
        acc = x
        if in_core:
            probe = self._probe
            if probe is not None:
                probe.begin()
            i = 0
            while (1 << i) < p:
                peer = p_rank ^ (1 << i)
                other = yield from self._exchange(peer, opid, i + 1, acc)
                acc = fn(acc, other)
                if probe is not None:
                    probe.note(_ALG_RD, opid, i, self.group[peer])
                i += 1
        # unfold
        if p != ws:
            if in_core and rank < ws - p:
                self._send(rank + p, opid, 99, acc)
            if not in_core:
                acc = yield from self._recv(rank - p, opid, 99)
        return acc

    def _allreduce_ring(self, x: np.ndarray, op: str):
        """Ring reduce-scatter then ring all-gather (bandwidth-optimal)."""
        chunks, meta = _chunk(x, self.world_size, op)
        reduced = yield from self._ring_reduce_scatter(chunks, op)
        gathered = yield from self._ring_all_gather_chunks(reduced)
        return _unchunk(gathered, meta)

    def _ring_reduce_scatter(self, chunks: List[np.ndarray], op: str):
        """After n-1 steps, returns (my_chunk_index, reduced_chunk)."""
        fn = OPS[op]
        opid = next(self._opid)
        ws, rank = self.world_size, self.rank
        nxt, prv = (rank + 1) % ws, (rank - 1) % ws
        chunks = [c.copy() for c in chunks]
        probe = self._probe
        if probe is not None:
            probe.begin()
        for s in range(ws - 1):
            send_idx = ring_reduce_scatter_chunk(ws, rank, s)
            recv_idx = ring_reduce_scatter_chunk(ws, rank, s + 1)
            self._send(nxt, opid, s, chunks[send_idx])
            other = yield from self._recv(prv, opid, s)
            chunks[recv_idx] = fn(chunks[recv_idx], other)
            if probe is not None:
                probe.note(_ALG_RING_RS, opid, s, self.group[prv])
        own = (rank + 1) % ws
        return own, chunks[own]

    def _ring_all_gather_chunks(self, own: Tuple[int, np.ndarray]):
        """Ring all-gather of per-rank chunks -> full ordered chunk list."""
        opid = next(self._opid)
        ws, rank = self.world_size, self.rank
        nxt, prv = (rank + 1) % ws, (rank - 1) % ws
        idx, chunk = own
        out: List[Optional[np.ndarray]] = [None] * ws
        out[idx] = chunk
        cur = chunk
        probe = self._probe
        if probe is not None:
            probe.begin()
        for s in range(ws - 1):
            self._send(nxt, opid, s, cur)
            cur = yield from self._recv(prv, opid, s)
            out[(idx - s - 1) % ws] = cur
            if probe is not None:
                probe.note(_ALG_RING_AG, opid, s, self.group[prv])
        return out

    def reduce_scatter(self, x: np.ndarray, op: str = "sum"):
        """Coroutine: rank r returns the r-th equal chunk of the reduction
        (flattened + zero-padded to a multiple of world_size)."""
        chunks, _ = _chunk(np.asarray(x), self.world_size, op)
        idx, reduced = yield from self._ring_reduce_scatter(chunks, op)
        # after the ring RS, rank holds chunk (rank+1): rotate one hop
        # forward so every rank returns ITS chunk index
        if idx != self.rank:
            opid = next(self._opid)
            self._send(idx % self.world_size, opid, 0, reduced)
            reduced = yield from self._recv(
                (self.rank - 1) % self.world_size, opid, 0)
        return reduced

    def all_gather(self, x: np.ndarray):
        """Coroutine: concatenation of every rank's ``x`` along axis 0."""
        x = np.asarray(x)
        gathered = yield from self._ring_all_gather_chunks((self.rank, x))
        return np.concatenate([np.atleast_1d(g) for g in gathered], axis=0)

    def all_to_all(self, xs: "Sequence[np.ndarray]"):
        """Coroutine: personalized exchange — ``xs[d]`` goes to rank
        ``d``; returns the list received, indexed by source (the
        engine-substrate counterpart of tpu_collectives.all_to_all, the
        expert-dispatch collective)."""
        if len(xs) != self.world_size:
            raise ValueError(
                f"need one chunk per rank ({self.world_size}), got "
                f"{len(xs)}")
        opid = next(self._opid)
        ws, rank = self.world_size, self.rank
        out: List[Optional[np.ndarray]] = [None] * ws
        out[rank] = np.asarray(xs[rank])
        for d in range(1, ws):  # round d: send d ahead, receive d behind
            dst = (rank + d) % ws
            src = (rank - d) % ws
            self._send(dst, opid, d, np.asarray(xs[dst]))
            out[src] = yield from self._recv(src, opid, d)
        return out

    def barrier(self):
        """Coroutine: dissemination barrier — ceil(log2(n)) rounds, works
        for any world size."""
        opid = next(self._opid)
        ws, rank = self.world_size, self.rank
        token = np.zeros((), np.int8)
        k = 0
        while (1 << k) < ws:
            step = 1 << k
            self._send((rank + step) % ws, opid, k, token)
            yield from self._recv((rank - step) % ws, opid, k)
            k += 1
        return True


def _chunk(x: np.ndarray, n: int, op: str = "sum"):
    """Flatten + identity-pad to n equal chunks; meta for reassembly."""
    flat = np.ascontiguousarray(x).reshape(-1)
    pad = (-len(flat)) % n
    if pad:
        fill = np.full(pad, _identity_for(op, flat.dtype), dtype=flat.dtype)
        flat = np.concatenate([flat, fill])
    return list(flat.reshape(n, -1)), (x.shape, x.dtype, len(flat) - pad)


def _unchunk(chunks: Sequence[np.ndarray], meta) -> np.ndarray:
    shape, dtype, size = meta
    flat = np.concatenate(chunks)[:size]
    return flat.reshape(shape).astype(dtype, copy=False)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def run_collectives(coros: Sequence[Generator], max_spins: int = 1_000_000):
    """Advance all ranks' coroutines round-robin until every one returns;
    returns their results in rank order (single-process SPMD driver)."""
    results = [None] * len(coros)
    alive = set(range(len(coros)))
    for _ in range(max_spins):
        for i in list(alive):
            try:
                next(coros[i])
            except StopIteration as e:
                results[i] = e.value
                alive.discard(i)
        if not alive:
            return results
    raise RuntimeError("collective did not complete (deadlock?)")


def run_blocking(coro: Generator):
    """Spin one rank's coroutine to completion (per-rank thread driver)."""
    while True:
        try:
            next(coro)
        except StopIteration as e:
            return e.value
