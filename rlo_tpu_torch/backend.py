"""The collective facades of the port, behind ``init``'s switch.

The port's counterpart of ``rlo_tpu/backend.py``: one single-controller
op surface over every transport,

    bcast(origin, x)          rootless broadcast
    consensus(votes)          leaderless IAR decision
    allreduce(xs, op=..., algorithm=...)
    reduce_scatter(xs, op=...)
    all_gather(xs)
    all_to_all(xss)
    barrier()

chosen by name (``init``'s argument, then ``$ROOTLESS_BACKEND``, then
``cuda``). Per-rank data is a list with one entry per rank, numpy arrays
or torch tensors; results come back as the same kind. Facades:

  cuda      ``TorchBackend``: ``world_size`` ranks, the threads of a
            ``LocalMesh`` on one device, running the per-rank functions
            of ``ops/device_collectives.py`` (K1 in the ring, halving and
            doubling schedules); the port's ``TpuBackend``
  hybrid    ``bridge.HybridBackend``: the port's engines decide, the
            card's ``TorchBackend`` executes
  loopback  the port's Python engines + the coroutine collectives of
            ``ops/collectives.py`` over the in-process loopback transport
  native    the port's copy of the C core (``native/``) through ctypes:
            the C ring collectives and bcast-gather over the rootless
            broadcast overlay
  shm       C-only multi-process transport: a pointer to the demo binary
  mpi       one process a rank under femtompirun (or a real mpirun)
  tcp       one process a rank over the C core's socket mesh (tcprun)

The host facades (loopback, native, mpi, tcp) keep the JAX package's
numpy data plane: a tensor is copied to the host once on the way in and
each result goes back to the caller's device once on the way out
(``last_staging`` keeps the split of the last op's time); a dtype numpy
cannot hold (bfloat16) raises. A facade whose library does not build or
whose world does not form raises; none hands its op to another.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from rlo_tpu_torch.convert import from_numpy, to_numpy
from rlo_tpu_torch.ops import device_collectives as dc
from rlo_tpu_torch.parallel.mesh import LocalMesh, resolve_device

_FACTORIES: Dict[str, Callable] = {}


def _register(name: str):
    def deco(cls):
        _FACTORIES[name] = cls
        return cls
    return deco


def init(backend: Optional[str] = None, world_size: Optional[int] = None,
         **kwargs):
    """Create a facade. Resolution order: argument > $ROOTLESS_BACKEND >
    ``cuda``. A host facade is only ever chosen by name: without a card
    the default raises, as every entry point of the port does.
    ``world_size=None`` takes the facade's own default."""
    name = backend or os.environ.get("ROOTLESS_BACKEND") or "cuda"
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r} (the argument or "
            f"$ROOTLESS_BACKEND); known: {sorted(_FACTORIES)}") from None
    if world_size is not None:
        kwargs["world_size"] = world_size
    return factory(**kwargs)


def _lazy(module: str, attr: str):
    """Register a backend implemented in a module that itself imports
    this one (the hybrid bridge): resolve on first use."""
    def factory(**kwargs):
        import importlib
        cls = getattr(importlib.import_module(module), attr)
        return cls(**kwargs)
    return factory


_FACTORIES["hybrid"] = _lazy("rlo_tpu_torch.bridge", "HybridBackend")


# -- tensors in, tensors out (the host facades) ----------------------------

#: the torch dtypes that have a numpy dtype (the host facades take these)
_NUMPY_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16,
                 torch.int32, torch.int64, torch.float16, torch.float32,
                 torch.float64, torch.complex64, torch.complex128)


def _to_host(v, devices: list):
    """``v`` with every tensor in it (at any list depth) copied to a
    numpy array; each tensor's device is appended to ``devices``."""
    if isinstance(v, torch.Tensor):
        if v.dtype not in _NUMPY_DTYPES:
            raise TypeError(
                f"{v.dtype} has no numpy dtype: the host facades take the "
                f"dtypes numpy holds and cast nothing (the cuda facade "
                f"takes bfloat16)")
        devices.append(v.device)
        return v.detach().cpu().numpy()
    if isinstance(v, (list, tuple)):
        return [_to_host(e, devices) for e in v]
    return v


def _to_caller(v, device: torch.device):
    """``v`` with every numpy array in it as a tensor on ``device``. A
    numpy scalar (what a ufunc gives for two 0-d arrays) goes back as a
    0-d tensor."""
    if isinstance(v, np.generic):
        v = np.asarray(v)
    if isinstance(v, np.ndarray):
        # not np.ascontiguousarray, which makes a 0-d array 1-d
        if not (v.flags.writeable and v.flags.c_contiguous):
            v = v.copy(order="C")
        return torch.from_numpy(v).to(device)
    if isinstance(v, list):
        return [_to_caller(e, device) for e in v]
    return v


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _staged(method):
    """Run a host facade's op on numpy, taking and giving back tensors:
    the tensors in the arguments go to the host once, the results come
    back once to the device the tensors came from (one device a call).
    Numpy in gives numpy out. ``self.last_staging`` keeps the op's
    seconds: ``to_host_s``, ``protocol_s``, ``to_device_s``."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        devices: list = []
        t0 = time.perf_counter()
        args = _to_host(list(args), devices)
        kwargs = {k: _to_host(v, devices) for k, v in kwargs.items()}
        if not devices:
            return method(self, *args, **kwargs)
        if len(set(devices)) != 1:
            raise ValueError(f"tensors on several devices: "
                             f"{sorted(set(map(str, devices)))}")
        t1 = time.perf_counter()
        out = method(self, *args, **kwargs)
        t2 = time.perf_counter()
        out = _to_caller(out, devices[0])
        _sync(devices[0])
        self.last_staging = {"to_host_s": t1 - t0, "protocol_s": t2 - t1,
                             "to_device_s": time.perf_counter() - t2}
        return out
    return run


class Backend:
    """Uniform single-controller op surface; see module docstring."""

    name: str
    world_size: int
    #: the last staged op's seconds (see ``_staged``); None before one
    last_staging: Optional[dict] = None

    def bcast(self, origin: int, x) -> list:
        raise NotImplementedError

    def consensus(self, votes: Sequence[int], proposer: int = 0) -> int:
        """One leaderless IAR round over THIS facade's engines (the
        reference runs full consensus on any communicator,
        rootless_ops.c:467, 1461 — including a sub_group's): ``votes``
        is each member's judgement (by position), ``proposer`` the
        initiating position (rootless: any member may initiate).
        Returns the AND-merged decision."""
        raise NotImplementedError

    def allreduce(self, xs, op: str = "sum",
                  algorithm: str = "auto") -> list:
        """``algorithm`` selects a backend-specific schedule ('auto'
        always valid): cuda = device_collectives.allreduce's {psum,
        ring, bidir_ring, recursive_doubling, halving_doubling};
        loopback = Comm's {ring, recursive_doubling}; native/mpi/tcp =
        {ring, bcast_gather}."""
        raise NotImplementedError

    def reduce_scatter(self, xs, op: str = "sum") -> list:
        raise NotImplementedError

    def all_gather(self, xs) -> list:
        raise NotImplementedError

    def all_to_all(self, xss) -> List[list]:
        """Personalized exchange: ``xss[r][d]`` is rank r's chunk for
        rank d; returns per-rank lists indexed by source."""
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    def sub_group(self, members: Sequence[int]) -> "Backend":
        """Facade over a rank subset (a sub-communicator). Implemented
        by the loopback, native and mpi/tcp facades."""
        raise NotImplementedError(
            f"backend {self.name!r} has no sub-communicator facade")

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _check_xs(self, xs) -> List[np.ndarray]:
        xs = [np.asarray(x) for x in xs]
        if len(xs) != self.world_size:
            raise ValueError(
                f"need one array per rank ({self.world_size}), got "
                f"{len(xs)}")
        return xs

    def _check_xss(self, xss) -> List[List[np.ndarray]]:
        """Validate the FULL ws x ws all_to_all grid before any work
        starts (a mid-exchange failure could corrupt transport state)."""
        ws = self.world_size
        if len(xss) != ws or any(len(row) != ws for row in xss):
            raise ValueError(f"need a {ws}x{ws} grid of chunks")
        return [[np.asarray(c) for c in row] for row in xss]

    def _engine_bcast(self, engines, drain, origin: int,
                      x: np.ndarray) -> List[np.ndarray]:
        """Shared bcast path for single-controller engine backends:
        origin's engine broadcasts the packed tensor, the world drains,
        every other rank picks up exactly one message."""
        from rlo_tpu_torch.ops.collectives import _pack_array, _unpack_array
        x = np.asarray(x)
        engines[origin].bcast(_pack_array(x))
        drain()
        out: List[Optional[np.ndarray]] = [None] * self.world_size
        for r, e in enumerate(engines):
            if r == origin:
                out[r] = x.copy()
                continue
            msg = e.pickup_next()
            if msg is None:
                raise RuntimeError(f"rank {r} missed the broadcast")
            out[r] = _unpack_array(msg.data)
        return out


def _rank_chunk(full: np.ndarray, ws: int, rank: int) -> np.ndarray:
    """Rank's equal chunk of the flattened, zero-padded tensor — the
    facade reduce_scatter contract (matches device_collectives)."""
    flat = full.reshape(-1)
    pad = (-flat.size) % ws
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
    return flat.reshape(ws, -1)[rank]


# -- shared C-ring dispatch policy (NativeBackend + MpiBackend) -----------

#: ops the C ring reduction (rlo_coll.c) implements
_RING_OPS = ("sum", "min", "max")


def _ring_capable(xs, op: str) -> bool:
    return op in _RING_OPS and all(
        np.asarray(x).dtype == np.float32 for x in xs)


def _resolve_ring_algorithm(algorithm: str, xs, op: str) -> str:
    """'auto' -> 'ring' when the C ring can take it, else
    'bcast_gather'; explicit 'ring' validates capability."""
    if algorithm == "auto":
        return "ring" if _ring_capable(xs, op) else "bcast_gather"
    if algorithm == "ring" and not _ring_capable(xs, op):
        raise ValueError(
            "the C ring reduction is float32 sum/min/max only; use "
            "algorithm='bcast_gather'")
    if algorithm not in ("ring", "bcast_gather"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return algorithm


def _zero_pad_tail(out: np.ndarray, lo: int, count: int) -> np.ndarray:
    """Rewrite a ring reduce-scatter chunk's identity-padded ragged
    tail to zeros (the facade contract zero-pads, _rank_chunk)."""
    if lo + out.size > count:
        out[max(0, count - lo):] = 0.0
    return out


@_register("cuda")
class TorchBackend(Backend):
    """Rootless collectives over a ``LocalMesh`` of ``world_size`` ranks
    on one device."""

    name = "cuda"

    def __init__(self, world_size: int = 8, device=None):
        if world_size < 1:
            raise ValueError("world_size >= 1 required")
        self.world_size = world_size
        self.mesh = LocalMesh((world_size,), ("x",), device)
        self.device = self.mesh.device

    # -- data in and out -------------------------------------------------

    def _to_device(self, xs) -> tuple:
        """(tensors on the device, whether the caller gave numpy)."""
        xs = list(xs)
        if len(xs) != self.world_size:
            raise ValueError(f"need one array per rank ({self.world_size}),"
                             f" got {len(xs)}")
        is_numpy = not all(isinstance(x, torch.Tensor) for x in xs)
        ts = from_numpy(xs, self.device) if is_numpy \
            else [x.to(self.device) for x in xs]
        if len({(tuple(t.shape), t.dtype) for t in ts}) != 1:
            raise ValueError("every rank needs the same shape and dtype")
        return ts, is_numpy

    def _run(self, fn, xs) -> list:
        ts, is_numpy = self._to_device(xs)
        out = self.mesh.run(lambda axes, x: fn(x, axes["x"]), ts)
        return to_numpy(out) if is_numpy else out

    # -- the op surface --------------------------------------------------

    def bcast(self, origin: int, x, schedule: str = "binomial") -> list:
        """Every rank gets ``x`` from rank ``origin`` (any rank may be the
        origin); ``schedule`` is binomial, skip_ring or gather."""
        origin = int(origin)
        if not 0 <= origin < self.world_size:
            raise ValueError(f"origin {origin} outside world of "
                             f"{self.world_size}")
        if isinstance(x, torch.Tensor):
            xs = [x if r == origin else torch.zeros_like(x)
                  for r in range(self.world_size)]
        else:
            x = np.asarray(x)
            xs = [x if r == origin else np.zeros_like(x)
                  for r in range(self.world_size)]
        return self._run(lambda v, ax: dc.rootless_bcast(
            v, origin, ax, schedule=schedule), xs)

    def consensus(self, votes: Sequence[int], proposer: int = 0) -> int:
        """AND of every rank's {0,1} vote. The min-reduce is symmetric,
        so the proposer is moot, as on the TPU facade."""
        votes = [int(v) for v in votes]
        xs = [torch.tensor([v], dtype=torch.int32) for v in votes]
        out = self._run(lambda v, ax: dc.consensus(v, ax), xs)
        return int(out[0][0])

    def allreduce(self, xs, op: str = "sum", algorithm: str = "auto",
                  pipeline_chunks: Optional[int] = None) -> list:
        """``algorithm``: psum, ring, bidir_ring (``pipeline_chunks``
        sub-chunks per row), recursive_doubling, halving_doubling, or
        auto (psum)."""
        return self._run(lambda v, ax: dc.allreduce(
            v, ax, op=op, algorithm=algorithm,
            pipeline_chunks=pipeline_chunks), xs)

    def reduce_scatter(self, xs, op: str = "sum",
                       algorithm: str = "auto") -> list:
        """Rank r gets the r-th equal chunk of the flattened, zero-padded
        reduction. ``algorithm``: ring, halving (power-of-2 worlds) or
        auto (halving where it can); chip_smoke's phase 18 pins ring,
        the host facades' order of summation, for bit-equal sums."""
        return self._run(lambda v, ax: dc.reduce_scatter(
            v, ax, op=op, algorithm=algorithm), xs)

    def all_gather(self, xs) -> list:
        """Every rank gets all ranks' tensors stacked along a new leading
        axis."""
        return self._run(lambda v, ax: dc.all_gather(v, ax), xs)

    def all_to_all(self, xss, algorithm: str = "xla") -> List[list]:
        """``xss[r][d]`` is rank r's chunk for rank d; returns per-rank
        lists indexed by source. ``algorithm``: xla (the transport's own
        exchange), direct or ring."""
        ws = self.world_size
        if len(xss) != ws or any(len(row) != ws for row in xss):
            raise ValueError(f"need a {ws}x{ws} grid of chunks")
        if all(isinstance(c, torch.Tensor) for row in xss for c in row):
            rows = [torch.stack([c.to(self.device) for c in row])
                    for row in xss]
        else:
            rows = [np.stack([np.asarray(c) for c in row]) for row in xss]
        out = self._run(lambda v, ax: dc.all_to_all(
            v, ax, algorithm=algorithm), rows)
        return [[o[s] for s in range(ws)] for o in out]

    def barrier(self) -> None:
        self._run(lambda v, ax: v + dc.barrier(ax),
                  [torch.zeros((1,), dtype=torch.int32)] * self.world_size)


@_register("loopback")
class LoopbackBackend(Backend):
    """Pure-Python engines + coroutine collectives, one process."""

    name = "loopback"

    def __init__(self, world_size: Optional[int] = None, latency: int = 0,
                 seed: Optional[int] = None, **kwargs):
        from rlo_tpu_torch.engine import ProgressEngine, EngineManager, drain
        from rlo_tpu_torch.transport.loopback import LoopbackWorld
        from rlo_tpu_torch.ops.collectives import Comm, run_collectives

        self.world_size = world_size or 4
        # engines and data collectives ride separate worlds — the
        # analogue of the reference's dup'ed communicator per engine
        self._eng_world = LoopbackWorld(self.world_size, latency, seed)
        self._coll_world = LoopbackWorld(self.world_size, latency, seed)
        self._manager = EngineManager()
        # every facade engine judges with its slot of the CURRENT
        # round's votes (set by consensus() before proposing) — so
        # consensus runs on these persistent engines, interleaved with
        # their bcast traffic, not on a fabricated per-round world
        self._votes = [1] * self.world_size
        self._engines = [
            ProgressEngine(self._eng_world.transport(r),
                           judge_cb=lambda payload, ctx, i=r:
                               self._votes[i],
                           manager=self._manager)
            for r in range(self.world_size)]
        self._comms = [Comm(self._coll_world.transport(r))
                       for r in range(self.world_size)]
        self._run = run_collectives
        self._drain = drain

    @_staged
    def bcast(self, origin: int, x: np.ndarray) -> List[np.ndarray]:
        return self._engine_bcast(
            self._engines,
            lambda: self._drain([self._eng_world], self._engines),
            origin, x)

    def consensus(self, votes: Sequence[int], proposer: int = 0) -> int:
        """IAR round on the FACADE'S OWN engines (each judges with its
        slot of ``votes`` — reference judgement cb, rootless_ops.h:77;
        any position may propose). Runs interleaved with the engines'
        bcast traffic — no per-round world is fabricated — and works
        identically on sub_group facades (subset engines on their
        comm, bystanders active), matching the reference's consensus-
        on-any-communicator (rootless_ops.c:467, 1461)."""
        from rlo_tpu_torch.wire import Tag

        votes = list(votes)
        if len(votes) != self.world_size:
            raise ValueError("need one vote per rank")
        self._votes[:] = [int(v) for v in votes]
        eng = self._engines[proposer]
        eng.submit_proposal(b"facade", pid=proposer)
        for _ in range(1_000_000):
            self._manager.progress_all()
            if eng.vote_my_proposal() != -1:
                break
        decision = eng.vote_my_proposal()
        if decision == -1:
            raise RuntimeError("consensus did not complete")
        self._drain([self._eng_world], self._engines)
        # consume the decision deliveries so the next facade op's
        # pickups start clean (the proposer learns via vote_my_proposal)
        for i, e in enumerate(self._engines):
            if i == proposer:
                continue
            msg = e.pickup_next()
            if msg is None or msg.type != int(Tag.IAR_DECISION):
                raise RuntimeError(
                    f"member {i} expected the decision pickup, got "
                    f"{msg!r}")
        return int(decision)

    def _collective(self, method: str, xs, **kw) -> List[np.ndarray]:
        xs = self._check_xs(xs)
        coros = [getattr(c, method)(x, **kw)
                 for c, x in zip(self._comms, xs)]
        return self._run(coros)

    @_staged
    def allreduce(self, xs, op: str = "sum",
                  algorithm: str = "auto") -> List[np.ndarray]:
        return self._collective("allreduce", xs, op=op,
                                algorithm=algorithm)

    @_staged
    def reduce_scatter(self, xs, op: str = "sum") -> List[np.ndarray]:
        return self._collective("reduce_scatter", xs, op=op)

    @_staged
    def all_to_all(self, xss) -> List[List[np.ndarray]]:
        coros = [c.all_to_all(row)
                 for c, row in zip(self._comms, self._check_xss(xss))]
        return self._run(coros)

    @_staged
    def all_gather(self, xs) -> List[np.ndarray]:
        shape = np.asarray(xs[0]).shape
        outs = self._collective("all_gather", xs)
        # Comm.all_gather concatenates along axis 0; the facade contract
        # (matching lax.all_gather) stacks along a new leading axis
        return [o.reshape((self.world_size,) + shape) for o in outs]

    def barrier(self) -> None:
        self._run([c.barrier() for c in self._comms])

    def sub_group(self, members: Sequence[int]) -> "LoopbackBackend":
        """Facade over a rank subset. The Python loopback transport has
        no comm demux, so a sub-communicator IS its own dup'ed world —
        exactly the reference model (MPI_Comm_dup per engine,
        rootless_ops.c:1461): fresh worlds carry subset engines
        (ProgressEngine members=...) and subset Comm objects at the
        member endpoints. Ops are indexed by subset position."""
        return _LoopbackSubGroup(self, members)

    def close(self) -> None:
        for e in self._engines:
            e.cleanup()


class _LoopbackSubGroup(LoopbackBackend):
    """Scoped facade returned by LoopbackBackend.sub_group; all
    inherited ops work positionally (world_size = group size)."""

    name = "loopback-sub"

    def __init__(self, parent: "LoopbackBackend", members: Sequence[int]):
        from rlo_tpu_torch.engine import EngineManager, ProgressEngine, drain
        from rlo_tpu_torch.ops.collectives import Comm, run_collectives
        from rlo_tpu_torch.transport.loopback import LoopbackWorld

        ms = sorted(set(int(r) for r in members))
        full_ws = parent._eng_world.world_size
        self.members = ms
        self.world_size = len(ms)
        self._eng_world = LoopbackWorld(full_ws)
        self._coll_world = LoopbackWorld(full_ws)
        self._manager = EngineManager()
        self._votes = [1] * len(ms)  # judged by subset position
        self._engines = [
            ProgressEngine(self._eng_world.transport(r),
                           judge_cb=lambda payload, ctx, i=i:
                               self._votes[i],
                           manager=self._manager, members=ms)
            for i, r in enumerate(ms)]
        self._comms = [Comm(self._coll_world.transport(r), members=ms)
                       for r in ms]
        self._run = run_collectives
        self._drain = drain

    def sub_group(self, members):
        raise NotImplementedError("nested sub-groups are not supported")


@_register("native")
class NativeBackend(Backend):
    """The C core through ctypes. Data collectives default to the C
    ring schedules (rlo_coll.c: ring reduce-scatter/all-gather
    allreduce, rotation all-to-all — 2*(ws-1) rounds of 1/ws chunks,
    the bandwidth-optimal shape) and fall back to bcast-gather over the
    rootless broadcast overlay (every rank broadcasts its tensor and
    reduces what it picks up — the reference's any-rank-initiates
    "IAllReduce" notion, rootless_ops.c:876, generalized to tensors;
    O(ws^2) bytes, kept for non-f32 reductions and as the comparison
    baseline)."""

    name = "native"

    #: transport comm id for the coll layer (engines use comm 0)
    COLL_COMM = 64

    def __init__(self, world_size: Optional[int] = None, latency: int = 0,
                 seed: int = 1, msg_size_max: int = 1 << 22, **kwargs):
        from rlo_tpu_torch.native.bindings import (NativeColl, NativeEngine,
                                             NativeWorld)

        self.world_size = world_size or 4
        self.world = NativeWorld(self.world_size, latency, seed)
        # judge callbacks read the current round's votes (consensus()
        # pins them before proposing) so IAR runs on THESE engines
        self._votes = [1] * self.world_size
        self.engines = [NativeEngine(self.world, r,
                                     judge_cb=lambda payload, ctx, i=r:
                                         self._votes[i],
                                     msg_size_max=msg_size_max)
                        for r in range(self.world_size)]
        self.colls = [NativeColl(self.world, r, comm=self.COLL_COMM)
                      for r in range(self.world_size)]
        self._pos = {r: r for r in range(self.world_size)}
        self._msg_size_max = msg_size_max
        self._sub_comm_next = 128  # engine comm 0 / coll comm 64 taken
        self._sub_comm_free: List[int] = []  # recycled sub_group pairs

    def sub_group(self, members: Sequence[int]) -> "NativeBackend":
        """Facade over a rank subset — the reference's engine-on-any-
        communicator (rootless_ops.c:467, 1461) surfaced at the facade
        level. The returned backend shares this world (comm-demuxed
        subset engines + subset C collectives); its ops take/return
        lists indexed by SUBSET POSITION, and its world_size is the
        group size. Close the subgroup before (or let it die with)
        the parent."""
        return _NativeSubGroup(self, members)

    def _run_colls(self, starts):
        from rlo_tpu_torch.native.bindings import run_colls
        return run_colls(self.colls, starts)

    @_staged
    def bcast(self, origin: int, x: np.ndarray) -> List[np.ndarray]:
        return self._engine_bcast(self.engines, self.world.drain,
                                  origin, x)

    def consensus(self, votes: Sequence[int], proposer: int = 0) -> int:
        """IAR round on the FACADE'S OWN C engines (no per-round world;
        each member judges with its slot of ``votes``, any position may
        propose). Identical on sub_group facades — subset engines on
        their own comm, bystander engines live on the same world —
        matching rootless_ops.c:467, 1461."""
        from rlo_tpu_torch.wire import Tag

        votes = list(votes)
        if len(votes) != self.world_size:
            raise ValueError("need one vote per rank")
        self._votes[:] = [int(v) for v in votes]
        eng = self.engines[proposer]
        rc = eng.submit_proposal(b"facade", pid=proposer)
        for _ in range(2_000_000):
            if rc != -1:
                break
            self.world.progress_all()
            rc = eng.vote_my_proposal()
        else:
            raise RuntimeError("consensus did not complete")
        self.world.drain()
        eng.proposal_reset()
        # consume the decision deliveries so the next op starts clean
        for i, e in enumerate(self.engines):
            if i == proposer:
                continue
            msg = e.pickup_next()
            if msg is None or msg.type != int(Tag.IAR_DECISION):
                raise RuntimeError(
                    f"member {i} expected the decision pickup, got "
                    f"{msg!r}")
        return int(rc)

    def _bcast_gather(self, xs) -> List[List[np.ndarray]]:
        """Every rank broadcasts its tensor; returns per-rank lists of
        all world_size tensors in origin order."""
        from rlo_tpu_torch.ops.collectives import _pack_array, _unpack_array
        xs = self._check_xs(xs)
        for r, e in enumerate(self.engines):
            e.bcast(_pack_array(xs[r]))
        self.world.drain()
        out: List[List[Optional[np.ndarray]]] = []
        for r, e in enumerate(self.engines):
            got: List[Optional[np.ndarray]] = [None] * self.world_size
            got[r] = xs[r]
            while True:
                msg = e.pickup_next()
                if msg is None:
                    break
                got[self._pos[msg.origin]] = _unpack_array(msg.data)
            assert all(g is not None for g in got), \
                f"rank {r} missed a broadcast"
            out.append(got)
        return out

    @_staged
    def allreduce(self, xs, op: str = "sum",
                  algorithm: str = "auto") -> List[np.ndarray]:
        xs = self._check_xs(xs)
        algorithm = _resolve_ring_algorithm(algorithm, xs, op)
        if algorithm == "ring":
            shape = xs[0].shape
            outs = self._run_colls(
                [lambda r=r: self.colls[r].allreduce_start(xs[r], op)
                 for r in range(self.world_size)])
            return [np.asarray(o).reshape(shape) for o in outs]
        from rlo_tpu_torch.ops.collectives import OPS
        fn = OPS[op]
        gathered = self._bcast_gather(xs)
        outs = []
        for got in gathered:
            acc = got[0].copy()
            for g in got[1:]:
                acc = fn(acc, g)
            outs.append(acc)
        return outs

    @_staged
    def reduce_scatter(self, xs, op: str = "sum") -> List[np.ndarray]:
        xs = self._check_xs(xs)
        if _ring_capable(xs, op):
            # C ring reduce-scatter; its ragged tail is identity-padded
            # for reduction correctness — rewritten to zeros to match
            # the facade contract (_rank_chunk zero-pads)
            count = xs[0].size
            outs = self._run_colls(
                [lambda r=r: self.colls[r].reduce_scatter_start(
                    xs[r].reshape(-1), op)
                 for r in range(self.world_size)])
            outs = [np.asarray(o) for o in outs]
            chunk = outs[0].size
            return [_zero_pad_tail(outs[r], r * chunk, count)
                    for r in range(self.world_size)]
        full = self.allreduce(xs, op=op, algorithm="bcast_gather")
        return [_rank_chunk(full[r], self.world_size, r)
                for r in range(self.world_size)]

    @_staged
    def all_gather(self, xs) -> List[np.ndarray]:
        from rlo_tpu_torch.ops.collectives import _pack_array, _unpack_array
        xs = self._check_xs(xs)
        packed = [_pack_array(x) for x in xs]
        if len({len(b) for b in packed}) == 1:
            outs = self._run_colls(
                [lambda r=r: self.colls[r].all_gather_start(packed[r])
                 for r in range(self.world_size)])
            n = len(packed[0])
            out = []
            for o in outs:
                raw = np.asarray(o).tobytes()
                out.append(np.stack([
                    _unpack_array(raw[i * n:(i + 1) * n])
                    for i in range(self.world_size)]))
            return out
        gathered = self._bcast_gather(xs)
        return [np.stack(got) for got in gathered]

    @_staged
    def all_to_all(self, xss) -> List[List[np.ndarray]]:
        from rlo_tpu_torch.ops.collectives import _pack_array, _unpack_array
        ws = self.world_size
        xss = self._check_xss(xss)
        packed = [[_pack_array(np.asarray(x)) for x in row]
                  for row in xss]
        sizes = {len(b) for row in packed for b in row}
        if len(sizes) == 1:
            n = sizes.pop()
            outs = self._run_colls(
                [lambda r=r: self.colls[r].all_to_all_start(packed[r])
                 for r in range(ws)])
            return [[_unpack_array(np.asarray(o).tobytes()
                                   [src * n:(src + 1) * n])
                     for src in range(ws)] for o in outs]
        rows = [np.stack(row) for row in xss]
        gathered = self._bcast_gather(rows)
        return [[gathered[r][src][r] for src in range(ws)]
                for r in range(ws)]

    def barrier(self) -> None:
        self._run_colls([self.colls[r].barrier_start
                         for r in range(self.world_size)])
        self.world.drain()

    def close(self) -> None:
        for c in self.colls:
            c.close()
        self.world.close()


class _NativeSubGroup(NativeBackend):
    """Scoped facade returned by NativeBackend.sub_group: the same op
    surface over subset engines (rlo_engine_new_sub) and subset C
    collectives (rlo_coll_new_sub) on the PARENT's world, isolated by
    fresh comm ids. Every inherited op works positionally: world_size
    is the group size, engines/colls are indexed by subset position,
    and _pos maps real origin ranks back to positions."""

    name = "native-sub"

    def __init__(self, parent: NativeBackend, members: Sequence[int]):
        from rlo_tpu_torch.native.bindings import NativeColl, NativeEngine

        ms = sorted(set(int(r) for r in members))
        self.world = parent.world
        self.world_size = len(ms)
        self.members = ms
        self._pos = {r: i for i, r in enumerate(ms)}
        self._msg_size_max = parent._msg_size_max
        self._votes = [1] * len(ms)  # judged by subset position
        self._sub_comm_next = None  # subgroups don't nest (yet)
        # comm ids recycle through the parent's free list, so long-lived
        # processes creating/closing subgroups don't grow ids unboundedly
        self._parent = parent
        if parent._sub_comm_free:
            ec = parent._sub_comm_free.pop()
        else:
            ec = parent._sub_comm_next
            parent._sub_comm_next += 2
        self._comm_pair = ec
        self.engines = [NativeEngine(self.world, r, comm=ec,
                                     members=ms,
                                     judge_cb=lambda payload, ctx, i=i:
                                         self._votes[i],
                                     msg_size_max=self._msg_size_max)
                        for i, r in enumerate(ms)]
        self.colls = [NativeColl(self.world, r, comm=ec + 1,
                                 members=ms) for r in ms]

    def sub_group(self, members):
        raise NotImplementedError("nested sub-groups are not supported")

    def close(self) -> None:
        for c in self.colls:
            c.close()
        for e in list(self.engines):
            e.close()
        # the world belongs to the parent; the comm-id pair recycles
        if self._comm_pair is not None:
            self._parent._sub_comm_free.append(self._comm_pair)
            self._comm_pair = None


@_register("shm")
class ShmBackend(Backend):
    """Pointer to the C-only multi-process path."""

    name = "shm"

    def __init__(self, **kwargs):
        raise RuntimeError(
            "the shm transport is one-process-per-rank and C-only; run "
            "scenarios via the port's demo binary (python3 -m "
            "rlo_tpu_torch.native.build demo && "
            "rlo_tpu_torch/native/_build/rlo_demo -n 8), or use "
            "backend='native' for the in-process C core")


@_register("mpi")
class MpiBackend(Backend):
    """Per-rank SPMD facade over the compile-gated MPI transport.

    Unlike the single-controller backends above, every MPI process is ONE
    rank (run under mpirun), so ops take and return this rank's array:
    ``allreduce(x)`` not ``allreduce([x0, .., xN])``. Collectives run as
    bcast-gather over the rootless broadcast overlay, like NativeBackend.
    """

    name = "mpi"

    def __init__(self, world_size: Optional[int] = None, **kwargs):
        from rlo_tpu_torch.native.bindings import load
        lib = load()
        if not lib.rlo_mpi_available():
            raise RuntimeError(
                "this build has no MPI (mpi.h was absent at compile "
                "time). Launch under the in-repo MPI subset —\n"
                "    python3 -m rlo_tpu_torch.native.build femtompirun\n"
                "    rlo_tpu_torch/native/_build/femtompirun -n N "
                "python your_prog.py\n"
                "(the bindings auto-build the femtompi-linked core when "
                "FEMTOMPI_RANK is set) — or rebuild on a host with a "
                "real MPI and run under mpirun.")
        w = lib.rlo_mpi_world_new()
        if not w:
            raise RuntimeError(
                "MPI world creation failed (need mpirun with >= 2 ranks)")
        self._adopt_world(lib, w)

    def _adopt_world(self, lib, w) -> None:
        """Wrap a per-rank C world (MPI or TCP) into the NativeWorld
        shell and build this rank's engine + collectives on it."""
        from rlo_tpu_torch.native.bindings import NativeEngine, NativeWorld

        # adopt the C world into the NativeWorld wrapper so NativeEngine
        # and drain work unchanged
        self.world = NativeWorld.adopt(lib, w)
        self.world_size = self.world.world_size
        self.rank = lib.rlo_world_my_rank(w)
        # position within this communicator (== rank for the full
        # world; sub_group facades remap it to the subset position)
        self.pos = self.rank
        # the judge callback reads this rank's current vote (set by
        # consensus() before each round)
        self._my_vote = 1
        self.engine = NativeEngine(
            self.world, self.rank, msg_size_max=1 << 22,
            judge_cb=lambda payload, ctx: self._my_vote)
        from rlo_tpu_torch.native.bindings import NativeColl
        self.coll = NativeColl(self.world, self.rank,
                               comm=NativeBackend.COLL_COMM)
        self._sub_comm_next = 128  # 0 (engine) and 64 (coll) taken
        self._sub_comm_free: List[int] = []  # via release_sub_comm
        self._sub_comm_alloc: List[int] = []  # live pairs, LIFO

    def _drain(self) -> None:
        """Quiesce this communicator. Full world: the transport's
        collective termination-detection drain (every rank enters).
        Overridden by _MpiSubGroup — the full drain is collective over
        ALL ranks (MPI_Iallreduce, rlo_mpi.c), which a member-only op
        must never enter."""
        self.world.drain()

    def _spin_pickup(self, want: int, max_spins: int = 200_000_000):
        """Progress until `want` messages are picked up; returns them."""
        got = []
        for _ in range(max_spins):
            msg = self.engine.pickup_next()
            if msg is not None:
                got.append(msg)
                if len(got) == want:
                    return got
                continue
            self.world.progress_all()
        raise RuntimeError(f"rank {self.rank}: expected {want} messages, "
                           f"got {len(got)}")

    @_staged
    def bcast(self, origin: int, x: Optional[np.ndarray] = None):
        """``origin`` is a communicator POSITION (== rank on the full
        world; subset position on sub_group facades)."""
        from rlo_tpu_torch.ops.collectives import _pack_array, _unpack_array
        if self.pos == origin:
            self.engine.bcast(_pack_array(np.asarray(x)))
            self._drain()
            return np.asarray(x)
        (msg,) = self._spin_pickup(1)
        self._drain()
        return _unpack_array(msg.data)

    def consensus(self, my_vote: int, proposer: int = 0) -> int:
        """One leaderless round over the real process ranks: ANY rank
        may initiate (``proposer`` — the reference's rootless pitch,
        RLO_submit_proposal from any rank), every process judges with
        its own pinned vote, and the AND-merged decision broadcasts."""
        from rlo_tpu_torch.wire import Tag
        self._my_vote = int(my_vote)  # read by this rank's judge cb
        # every member's vote must be pinned BEFORE any proposal can
        # arrive: without this barrier a slow rank still draining the
        # previous collective could judge the proposal with its stale
        # previous-round vote (subset barrier on sub_groups — the C
        # coll barrier spans exactly this communicator's members)
        self.barrier()
        if self.pos == proposer:
            rc = self.engine.submit_proposal(b"facade", pid=proposer)
            for _ in range(200_000_000):
                if rc != -1:
                    break
                self.world.progress_all()
                rc = self.engine.vote_my_proposal()
            else:
                raise RuntimeError(
                    "consensus did not complete (a peer rank stalled?)")
            self._drain()
            self.engine.proposal_reset()
            return int(rc)
        (msg,) = self._spin_pickup(1)
        assert msg.type == int(Tag.IAR_DECISION)
        self._drain()
        return int(msg.vote)

    @_staged
    def allreduce(self, x: np.ndarray, op: str = "sum",
                  algorithm: str = "auto") -> np.ndarray:
        x = np.asarray(x)
        algorithm = _resolve_ring_algorithm(algorithm, [x], op)
        if algorithm == "ring":
            return self.coll.allreduce(x, op)
        from rlo_tpu_torch.ops.collectives import (OPS, _pack_array,
                                             _unpack_array)
        self.engine.bcast(_pack_array(x))
        msgs = self._spin_pickup(self.world_size - 1)
        self._drain()
        acc = x.copy()
        for m in msgs:
            acc = OPS[op](acc, _unpack_array(m.data))
        return acc

    @_staged
    def all_gather(self, x: np.ndarray) -> np.ndarray:
        from rlo_tpu_torch.ops.collectives import _pack_array, _unpack_array
        x = np.asarray(x)
        packed = _pack_array(x)
        parts_raw = self.coll.all_gather(packed)
        return np.stack([_unpack_array(raw) for raw in parts_raw])

    @_staged
    def reduce_scatter(self, x: np.ndarray, op: str = "sum") -> np.ndarray:
        x = np.asarray(x)
        if _ring_capable([x], op):
            out = np.asarray(self.coll.reduce_scatter(x.reshape(-1), op))
            return _zero_pad_tail(out, self.pos * out.size, x.size)
        full = self.allreduce(x, op=op)
        return _rank_chunk(full, self.world_size, self.pos)

    @_staged
    def all_to_all(self, xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Per-rank form: ``xs[d]`` is THIS rank's chunk for rank d;
        returns the chunks received, indexed by source (the C rotation
        all-to-all, ws-1 rounds — not the old all_gather of full rows)."""
        from rlo_tpu_torch.ops.collectives import _pack_array, _unpack_array
        packed = [_pack_array(np.asarray(x)) for x in
                  self._check_xs(xs)]
        if len({len(b) for b in packed}) == 1:
            return [_unpack_array(raw)
                    for raw in self.coll.all_to_all(packed)]
        row = np.stack(self._check_xs(xs))
        gathered_raw = self.coll.all_gather(_pack_array(row))
        return [_unpack_array(raw)[self.pos] for raw in gathered_raw]

    def barrier(self) -> None:
        self.coll.barrier()
        self._drain()

    def sub_group(self, members: Sequence[int]):
        """Collective: EVERY process must call this with the same
        ``members`` (like MPI_Comm_split), in the same order relative
        to other sub_group calls so the comm ids agree. Member ranks
        get a positional facade over the subset — a set of real
        processes can then run consensus/bcast/collectives among
        themselves while the others keep using the parent facade;
        non-members get None (the MPI_COMM_NULL convention). Matches
        the reference's engine-on-any-communicator
        (rootless_ops.c:467, 1461)."""
        ms = sorted(set(int(r) for r in members))
        bad = [r for r in ms if not 0 <= r < self.world_size]
        if bad:
            raise ValueError(f"members {bad} outside the world")
        # comm ids must agree across ALL ranks, so recycling is also
        # collective: release_sub_comm (below) is the MPI_Comm_free
        # analogue. rlo_mpi.c multiplexes comm into the MPI tag
        # (stride 16) and MPI only guarantees tags up to 32767, so an
        # un-recycled long-liver would eventually overflow — cap it.
        if self._sub_comm_free:
            ec = self._sub_comm_free.pop()
        else:
            ec = self._sub_comm_next
            self._sub_comm_next += 2
            if ec + 1 >= 2047:  # (2047*16 + 15) == MPI_TAG_UB floor
                raise RuntimeError(
                    "sub-communicator ids exhausted; release closed "
                    "sub_groups with release_sub_comm() (collective)")
        self._sub_comm_alloc.append(ec)
        if self.rank not in ms:
            return None
        return _MpiSubGroup(self, ms, ec)

    def release_sub_comm(self) -> None:
        """COLLECTIVE (every rank, like MPI_Comm_free): recycle the
        comm-id pair of the most recently created, not-yet-released
        sub_group (LIFO). Member ranks must close() the facade first;
        non-members (who got None) just call this. Keeps the comm-id
        allocator in lockstep across ranks, which unilateral recycling
        at close() could not."""
        if not self._sub_comm_alloc:
            raise RuntimeError("no live sub_group comm pair to release")
        self._sub_comm_free.append(self._sub_comm_alloc.pop())

    def close(self) -> None:
        self.coll.close()
        self.world.close()


class _MpiSubGroup(MpiBackend):
    """Positional per-rank facade over a subset of the real MPI
    processes: subset engine + subset C collectives on fresh comm ids
    of the PARENT's world (frames demux by comm — rlo_mpi.c
    multiplexes comm into the MPI tag). All inherited ops work with
    ``pos`` = this rank's position in the member list."""

    name = "mpi-sub"

    def __init__(self, parent: MpiBackend, ms: List[int], ec: int):
        from rlo_tpu_torch.native.bindings import NativeColl, NativeEngine

        self.world = parent.world
        self.world_size = len(ms)
        self.members = ms
        self.rank = parent.rank
        self.pos = ms.index(parent.rank)
        self._my_vote = 1
        self.engine = NativeEngine(
            self.world, self.rank, comm=ec, members=ms,
            msg_size_max=1 << 22,
            judge_cb=lambda payload, ctx: self._my_vote)
        self.coll = NativeColl(self.world, self.rank, comm=ec + 1,
                               members=ms)
        self._sub_comm_next = None  # subgroups don't nest

    def _drain(self) -> None:
        # subset quiescence WITHOUT the full-world collective drain:
        # progress until the local engine is idle (sends flushed,
        # queues empty), then the subset C barrier — every member has
        # reached the same point, so the op's frames are all consumed
        for _ in range(200_000_000):
            if self.engine.idle():
                break
            self.world.progress_all()
        else:
            raise RuntimeError("subset drain: engine never went idle")
        self.coll.barrier()

    def barrier(self) -> None:
        self.coll.barrier()

    def sub_group(self, members):
        raise NotImplementedError("nested sub-groups are not supported")

    def close(self) -> None:
        self.coll.close()
        self.engine.close()
        # the world belongs to the parent


@_register("tcp")
class TcpBackend(MpiBackend):
    """Per-rank SPMD facade over the TCP socket transport (rlo_tcp.c):
    the same op surface as MpiBackend, but the frames cross a real
    socket mesh that can span machines — launch one process per rank
    with RLO_TCP_RANK/RLO_TCP_WORLD (+ RLO_TCP_HOSTS for multi-host,
    or rlo_tpu_torch/native/tcprun locally). The control plane of
    docs/DEPLOY.md's multi-host mapping runs on exactly this."""

    name = "tcp"

    def __init__(self, world_size: Optional[int] = None, **kwargs):
        from rlo_tpu_torch.native.bindings import load
        lib = load()
        w = lib.rlo_tcp_world_new()
        if not w:
            raise RuntimeError(
                "TCP world creation failed: launch one process per rank "
                "with RLO_TCP_RANK/RLO_TCP_WORLD set (locally via "
                "rlo_tpu_torch/native/tcprun -n N python your_prog.py; across "
                "hosts set RLO_TCP_HOSTS='host:port,...' per rank)")
        self._adopt_world(lib, w)
