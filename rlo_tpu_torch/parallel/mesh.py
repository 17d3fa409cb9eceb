"""Mesh axes for the per-rank collective functions.

The port's counterpart of ``rlo_tpu/parallel/mesh.py``. A JAX per-shard
function names its mesh axis and runs under ``shard_map``; a port
per-rank function is handed an ``Axis`` object and runs once per rank.
Two transports implement ``Axis``:

  - ``LocalMesh(shape, names, device)`` runs ``prod(shape)`` ranks as
    threads of one process on one device and runs a per-rank function in
    lockstep (the counterpart of ``shard_jit`` over a mesh; 1-D to 3-D
    meshes, e.g. ``(dcn, ici)`` or ``(dp, sp, tp)``). A transfer is an
    on-device copy.
  - ``DistAxis(group, device)`` sits over a ``torch.distributed`` process
    group: gloo on the CPU, NCCL on GPUs, or gloo carrying a card's
    tensors through host buffers (below); ``ppermute`` is
    ``dist.batch_isend_irecv``. ``dist_mesh_axes(shape, names)`` gives
    this process its ``DistAxis`` on every axis of a process mesh (the
    counterpart of ``make_mesh``).

A collective inside a backward (``parallel.autodiff``) needs each rank's
backward on a thread of its own. On the CPU the autograd engine runs the
backward on the thread that asks for it, so a CPU ``LocalMesh`` runs it;
the backward of CUDA tensors runs on one autograd thread per device, so
on a card's ``LocalMesh`` the first rank's backward collective would
wait for ranks queued behind it on that thread: there the ranks are
processes (``DistAxis``).

``vary_like`` (vma typing) has no counterpart and is not ported.
"""

from __future__ import annotations

import math
import threading
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple)

import torch

Pairs = Sequence[Tuple[int, int]]


class Axis(Protocol):
    """One mesh axis as seen from one rank."""

    size: int
    index: int
    #: where this rank's tensors live
    device: torch.device
    #: True on the one rank that speaks for the whole program (fires the
    #: step hook): rank 0 of a LocalMesh, every process of a DistAxis
    leader: bool

    def ppermute(self, x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        """Send ``x`` along the (src, dst) ``pairs``. As in
        ``lax.ppermute``, a rank that is no destination receives zeros."""

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along a new leading axis."""

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """op = sum/min/max/and/or over every rank's ``x``, replicated
        (and/or are min/max, as the JAX package lowers them)."""

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` is (size, ...): row s goes to rank s; returns the rows
        addressed to this rank, indexed by source."""

    def barrier(self) -> None:
        """Wait until every rank of the axis has arrived."""


def _src_of(pairs: Pairs, me: int) -> Optional[int]:
    for s, d in pairs:
        if d == me:
            return s
    return None


def _check_pairs(pairs: Pairs, size: int) -> None:
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"not a permutation: {list(pairs)}")
    if any(not 0 <= r < size for r in srcs + dsts):
        raise ValueError(f"pair outside an axis of size {size}: "
                         f"{list(pairs)}")


def resolve_device(device=None) -> torch.device:
    """``None`` is the card; a CUDA device without a card raises. Only
    an explicit ``"cpu"`` runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the port's plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_coords(shape: Sequence[int], rank: int) -> Tuple[int, ...]:
    """Coordinates of a row-major ``rank`` on a mesh of ``shape``."""
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


_REDUCE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
           "and": torch.minimum, "or": torch.maximum}


# ---------------------------------------------------------------------------
# LocalMesh: ranks as threads on one device
# ---------------------------------------------------------------------------

class LocalMesh:
    """``prod(shape)`` ranks as threads of this process on ``device``
    (``None`` is the card and raises without one; ``"cpu"`` only when
    asked for).

    ``run(fn, *per_rank_args)`` calls ``fn(axes, *args_r)`` on every
    rank r at once, where ``axes`` maps each axis name to that rank's
    ``LocalAxis`` and each positional argument is a list with one entry
    per rank (row-major over ``shape``). It returns the per-rank results.

    Exchange: each rank deposits its tensor in a slot, all wait at a
    ``threading.Barrier``, each clones what it reads, and all wait again
    before a slot is reused. Every rank therefore has to run the same
    sequence of collectives (as every SPMD program does); a rank that
    raises aborts the barrier so the others stop at once, and ``run``
    re-raises the first error. A rank that never arrives makes the
    others time out after ``timeout`` seconds instead of hanging.

    On a CUDA device every rank enqueues on the same stream, so a clone
    is ordered after the producer's kernels and before later writes.
    """

    def __init__(self, shape: Sequence[int], names: Sequence[str],
                 device=None, timeout: float = 300.0):
        shape = tuple(int(s) for s in shape)
        names = tuple(names)
        if len(shape) != len(names) or len(shape) not in (1, 2, 3):
            raise ValueError("LocalMesh takes a 1-D to 3-D shape with one "
                             "name per dimension")
        if any(s < 1 for s in shape) or len(set(names)) != len(names):
            raise ValueError(f"bad mesh {shape} / {names}")
        self.shape, self.names = shape, names
        self.device = resolve_device(device)
        self.world_size = math.prod(shape)
        self.timeout = timeout
        self._slots: List[object] = [None] * self.world_size
        self._barrier = threading.Barrier(self.world_size, timeout=timeout)
        self._run_lock = threading.Lock()

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.names, self.shape))

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Mesh coordinates of a global (row-major) rank."""
        return mesh_coords(self.shape, rank)

    def rank_of(self, coords: Sequence[int]) -> int:
        r = 0
        for c, s in zip(coords, self.shape):
            r = r * s + c
        return r

    def axes(self, rank: int) -> Dict[str, "LocalAxis"]:
        """Each axis name -> rank ``rank``'s ``LocalAxis`` (what ``run``
        hands a rank; outside ``run`` only its ``size`` and ``index``
        may be used, e.g. by ``sharding.shard_tree``)."""
        return {name: LocalAxis(self, rank, dim)
                for dim, name in enumerate(self.names)}

    def _wait(self) -> None:
        self._barrier.wait()

    def run(self, fn: Callable, *per_rank_args) -> list:
        for a in per_rank_args:
            if len(a) != self.world_size:
                raise ValueError(f"need one argument per rank "
                                 f"({self.world_size}), got {len(a)}")
        results: List[object] = [None] * self.world_size
        errors: List[Optional[BaseException]] = [None] * self.world_size

        def body(r: int) -> None:
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                results[r] = fn(self.axes(r),
                                *(a[r] for a in per_rank_args))
            except BaseException as e:  # noqa: BLE001 - re-raised in run
                errors[r] = e
                self._barrier.abort()

        with self._run_lock:  # one SPMD program at a time per mesh
            threads = [threading.Thread(target=body, args=(r,),
                                        name=f"rank{r}", daemon=True)
                       for r in range(self.world_size)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            self._slots = [None] * self.world_size
            broken = self._barrier.broken
            if broken:
                self._barrier = threading.Barrier(self.world_size,
                                                  timeout=self.timeout)
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     None)
        if first is not None:
            raise first
        if any(e is not None for e in errors) or broken:
            raise RuntimeError(
                f"LocalMesh: a rank did not reach a collective within "
                f"{self.timeout} s (ranks ran different collective "
                f"sequences?)")
        return results


class LocalAxis:
    """One axis of a LocalMesh, as seen from one rank."""

    def __init__(self, mesh: LocalMesh, rank: int, dim: int):
        self.mesh, self.rank, self.dim = mesh, rank, dim
        self.size = mesh.shape[dim]
        self._coords = mesh.coords(rank)
        self.index = self._coords[dim]
        self.device = mesh.device
        self.leader = rank == 0

    def _peer(self, index: int) -> int:
        c = list(self._coords)
        c[self.dim] = index
        return self.mesh.rank_of(c)

    def _exchange(self, x, read: Callable):
        m = self.mesh
        m._slots[self.rank] = x
        m._wait()
        try:
            return read(m._slots)
        finally:
            m._wait()

    def ppermute(self, x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        _check_pairs(pairs, self.size)
        src = _src_of(pairs, self.index)
        # no source: zeros, as lax.ppermute gives (the bcast schedules
        # select with is_dst and never read them)
        return self._exchange(
            x, lambda slots: torch.zeros_like(x) if src is None
            else slots[self._peer(src)].clone())

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self._exchange(x, lambda slots: torch.stack(
            [slots[self._peer(i)] for i in range(self.size)]))

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        fn = _REDUCE[op]

        def read(slots):
            acc = slots[self._peer(0)].clone()
            for i in range(1, self.size):
                fn(acc, slots[self._peer(i)], out=acc)
            return acc
        return self._exchange(x, read)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.size:
            raise ValueError(f"leading axis {x.shape[0]} != axis size "
                             f"{self.size}")
        return self._exchange(x, lambda slots: torch.stack(
            [slots[self._peer(i)][self.index] for i in range(self.size)]))

    def barrier(self) -> None:
        self.mesh._wait()


# ---------------------------------------------------------------------------
# DistAxis: one rank per process over torch.distributed
# ---------------------------------------------------------------------------

class DistAxis:
    """An axis over a ``torch.distributed`` group (this process is one
    rank). ``device`` is where the rank's tensors live: None is the
    backend's own (this process's current GPU for NCCL, the CPU for
    gloo).

    gloo with a CUDA ``device`` carries a card's tensors. gloo's
    all-reduce and all-gather take them itself (copying them to host
    memory and back inside the call); its point-to-point ops take host
    tensors only (``python3 -m rlo_tpu_torch.tools.gloo_cuda_probe``
    shows which calls take a card's tensor), so ``ppermute`` and
    ``all_to_all`` copy a CUDA tensor into a host buffer, exchange it and
    copy the result back to the card. ``staged_bytes`` counts every byte
    that crosses between the card and the host either way, gloo's own
    copies included. The computation stays on the card. A CUDA tensor
    on a gloo axis made for the CPU raises in the staged calls rather
    than moving to the host unasked."""

    leader = True

    def __init__(self, group=None, device=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        backend = dist.get_backend(group)
        if device is None:
            device = "cuda" if backend == "nccl" else "cpu"
        self.device = resolve_device(device)
        self._gloo = backend == "gloo"
        #: bytes copied between the card and host buffers so far
        self.staged_bytes = 0
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self._globals = [dist.get_global_rank(group, i) if group is not None
                         else i for i in range(self.size)]

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the backend's point-to-point ops take it: contiguous,
        and for gloo on the host (a card's tensor copied there and
        counted)."""
        if not self._gloo or x.device.type == "cpu":
            return x.contiguous()
        if self.device.type != "cuda":
            raise ValueError(f"a {x.device} tensor on a gloo axis made for "
                             f"the CPU: give DistAxis the card as its "
                             f"device to stage it through the host")
        self.staged_bytes += x.numel() * x.element_size()
        return x.to("cpu", memory_format=torch.contiguous_format)

    def _unstage(self, out: torch.Tensor, like: torch.Tensor):
        """``out`` back on ``like``'s device (counted when it moves)."""
        if out.device == like.device:
            return out
        self.staged_bytes += out.numel() * out.element_size()
        return out.to(like.device)

    def _ppermute(self, x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        dist = self._dist
        dst = next((d for s, d in pairs if s == self.index), None)
        src = _src_of(pairs, self.index)
        # no source: zeros, as lax.ppermute gives
        out = torch.zeros_like(x)
        if dst == self.index and src == self.index:
            return x.clone()
        ops = []
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, self._globals[src],
                                  self.group))
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x, self._globals[dst],
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def ppermute(self, x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        _check_pairs(pairs, self.size)
        return self._unstage(self._ppermute(self._stage(x), pairs), x)

    def _count_gloo_copies(self, nbytes: int, x: torch.Tensor) -> None:
        if self._gloo and x.device.type == "cuda":
            self.staged_bytes += nbytes

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._count_gloo_copies((1 + self.size) * x.numel()
                                * x.element_size(), x)
        self._dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        R = self._dist.ReduceOp
        red = {"sum": R.SUM, "min": R.MIN, "max": R.MAX, "and": R.MIN,
               "or": R.MAX}[op]
        out = x.clone().contiguous()
        self._count_gloo_copies(2 * out.numel() * out.element_size(), out)
        self._dist.all_reduce(out, op=red, group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        # ws-1 shifted exchanges (gloo has no all-to-all on every build);
        # a staged tensor crosses to the host and back once
        if x.shape[0] != self.size:
            raise ValueError(f"leading axis {x.shape[0]} != axis size "
                             f"{self.size}")
        h = self._stage(x)
        out = torch.empty_like(h)
        out[self.index] = h[self.index]
        ws = self.size
        for o in range(1, ws):
            pairs = [(i, (i + o) % ws) for i in range(ws)]
            out[(self.index - o) % ws] = self._ppermute(
                h[(self.index + o) % ws].contiguous(), pairs)
        return self._unstage(out, x)

    def barrier(self) -> None:
        self._dist.barrier(group=self.group)


def dist_mesh_axes(shape: Sequence[int], names: Sequence[str],
                   device=None) -> Dict[str, DistAxis]:
    """This process's ``DistAxis`` on each axis of a row-major process
    mesh of ``shape`` over the default group's ranks (the counterpart of
    ``make_mesh``): every line of the mesh along an axis gets its own
    group, and this process keeps the group of its own line. Every
    process must call this with the same arguments: ``dist.new_group``
    is collective, and the groups are made in one order everywhere."""
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    names = tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"bad mesh {shape} / {names}")
    ws, me = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != ws:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} processes; "
                         f"the group has {ws}")
    coords = [mesh_coords(shape, r) for r in range(ws)]
    out = {}
    for dim, name in enumerate(names):
        lines: Dict[tuple, List[int]] = {}
        for r, c in enumerate(coords):
            lines.setdefault(c[:dim] + c[dim + 1:], []).append(r)
        for key in sorted(lines):
            group = dist.new_group(lines[key])
            if me in lines[key]:
                out[name] = DistAxis(group, device=device)
    return out
