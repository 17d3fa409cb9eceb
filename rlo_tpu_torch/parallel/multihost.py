"""Multi-process deployment: one OS process a rank, engine and device.

The port of ``rlo_tpu/parallel/multihost.py``. Each process runs

  - its own ENGINE rank, a ``ProgressEngine`` over the TCP socket mesh
    (``transport/tcp.py``), with engine rank = torch rank; and
  - its own device data plane: a ``torch.distributed`` data group whose
    ``DistAxis`` carries the collective (NCCL, one card a process, by
    default).

The consensus-gated collective is distributed end to end: the proposal,
vote and decision frames are real cross-process engine traffic (any
process may initiate), each process judges its own local tensor on its
device, and only an approved round runs the data group's all-reduce; a
veto by any one process stops it on every process.

Start-up, under ``torchrun`` (``env://``)::

    torchrun --nproc-per-node 4 -m rlo_tpu_torch.tools.multihost_demo

or with an explicit store (what the tests and ``chip_smoke.py`` do)::

    ctx = MultiHostContext(store=torch.distributed.FileStore(path, ws),
                           rank=r, world_size=ws, data_backend="gloo")

Departures from the JAX package, by design:
  - torch comes up before the engine (the reference brings the engine up
    first and hands its rank to ``jax.distributed``): here the rank comes
    from torch's launcher or store;
  - the engine's only transport is TCP, the transport the JAX package's
    ``TcpBackend`` names for multi-host deployment; there is no
    femtompi/MPI transport;
  - the data group's backend is an explicit argument: ``"nccl"`` by
    default, ``"gloo"`` where the caller asks for it (the CPU tests;
    several processes sharing one card, which NCCL refuses). Nothing
    switches it on its own. gloo's all-reduce of a card's tensor goes
    through a host copy.
"""

from __future__ import annotations

import time
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


class MultiHostContext:
    """Engine control plane + ``torch.distributed`` data plane for one
    process.

    ``store``/``rank``/``world_size``: an explicit rendezvous; without
    them ``torch.distributed`` comes up from ``env://`` (``torchrun``),
    unless the caller has already initialised it. A gloo control group
    always comes up (it carries the barrier before a round and the
    drain), and the data group beside it with ``data_backend``.
    ``device``: where local tensors and judges live (None: this
    process's current card; ``"cpu"`` for the tests).
    """

    def __init__(self, *, store=None, rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 data_backend: str = "nccl", device=None,
                 timeout: float = 120.0):
        import torch.distributed as dist
        from rlo_tpu_torch.parallel.mesh import resolve_device

        self._dist = dist
        self.timeout = timeout
        self.device = resolve_device(device)
        if data_backend == "nccl" and self.device.type != "cuda":
            raise ValueError("data_backend='nccl' needs a CUDA device")
        self._owns_pg = not dist.is_initialized()
        if self._owns_pg:
            if store is not None:
                dist.init_process_group(
                    "gloo", store=store, rank=rank, world_size=world_size,
                    timeout=timedelta(seconds=timeout))
            else:
                dist.init_process_group("gloo", init_method="env://",
                                        timeout=timedelta(seconds=timeout))
        if store is None:
            store = dist.distributed_c10d._get_default_store()
        self.rank = self.pos = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.data_backend = data_backend
        self.ctrl = dist.new_group(backend="gloo")
        self.data = dist.new_group(backend=data_backend)
        from rlo_tpu_torch.transport.tcp import TcpWorld
        # the control group's name is the same on every process (groups
        # are made in the same order everywhere), so it keys this mesh's
        # endpoints apart from another context's on the same store
        self._tcp = TcpWorld(
            self.rank, self.world_size,
            dist.PrefixStore(f"rlo_mh/{self.ctrl.group_name}", store),
            timeout=timeout)
        self._sub_next = 1
        self._setup_plane(self._tcp.transport(0), None, self.data)

    def _setup_plane(self, transport, members, data_group) -> None:
        from rlo_tpu_torch.engine import EngineManager, ProgressEngine
        from rlo_tpu_torch.parallel.mesh import DistAxis

        self._transport = transport
        self._manager = EngineManager()
        self._my_vote = 1
        self.engine = ProgressEngine(
            transport, judge_cb=lambda payload, ctx: self._my_vote,
            manager=self._manager, members=members)
        self._axis = DistAxis(data_group)

    # -- the engine's progress -------------------------------------------

    def _spin(self, done: Callable[[], bool], what: str) -> None:
        deadline = time.monotonic() + self.timeout
        while not done():
            self._manager.progress_all()
            if time.monotonic() > deadline:
                raise RuntimeError(f"rank {self.rank}: {what} did not "
                                   f"finish in {self.timeout} s")

    def _locally_idle(self) -> bool:
        return self.engine.idle() and self._transport.quiescent()

    def drain(self) -> None:
        """Termination detection over the control group (the drain of
        the JAX package's TCP transport): pump until this process is
        idle, then sum ``[sent, delivered]`` over the group, pumping the
        engine while the sum is in flight; done when the sums agree and
        equal the previous pass's."""
        prev = None
        while True:
            self._spin(self._locally_idle, "the local drain")
            counts = torch.tensor([self._transport.sent,
                                   self._transport.delivered],
                                  dtype=torch.int64)
            work = self._dist.all_reduce(counts, group=self.ctrl,
                                         async_op=True)
            self._spin(work.is_completed, "the drain's sum")
            work.wait()
            tot = tuple(int(v) for v in counts)
            if tot[0] == tot[1] and tot == prev:
                return
            prev = tot

    def barrier(self) -> None:
        """Every member reaches this point, with nothing in flight."""
        self._dist.barrier(group=self.ctrl)
        self.drain()

    # -- control plane ---------------------------------------------------

    def consensus(self, my_vote: int, proposer: int = 0) -> int:
        """One leaderless round over the processes: position
        ``proposer`` (any member) submits, every member judges with its
        own pinned vote, and the AND-merged decision broadcasts."""
        from rlo_tpu_torch.wire import Tag

        if not 0 <= proposer < self.world_size:
            raise ValueError(f"proposer {proposer} out of range "
                             f"[0, {self.world_size})")
        self._my_vote = int(my_vote)
        # every member's vote is pinned before any proposal can arrive
        self._dist.barrier(group=self.ctrl)
        eng = self.engine
        if self.pos == proposer:
            rc = [eng.submit_proposal(b"facade", pid=proposer)]

            def decided() -> bool:
                if rc[0] == -1:
                    rc[0] = eng.vote_my_proposal()
                return rc[0] != -1
            self._spin(decided, "the proposal")
            self.drain()
            return int(rc[0])
        got: List = []

        def picked() -> bool:
            msg = eng.pickup_next()
            if msg is not None:
                got.append(msg)
            return bool(got)
        self._spin(picked, "waiting for the decision")
        if got[0].type != int(Tag.IAR_DECISION):
            raise RuntimeError(f"rank {self.rank}: expected the decision, "
                               f"picked up {got[0]!r}")
        self.drain()
        return int(got[0].vote)

    # -- data plane --------------------------------------------------------

    def _local(self, local) -> torch.Tensor:
        if isinstance(local, torch.Tensor):
            return local.to(self.device)
        from rlo_tpu_torch.convert import from_numpy
        return from_numpy([np.asarray(local)], self.device)[0]

    def device_allreduce(self, local, op: str = "sum") -> torch.Tensor:
        """The data group's all-reduce of every process's tensor; returns
        this process's (replicated) result on its device."""
        from rlo_tpu_torch.ops import device_collectives as dc
        return dc.allreduce(self._local(local), self._axis, op=op,
                            algorithm="psum")

    # -- the bridge --------------------------------------------------------

    def propose_collective(self, local, *, proposer: int = 0,
                           judge: Optional[Callable] = None,
                           op: str = "sum"
                           ) -> Tuple[int, Optional[torch.Tensor]]:
        """Leaderless-consensus-gated cross-process collective.

        Process ``proposer`` (any process) initiates; every process runs
        ``judge(local)`` on its own tensor on its device and votes; the
        votes AND-merge up the engine tree as frames between processes;
        the decision broadcasts. Only on approval does the data group's
        all-reduce run. Returns (1, the reduced tensor) or (0, None).
        """
        t = self._local(local)
        vote = 1 if judge is None else int(bool(judge(t)))
        if not self.consensus(vote, proposer=proposer):
            return 0, None
        return 1, self.device_allreduce(t, op=op)

    def sub_context(self, members: Sequence[int]
                    ) -> Optional["MultiHostContext"]:
        """A context over a subset of the processes. Collective: every
        process calls it with the same ``members``, in the same order
        relative to other ``sub_context`` calls. Members get a context
        whose control plane is a member-only engine world (its own
        channel on the same sockets) and whose groups span the members;
        non-members get None and keep using this context."""
        ms = sorted(set(int(m) for m in members))
        bad = [m for m in ms if not 0 <= m < self.world_size]
        if bad or not ms:
            raise ValueError(f"members {ms} outside the world of "
                             f"{self.world_size}")
        comm = self._sub_next
        self._sub_next += 1
        ctrl = self._dist.new_group(ranks=ms, backend="gloo")
        data = self._dist.new_group(ranks=ms, backend=self.data_backend)
        if self.rank not in ms:
            return None
        return _SubContext(self, ms, comm, ctrl, data)

    def close(self) -> None:
        self.engine.cleanup()
        self._tcp.close()
        if self._owns_pg:
            self._dist.destroy_process_group()
            self._owns_pg = False


class _SubContext(MultiHostContext):
    """Member-scoped context: ``rank``/``pos`` is the member's position
    and ``world_size`` the member count; the engine runs on channel
    ``comm`` of the parent's sockets with ``members=``, and the groups
    span the members."""

    def __init__(self, parent: MultiHostContext, members: List[int],
                 comm: int, ctrl, data):
        self._dist = parent._dist
        self.timeout = parent.timeout
        self.device = parent.device
        self.data_backend = parent.data_backend
        self.members = members
        self.rank = self.pos = members.index(parent.rank)
        self.world_size = len(members)
        self.ctrl, self.data = ctrl, data
        self._tcp = parent._tcp
        self._owns_pg = False
        self._setup_plane(parent._tcp.transport(comm), members, data)

    def sub_context(self, members):
        raise NotImplementedError("nested sub-contexts are not supported")

    def close(self) -> None:
        # the sockets belong to the parent
        self.engine.cleanup()
