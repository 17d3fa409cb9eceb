"""Engine control plane, device data plane: the consensus-gated bridge.

The port of ``rlo_tpu/bridge.py``. The reference library's point is
leaderless agreement about what to do next: any rank proposes, every
rank judges, the votes AND-merge up the tree and the decision
broadcasts (``RLO_submit_proposal``, rootless_ops.c:876; judgement :698;
action :842). Here that split is literal:

  - **control plane**: the port's copy of the native C engines
    (``rlo_tpu_torch.native``, through ctypes: ``NativeBackend`` and
    ``native.bindings.run_judged_proposal``) run the rootless broadcast
    and the IAR consensus, as the JAX package's bridge runs its C core;
  - **data plane**: ``TorchBackend``'s collectives over a ``LocalMesh``
    on the card (K1 in the ring, halving and doubling schedules).

``HybridBackend.propose_collective`` is the proposal/judgement/action
pattern applied to tensor work: the proposal describes the collective
(op, reduction, shape, dtype); every rank's judgement checks it against
its own tensor, first on the host (shape and dtype) and then, with a
``device_judge``, on that rank's own device tensor; any NO vetoes the
round before any device collective runs; the approved decision's action
is the collective itself.

The JAX package keeps a compile cache of judge wrappers
(``JudgeWrapperCache``) because its per-shard judge is a compiled
``shard_map`` program; in eager PyTorch a judge is called on each rank's
tensor as it is, so there is nothing to cache and the port has no such
cache.
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rlo_tpu_torch.convert import from_numpy


def _dtype_name(x) -> str:
    """The dtype's name as numpy spells it (``float32``), for numpy
    arrays and tensors alike."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _describe(op: str, reduce_op: str, x) -> bytes:
    """The proposal payload: the same JSON the JAX package's bridge
    sends for the same array."""
    return json.dumps({"op": op, "reduce": reduce_op,
                       "shape": list(x.shape),
                       "dtype": _dtype_name(x)}).encode()


def run_judged_proposal(world_size: int, payload: bytes, proposer: int,
                        judge_for: Optional[Callable] = None,
                        action_cb: Optional[Callable] = None) -> int:
    """One complete IAR round on a fresh world of the port's Python
    engines (``rlo_tpu_torch.engine``): rank ``proposer`` submits
    ``payload``, every rank judges it with ``judge_for(rank)`` (None
    approves), and the approving passive ranks fire ``action_cb(rank,
    payload)``; returns the decision (0/1). ``HybridBackend`` gates on
    the C engines' round (``native.bindings.run_judged_proposal``); this
    one stays so that the tests can hold the C core's round against the
    Python engines' on the same proposers and vetoes."""
    from rlo_tpu_torch.engine import EngineManager, ProgressEngine, drain
    from rlo_tpu_torch.transport.loopback import LoopbackWorld

    if not 0 <= proposer < world_size:
        raise ValueError(f"proposer {proposer} out of range "
                         f"[0, {world_size})")
    world = LoopbackWorld(world_size)
    manager = EngineManager()
    engines = [ProgressEngine(
        world.transport(r),
        judge_cb=(judge_for(r) if judge_for is not None else None),
        action_cb=(None if action_cb is None else
                   (lambda p, ctx, r=r: action_cb(r, p))),
        manager=manager) for r in range(world_size)]
    try:
        rc = engines[proposer].submit_proposal(payload, pid=proposer)
        if rc == -1:
            drain([world], engines)
            rc = engines[proposer].vote_my_proposal()
        if rc not in (0, 1):
            raise RuntimeError(f"consensus incomplete ({rc})")
        drain([world], engines)
        return int(rc)
    finally:
        for e in engines:
            e.cleanup()


class HybridBackend:
    """The port's C engines decide; the card executes.

    ``bcast``/``consensus`` run on ``NativeBackend`` (the C core);
    ``allreduce``/``reduce_scatter``/``all_gather``/``all_to_all``/
    ``barrier`` run on ``TorchBackend``'s ``LocalMesh`` on ``device``
    (None: the card). ``propose_collective`` chains them: an IAR round
    gates the collective. Per-rank data is a list of numpy arrays or of
    tensors, and results come back as the same kind.
    """

    name = "hybrid"

    def __init__(self, world_size: int = 8, device=None):
        from rlo_tpu_torch.backend import NativeBackend, TorchBackend

        self._torch = TorchBackend(world_size=world_size, device=device)
        self.world_size = world_size
        self.device = self._torch.device
        self.mesh = self._torch.mesh
        self._native = NativeBackend(world_size=world_size)
        self._consensus = None

    # ---- control plane (the C engines) ----
    def bcast(self, origin: int, x) -> list:
        return self._native.bcast(origin, x)

    def consensus(self, votes: Sequence[int], proposer: int = 0) -> int:
        return self._native.consensus(votes, proposer=proposer)

    # ---- data plane (the card) ----
    def allreduce(self, xs, op: str = "sum", algorithm: str = "auto",
                  pipeline_chunks: Optional[int] = None) -> list:
        return self._torch.allreduce(xs, op=op, algorithm=algorithm,
                                     pipeline_chunks=pipeline_chunks)

    def reduce_scatter(self, xs, op: str = "sum") -> list:
        return self._torch.reduce_scatter(xs, op=op)

    def all_gather(self, xs) -> list:
        return self._torch.all_gather(xs)

    def all_to_all(self, xss, algorithm: str = "xla") -> list:
        return self._torch.all_to_all(xss, algorithm=algorithm)

    def barrier(self) -> None:
        self._torch.barrier()

    # ---- the bridge ----
    def _device_votes(self, xs, device_judge) -> np.ndarray:
        """Each rank's verdict ``device_judge(tensor) -> {0,1}`` on its
        own tensor on the device (``TorchConsensus.shard_votes``)."""
        from rlo_tpu_torch.parallel.consensus import TorchConsensus

        if self._consensus is None:
            self._consensus = TorchConsensus(self.mesh, "x")
        blocks = [x if isinstance(x, torch.Tensor)
                  else from_numpy([np.asarray(x)], self.device)[0]
                  for x in xs]
        return self._consensus.shard_votes(blocks, device_judge)

    def propose_collective(self, op: str, xs, proposer: int = 0,
                           reduce_op: str = "sum", device_judge=None,
                           algorithm: str = "auto"):
        """Leaderless-consensus-gated collective.

        Rank ``proposer`` (any rank) proposes running ``op``
        (allreduce, reduce_scatter, all_gather) on the per-rank ``xs``;
        every rank judges the descriptor against its own tensor: shape
        and dtype must agree, on the host, before any device work. With
        ``device_judge`` (``tensor -> {0,1}``) each rank's vote also
        needs its own device tensor to pass, so one rank's non-finite
        shard vetoes. The votes go through an IAR round on a fresh world
        of the C engines (``native.bindings.run_judged_proposal``, whose
        events go to the C core's trace ring); only on approval does the
        collective run (``algorithm`` picks the allreduce schedule).

        Returns (1, per-rank outputs) on approval, (0, None) on a veto.
        """
        from rlo_tpu_torch.native.bindings import run_judged_proposal \
            as native_round

        if op not in ("allreduce", "reduce_scatter", "all_gather"):
            raise ValueError(f"unknown collective {op!r}")
        if not 0 <= proposer < self.world_size:
            raise ValueError(f"proposer {proposer} out of range "
                             f"[0, {self.world_size})")
        xs = list(xs)
        if len(xs) != self.world_size:
            raise ValueError(f"need one array per rank ({self.world_size}),"
                             f" got {len(xs)}")
        xs = [x if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in xs]
        payload = _describe(op, reduce_op, xs[proposer])
        # structural judgement first, on the host: a shape or dtype
        # mismatch vetoes before any device work
        want = json.loads(payload.decode())
        structural = [1 if (want["shape"] == list(x.shape)
                            and want["dtype"] == _dtype_name(x)) else 0
                      for x in xs]
        dev_votes = None
        if device_judge is not None and all(structural):
            dev_votes = self._device_votes(xs, device_judge)

        def judge_for(rank: int):
            def judge(prop: bytes, _ctx) -> int:
                ok = bool(structural[rank])
                if ok and dev_votes is not None:
                    ok = bool(dev_votes[rank])
                return 1 if ok else 0
            return judge

        approved = []  # the action fires on every approving rank (:842)
        rc = native_round(
            self.world_size, payload, proposer, judge_for=judge_for,
            action_cb=lambda rank, p: approved.append(rank))
        if rc == 0:
            return 0, None
        # the action fires on every passive rank (the proposer learns the
        # decision from its own vote merge, reference :842 vs :777)
        want_ranks = [r for r in range(self.world_size) if r != proposer]
        if sorted(approved) != want_ranks:
            raise RuntimeError(f"approval action fired on {sorted(approved)}"
                               f", expected {want_ranks}")
        if op == "allreduce":
            return 1, self.allreduce(xs, op=reduce_op, algorithm=algorithm)
        if op == "reduce_scatter":
            return 1, self.reduce_scatter(xs, op=reduce_op)
        return 1, self.all_gather(xs)

    def close(self) -> None:
        self._native.close()
        self._torch.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
