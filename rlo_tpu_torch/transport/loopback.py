"""In-process loopback transport: N ranks in one process.

The port's own copy of ``rlo_tpu/transport/loopback.py``: the seeded
``random.Random`` is drawn in the same order, so latency and loss fuzz
replay identically in both packages.

The reference has no equivalent — its tests need ``mpirun`` even on one host
(SURVEY.md §4 calls this gap out). The loopback world lets every state
machine (engine, bcast, consensus, collectives) run deterministically in a
single process, optionally with seeded cross-pair reordering and delivery
latency to shake out ordering assumptions the way real networks would.

Guarantees (matching MPI): per-(src, dst) FIFO order — even with latency
injection — and reliable delivery. Cross-pair order is unspecified and is
exactly what the fuzzing knobs perturb.

Fault injection (the chaos-soak levers, docs/DESIGN.md §6): ``kill_rank``
(crash-stop), ``drop_next`` (targeted loss), ``dup_next`` (network
duplication), ``set_burst_loss`` (seeded correlated loss), plus the seeded
``latency`` reordering. Duplicated frames keep per-channel FIFO (both
copies deliver back to back).
"""

from __future__ import annotations

import random
import threading
from collections import deque
from typing import List, Optional, Tuple

from rlo_tpu_torch.transport.base import (COMPLETED_SEND, FAILED_SEND, SendHandle,
                                    Transport, register_transport)


class _PendingSend(SendHandle):
    def __init__(self):
        self.delivered = False

    def done(self) -> bool:
        return self.delivered


class LoopbackTransport(Transport):
    def __init__(self, world: "LoopbackWorld", rank: int):
        self.world = world
        self.rank = rank
        self.world_size = world.world_size

    def isend(self, dst: int, tag: int, data: bytes) -> SendHandle:
        return self.world._send(self.rank, dst, tag, data)

    def poll(self) -> Optional[Tuple[int, int, bytes]]:
        return self.world._poll(self.rank)


@register_transport("loopback")
class LoopbackWorld:
    """Shared mailbox array for ``world_size`` in-process ranks.

    ``latency``: when > 0, each message is held for a seeded-random number of
    ticks in [0, latency]; a tick elapses every time any rank polls. Per-pair
    FIFO is preserved by keying held messages on (src, dst) channels.
    """

    def __init__(self, world_size: int, latency: int = 0,
                 seed: Optional[int] = None):
        if world_size < 2:
            # reference rejects this at bcomm_init (rootless_ops.c:1464)
            raise ValueError(f"world_size must be >= 2, got {world_size}")
        self.world_size = world_size
        self.latency = latency
        self.rng = random.Random(seed)
        self.lock = threading.RLock()
        self.dead: set = set()      # killed ranks (fault injection)
        self._drops: dict = {}      # (src, dst) -> #messages to drop
        self._dups: dict = {}       # (src, dst) -> #messages to duplicate
        self.dropped_cnt = 0
        self.duplicated_cnt = 0
        # seeded burst loss: each message starts a loss burst with
        # probability burst_loss_p, dropping it and the next
        # burst_loss_len - 1 messages on its (src, dst) channel
        self.burst_loss_p = 0.0
        self.burst_loss_len = 1
        self.inboxes: List[deque] = [deque() for _ in range(world_size)]
        # per-(src, dst) FIFO channels of held messages:
        # (deliver_at_tick, tag, data, handle). Only channel heads can become
        # due, which gives FIFO for free and keeps delivery O(channels).
        self.channels: dict = {}
        self.tick = 0
        self.sent_cnt = 0
        self.delivered_cnt = 0
        self.transports = [LoopbackTransport(self, r)
                           for r in range(world_size)]

    def transport(self, rank: int) -> LoopbackTransport:
        return self.transports[rank]

    # -- internal ----------------------------------------------------------
    def _send(self, src: int, dst: int, tag: int, data: bytes) -> SendHandle:
        if not 0 <= dst < self.world_size:
            raise ValueError(f"bad destination rank {dst}")
        with self.lock:
            if src in self.dead or dst in self.dead:
                # a dead host's packets never leave it; packets to a dead
                # host vanish. The handle completes failed so the sender's
                # queues drain instead of hanging.
                return FAILED_SEND
            pending = self._drops.get((src, dst), 0)
            if pending:  # message-loss injection
                self._drops[(src, dst)] = pending - 1
                self.dropped_cnt += 1
                return FAILED_SEND
            if self.burst_loss_p and self.rng.random() < self.burst_loss_p:
                # seeded burst loss: this message and the next
                # burst_loss_len - 1 on this channel vanish
                if self.burst_loss_len > 1:
                    self._drops[(src, dst)] = (self._drops.get((src, dst), 0)
                                               + self.burst_loss_len - 1)
                self.dropped_cnt += 1
                return FAILED_SEND
            copies = 1
            dups = self._dups.get((src, dst), 0)
            if dups:  # duplication injection: deliver twice
                self._dups[(src, dst)] = dups - 1
                self.duplicated_cnt += 1
                copies = 2
            self.sent_cnt += 1
            if self.latency <= 0:
                for _ in range(copies):
                    self.inboxes[dst].append((src, tag, bytes(data)))
                    self.delivered_cnt += 1
                return COMPLETED_SEND
            h = _PendingSend()
            chan = self.channels.setdefault((src, dst), deque())
            deliver_at = self.tick + self.rng.randint(0, self.latency)
            for _ in range(copies):
                chan.append((deliver_at, tag, bytes(data), h))
            return h

    def _deliver_due(self) -> None:
        if not self.channels:
            return
        emptied = []
        for chan, q in self.channels.items():
            src, dst = chan
            while q and q[0][0] <= self.tick:
                _, tag, data, h = q.popleft()
                self.inboxes[dst].append((src, tag, data))
                self.delivered_cnt += 1
                h.delivered = True
            if not q:
                emptied.append(chan)
        for chan in emptied:
            del self.channels[chan]

    def _poll(self, rank: int) -> Optional[Tuple[int, int, bytes]]:
        with self.lock:
            if rank in self.dead:
                return None
            self.tick += 1
            self._deliver_due()
            if self.inboxes[rank]:
                return self.inboxes[rank].popleft()
            return None

    # -- fault injection ---------------------------------------------------
    def kill_rank(self, rank: int) -> None:
        """Simulate a rank's process dying: its inbox is discarded, frames
        in flight to or from it are dropped (their handles complete
        ``failed``), future traffic involving it is blackholed, and its
        polls return nothing. The reference has no failure handling at all
        (SURVEY.md §5: RLO_FAILED is never assigned) — this is the
        injection side of the net-new failure-detection subsystem."""
        if not 0 <= rank < self.world_size:
            raise ValueError(f"bad rank {rank}")
        with self.lock:
            self.dead.add(rank)
            self.inboxes[rank].clear()
            for chan in [c for c in self.channels
                         if c[0] == rank or c[1] == rank]:
                for _, _, _, h in self.channels[chan]:
                    h.delivered = True
                    h.failed = True
                del self.channels[chan]

    def drop_next(self, src: int, dst: int, count: int = 1) -> None:
        """Silently drop the next ``count`` messages sent src -> dst."""
        with self.lock:
            self._drops[(src, dst)] = self._drops.get((src, dst), 0) + count

    def dup_next(self, src: int, dst: int, count: int = 1) -> None:
        """Deliver the next ``count`` messages src -> dst TWICE (network
        duplication injection — the receive-side idempotence probe for
        the ARQ dedup layer)."""
        with self.lock:
            self._dups[(src, dst)] = self._dups.get((src, dst), 0) + count

    def inject(self, src: int, dst: int, tag: int, raw: bytes) -> None:
        """Test support: deliver one raw frame as if ``src`` sent it —
        the duplicate/stale-frame scenario hook (mirror of the C
        world's rlo_world_inject). Bypasses latency and fault
        injection; ``src`` may be a dead rank (that is the point: a
        dead incarnation's stale frame arriving late)."""
        if not 0 <= dst < self.world_size or dst in self.dead:
            raise ValueError(f"bad destination rank {dst}")
        with self.lock:
            self.inboxes[dst].append((src, tag, bytes(raw)))
            self.delivered_cnt += 1

    def set_burst_loss(self, p: float, burst_len: int = 3) -> None:
        """Seeded random burst loss on every channel: each sent message
        starts a loss burst with probability ``p``, silently dropping
        it and the next ``burst_len - 1`` messages on its (src, dst)
        channel — the correlated-loss pattern (switch buffer overrun,
        link flap) that defeats naive single-retry schemes."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"loss probability must be in [0, 1], got {p}")
        if burst_len < 1:
            raise ValueError(f"burst_len must be >= 1, got {burst_len}")
        with self.lock:
            self.burst_loss_p = float(p)
            self.burst_loss_len = int(burst_len)

    # -- observability -----------------------------------------------------
    def quiescent(self) -> bool:
        """True when nothing is in flight or queued anywhere — the loopback
        analogue of the reference's termination-detection drain
        (rootless_ops.c:1606-1647)."""
        with self.lock:
            return not self.channels and all(
                not box for box in self.inboxes)
