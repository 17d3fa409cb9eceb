"""The port's TCP socket-mesh transport (``rlo_tpu_torch.transport.tcp``),
ranks as threads of one process over an in-process ``HashStore``.

Oracles: per-destination FIFO order across many frames and two channels;
32 KB frames (the reference's frame size) intact; a frame larger than a
shrunk ``SO_SNDBUF`` goes out in partial writes, its handle not done
until the receiver has read enough, and the bytes arrive intact; ``poll``
never blocks; a closed peer makes sends complete failed; and the port's
engines over TCP reach the same pickups and decisions as the JAX
package's engines over its loopback world.
"""

import threading
import time

import pytest
import torch.distributed as dist

import rlo_tpu.engine as ref_engine
import rlo_tpu.transport.loopback as ref_loopback
from rlo_tpu_torch.engine import EngineManager, ProgressEngine
from rlo_tpu_torch.transport.tcp import HDR, TcpWorld

DEADLINE_S = 20.0


def mesh(ws, **kw):
    """One TcpWorld a rank, set up from ws threads (set-up blocks on
    connect/accept); the worlds are then driven from this thread."""
    store = dist.HashStore()
    ranks = list(range(ws))
    worlds, errs = {}, []

    def make(r):
        try:
            worlds[r] = TcpWorld(r, ws, store, **kw)
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)
    ts = [threading.Thread(target=make, args=(r,)) for r in ranks]
    for t in ts:
        t.start()
    for t in ts:
        t.join(DEADLINE_S)
    assert not errs and len(worlds) == len(ranks), errs
    return worlds


def pump_until(transports, cond):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        for t in transports:
            t.world._pump()
        assert time.monotonic() < deadline, "transport stalled"


def drain_inbox(t):
    out = []
    while (m := t.poll()) is not None:
        out.append(m)
    return out


def receive(sender, receiver, n):
    """Pump the sender until the receiver has polled ``n`` frames."""
    got = []

    def enough():
        got.extend(drain_inbox(receiver))
        return len(got) >= n
    pump_until([sender], enough)
    return got


def test_header_layout():
    assert HDR.size == 24
    assert HDR.pack(1, 2, 3, 0, 5)[:4] == (1).to_bytes(4, "little")


def test_per_destination_order_and_channels():
    worlds = mesh(4)
    try:
        a, b = worlds[0].transport(0), worlds[0].transport(9)
        sends = []
        for i in range(200):
            for dst in (1, 2, 3):
                sends.append(a.isend(dst, i % 7, f"{dst}:{i}".encode()))
                b.isend(dst, 1, f"c9:{i}".encode())
        got = {r: [] for r in (1, 2, 3)}
        got9 = {r: [] for r in (1, 2, 3)}

        def done():
            for r in (1, 2, 3):
                got[r] += drain_inbox(worlds[r].transport(0))
                got9[r] += drain_inbox(worlds[r].transport(9))
            return all(len(got[r]) == 200 and len(got9[r]) == 200
                       for r in (1, 2, 3))
        pump_until([worlds[0].transport()], done)
        for r in (1, 2, 3):
            assert [d for _, _, d in got[r]] == \
                [f"{r}:{i}".encode() for i in range(200)]
            assert [t for _, t, _ in got[r]] == [i % 7 for i in range(200)]
            assert all(s == 0 for s, _, _ in got[r])
            assert [d for _, _, d in got9[r]] == \
                [f"c9:{i}".encode() for i in range(200)]
        assert all(h.done() and not h.failed for h in sends)
        assert a.sent == 600 and sum(
            worlds[r].transport(0).delivered for r in (1, 2, 3)) == 600
    finally:
        for w in worlds.values():
            w.close()


def test_32kb_frames_intact():
    worlds = mesh(3)
    try:
        frames = [bytes([i]) * 32768 for i in range(16)]
        for f in frames:
            worlds[2].transport().isend(0, 3, f)
        got = receive(worlds[2].transport(), worlds[0].transport(), 16)
        assert [d for _, _, d in got] == frames
        assert all(s == 2 and t == 3 for s, t, _ in got)
    finally:
        for w in worlds.values():
            w.close()


def test_partial_writes_under_small_sndbuf():
    worlds = mesh(2, sndbuf=4096)
    try:
        tx, rx = worlds[0].transport(), worlds[1].transport()
        big = bytes(range(256)) * 4096  # 1 MiB: far past the send buffer
        hs = [tx.isend(1, 5, big + bytes([i])) for i in range(3)]
        # the kernel cannot take 3 MiB while nobody reads: partial writes
        assert not hs[-1].done()
        assert worlds[0]._outq[1]
        got = []
        deadline = time.monotonic() + DEADLINE_S
        while len(got) < 3:
            tx.poll()
            m = rx.poll()
            if m is not None:
                got.append(m)
            assert time.monotonic() < deadline
        assert [d for _, _, d in got] == [big + bytes([i]) for i in range(3)]
        pump_until([tx], lambda: all(h.done() for h in hs))
        assert not worlds[0]._outq[1]
    finally:
        for w in worlds.values():
            w.close()


def test_poll_never_blocks():
    worlds = mesh(2)
    try:
        t = worlds[1].transport()
        t0 = time.perf_counter()
        for _ in range(1000):
            assert t.poll() is None
        assert time.perf_counter() - t0 < 2.0
    finally:
        for w in worlds.values():
            w.close()


def test_closed_peer_fails_sends():
    worlds = mesh(3)
    try:
        worlds[2].close()
        t = worlds[0].transport()
        pump_until([t], lambda: 2 in worlds[0].failed)
        h = t.isend(2, 1, b"to the dead")
        assert h.done() and h.failed
        ok = t.isend(1, 1, b"alive")
        pump_until([t], lambda: ok.done())
        assert worlds[1].transport().poll() == (0, 1, b"alive")
        with pytest.raises(ValueError):
            t.isend(0, 1, b"self")
    finally:
        for w in worlds.values():
            w.close()


@pytest.mark.parametrize("ws,proposer", [(3, 1), (5, 3)])
def test_engines_over_tcp_match_reference_on_loopback(ws, proposer):
    """The port's engines over TCP: a broadcast from every rank and an
    approve and a veto round from ``proposer`` give the pickups and
    decisions of the JAX package's engines over its loopback world."""
    def scenario(engines, progress, idle):
        votes = [1] * ws
        for r, e in enumerate(engines):
            e.set_app(judge_cb=lambda p, ctx, r=r: votes[r])
        for r, e in enumerate(engines):
            e.bcast(f"tcp-{r}".encode())
        progress(idle)
        decisions = []
        for veto in (None, (proposer + 1) % ws):
            if veto is not None:
                votes[veto] = 0
            rc = engines[proposer].submit_proposal(b"p", pid=proposer)
            progress(lambda: engines[proposer].vote_my_proposal() != -1)
            decisions.append(engines[proposer].vote_my_proposal())
            progress(idle)
        pickups = []
        for e in engines:
            got = []
            while (m := e.pickup_next()) is not None:
                got.append((int(m.type), m.origin, m.pid, m.vote, m.data))
            pickups.append(got)
        return decisions, pickups, rc

    world = ref_loopback.LoopbackWorld(ws)
    rmgr = ref_engine.EngineManager()
    ref = [ref_engine.ProgressEngine(world.transport(r), manager=rmgr)
           for r in range(ws)]

    def ref_progress(cond):
        for _ in range(100_000):
            rmgr.progress_all()
            if cond():
                return
        raise AssertionError("reference world stalled")
    want = scenario(ref, ref_progress, lambda: world.quiescent() and all(
        e.idle() for e in ref))

    worlds = mesh(ws)
    try:
        mgr = EngineManager()
        ts = [worlds[r].transport() for r in range(ws)]
        port = [ProgressEngine(ts[r], manager=mgr) for r in range(ws)]

        def progress(cond):
            deadline = time.monotonic() + DEADLINE_S
            while not cond():
                mgr.progress_all()
                assert time.monotonic() < deadline, "tcp world stalled"

        def idle():
            return (all(e.idle() for e in port)
                    and all(t.quiescent() for t in ts)
                    and sum(t.sent for t in ts)
                    == sum(t.delivered for t in ts))
        got = scenario(port, progress, idle)
    finally:
        for w in worlds.values():
            w.close()
    assert got[0] == want[0] == [1, 0]
    assert got[1] == want[1]
