"""Engine snapshots of the port (``rlo_tpu_torch.utils.checkpoint``'s
engine-state helpers) against the JAX package's.

The counterparts of the Python engine-snapshot tests of
``tests/test_checkpoint.py`` (``TestEngineSnapshot``; the C engine's
have none), each run on both packages: the same scenario must give
JSON-equal snapshots, and a snapshot taken from either package's engines
must load onto the other's, which then keep working.
"""

import json

import pytest

import rlo_tpu.engine as ref_engine
import rlo_tpu.transport.loopback as ref_loopback
import rlo_tpu.utils.checkpoint as ref_ck
import rlo_tpu_torch.engine as port_engine
import rlo_tpu_torch.transport.loopback as port_loopback
import rlo_tpu_torch.utils.checkpoint as port_ck

PKGS = {"ref": (ref_engine, ref_loopback, ref_ck),
        "port": (port_engine, port_loopback, port_ck)}
CROSS = [("ref", "port"), ("port", "ref")]


def world(pkg, ws, **kw):
    eng, lb, _ = PKGS[pkg]
    w = lb.LoopbackWorld(ws)
    mgr = eng.EngineManager()
    return w, [eng.ProgressEngine(w.transport(r), manager=mgr, **kw)
               for r in range(ws)]


def counters_scenario(pkg):
    w, engines = world(pkg, 4)
    engines[1].bcast(b"hello")
    engines[3].bcast(b"again")
    PKGS[pkg][0].drain([w], engines)
    for e in engines:
        while e.pickup_next() is not None:
            pass
    snaps = [PKGS[pkg][2].engine_state_dict(e) for e in engines]
    for e in engines:
        e.cleanup()
    return snaps


def test_snapshots_json_equal():
    assert json.dumps(counters_scenario("port")) == \
        json.dumps(counters_scenario("ref"))


@pytest.mark.parametrize("src,dst", CROSS)
def test_snapshot_restore_counters_cross_package(src, dst, tmp_path):
    """Save with one package's helpers, load onto the other's fresh
    engines; the counters survive and the engines keep working."""
    w, engines = world(src, 4)
    engines[1].bcast(b"hello")
    engines[3].bcast(b"again")
    PKGS[src][0].drain([w], engines)
    for e in engines:
        while e.pickup_next() is not None:
            pass
    path = str(tmp_path / "engines.json")
    PKGS[src][2].save_engine_state(path, engines)
    snaps = PKGS[dst][2].load_engine_state_file(path)
    for e in engines:
        e.cleanup()

    w2, fresh = world(dst, 4)
    for e, s in zip(fresh, snaps):
        PKGS[dst][2].load_engine_state(e, s)
    assert [PKGS[dst][2].engine_state_dict(e) for e in fresh] == snaps
    assert fresh[1].sent_bcast_cnt == 1
    assert fresh[3].sent_bcast_cnt == 1
    assert fresh[0].recved_bcast_cnt == 2
    fresh[2].bcast(b"after-resume")
    PKGS[dst][0].drain([w2], fresh)
    assert fresh[2].sent_bcast_cnt == 1
    assert fresh[0].recved_bcast_cnt == 3
    for e in fresh:
        e.cleanup()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_snapshot_rejects_busy_engine(pkg):
    _, engines = world(pkg, 2)
    engines[0].queue_wait.append(object())  # an in-flight send
    with pytest.raises(RuntimeError, match="drain"):
        PKGS[pkg][2].engine_state_dict(engines[0])
    engines[0].queue_wait.clear()
    for e in engines:
        e.cleanup()


@pytest.mark.parametrize("src,dst", CROSS)
def test_snapshot_carries_pickup_queue_cross_package(src, dst):
    w, engines = world(src, 3)
    engines[0].bcast(b"undelivered-payload")
    PKGS[src][0].drain([w], engines)
    snap = PKGS[src][2].engine_state_dict(engines[2])  # not picked up
    for e in engines:
        e.cleanup()
    eng, lb, ck = PKGS[dst]
    fresh = eng.ProgressEngine(lb.LoopbackWorld(3).transport(2),
                               manager=eng.EngineManager())
    ck.load_engine_state(fresh, json.loads(json.dumps(snap)))
    msg = fresh.pickup_next()
    assert msg is not None and msg.data == b"undelivered-payload"
    assert msg.origin == 0
    assert fresh.pickup_next() is None
    fresh.cleanup()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_snapshot_rejects_mid_consensus(pkg):
    """An own proposal awaiting votes cannot be checkpointed: split
    managers so the proposer's sends complete while the peers have not
    judged yet."""
    eng, lb, ck = PKGS[pkg]
    w = lb.LoopbackWorld(4)
    mgr_p, mgr_o = eng.EngineManager(), eng.EngineManager()
    proposer = eng.ProgressEngine(w.transport(0), manager=mgr_p)
    others = [eng.ProgressEngine(w.transport(r), manager=mgr_o)
              for r in range(1, 4)]
    rc = proposer.submit_proposal(b"p", pid=0)
    assert rc == -1 and proposer.idle()
    with pytest.raises(RuntimeError, match="mid-consensus"):
        ck.engine_state_dict(proposer)
    for _ in range(1000):
        mgr_o.progress_all()
        mgr_p.progress_all()
        if proposer.vote_my_proposal() != -1:
            break
    assert proposer.vote_my_proposal() == 1
    eng.drain([w], [proposer] + others)
    for e in [proposer] + others:
        e.cleanup()


@pytest.mark.parametrize("src,dst", CROSS)
def test_snapshot_rank_mismatch(src, dst):
    _, a = world(src, 2)
    _, b = world(dst, 2)
    snap = PKGS[src][2].engine_state_dict(a[0])
    with pytest.raises(ValueError, match="rank"):
        PKGS[dst][2].load_engine_state(b[1], snap)
    for e in a + b:
        e.cleanup()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def arq_snapshots(pkg):
    """A consensus round and broadcasts under ARQ with one lost frame on
    an injected clock: the snapshot then holds link seqs, receive
    windows, the seen-broadcast map and the recent-frame log."""
    eng, lb, ck = PKGS[pkg]
    clock = FakeClock()
    w = lb.LoopbackWorld(4)
    mgr = eng.EngineManager()
    engines = [eng.ProgressEngine(w.transport(r), manager=mgr, clock=clock,
                                  arq_rto=1.0) for r in range(4)]
    w.drop_next(0, 2, 1)
    engines[0].bcast(b"retransmitted")
    engines[1].submit_proposal(b"q", pid=1)
    for _ in range(200):
        clock.t += 0.25
        mgr.progress_all()
    for e in engines:
        while e.pickup_next() is not None:
            pass
    snaps = [ck.engine_state_dict(e) for e in engines]
    for e in engines:
        e.cleanup()
    return snaps


def test_arq_and_dedup_state_equal_and_cross_load():
    want = arq_snapshots("ref")
    got = arq_snapshots("port")
    assert json.dumps(got) == json.dumps(want)
    assert any(s["arq_tx_seq"] for s in got)
    assert any(s["seen_bcast"] for s in got)
    for src, dst in CROSS:
        snaps = arq_snapshots(src)
        _, fresh = world(dst, 4, arq_rto=1.0)
        for e, s in zip(fresh, snaps):
            PKGS[dst][2].load_engine_state(e, s)
        assert json.dumps([PKGS[dst][2].engine_state_dict(e)
                           for e in fresh]) == json.dumps(snaps)
        for e in fresh:
            e.cleanup()
