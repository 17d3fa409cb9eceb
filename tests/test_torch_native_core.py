"""The port's copy of the C core and its bindings, on the CPU.

Three layers of oracles, as for the JAX package's core:
  1. its topology, frame, telemetry and span helpers equal the JAX
     package's bindings and the port's own Python codecs
     (``rlo_tpu_torch.topology``, ``wire``) byte for byte;
  2. the port's C engines deliver and decide as the port's Python
     engines do (a bcast from every rank, IAR rounds with and without a
     veto);
  3. the two libraries live side by side in one process without sharing
     a global: a trace drained from one never holds the other's events.
Also: a judge that raises inside the C core surfaces as an error; the
build writes only under ``native/_build``, under its own names.
"""

import numpy as np
import pytest

from rlo_tpu.native import bindings as rb
from rlo_tpu_torch import topology, wire
from rlo_tpu_torch.native import bindings as nb
from rlo_tpu_torch.native import build

WORLD_SIZES = [2, 3, 5, 8, 11, 16]


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_topology_helpers(ws):
    for r in range(ws):
        assert nb.level(ws, r) == rb.level(ws, r) == topology.level(ws, r)
        assert nb.last_wall(ws, r) == topology.last_wall(ws, r)
        assert nb.send_list(ws, r) == rb.send_list(ws, r) == \
            topology.send_list(ws, r)
        assert nb.initiator_targets(ws, r) == \
            topology.initiator_targets(ws, r)
        for origin in range(ws):
            for to in range(ws):
                assert nb.check_passed_origin(ws, r, origin, to) == \
                    topology.check_passed_origin(ws, r, origin, to)
            for frm in range(-1, ws):
                assert nb.fwd_targets(ws, r, origin, frm) == \
                    rb.fwd_targets(ws, r, origin, frm) == \
                    topology.fwd_targets(ws, r, origin, frm)
                assert nb.fwd_send_cnt(ws, r, origin, frm) == \
                    topology.fwd_send_cnt(ws, r, origin, frm)


@pytest.mark.parametrize("origin,pid,vote,payload,seq", [
    (0, -1, -1, b"", -1), (3, 7, 1, b"hello", 37),
    (31, -2, 0, bytes(range(256)) * 4, 5)])
def test_frames(origin, pid, vote, payload, seq):
    got = nb.frame_roundtrip(origin, pid, vote, payload, seq=seq)
    assert got == rb.frame_roundtrip(origin, pid, vote, payload, seq=seq)
    o, p, v, data, raw, s = got
    assert (o, p, v, data, s) == (origin, pid, vote, payload, seq)
    assert raw == wire.Frame(origin, pid, vote, payload, seq=seq).encode()
    assert wire.HEADER_SIZE == len(raw) - len(payload)
    for epoch in (0, 3, -1):
        stamped = nb.frame_set_epoch(raw, epoch)
        assert stamped == wire.restamp_epoch(raw, epoch)
        assert nb.frame_epoch(stamped) == wire.Frame.decode(stamped).epoch


def test_telemetry_digests():
    keys = wire.TELEM_KEYS
    assert nb.telem_key_names() == tuple(keys) == rb.telem_key_names()
    rng = np.random.default_rng(0)
    prev = None
    for seq in range(6):
        vals = [int(v) for v in rng.integers(-2 ** 40, 2 ** 40, len(keys))]
        if seq % 2 and prev is not None:
            vals[: len(keys) // 2] = prev[: len(keys) // 2]
        for full in (False, True):
            raw = nb.telem_encode(4, 2, seq, vals, prev=prev, full=full)
            assert raw == wire.encode_telem(4, 2, seq, vals, prev=prev,
                                            full=full)
            assert raw == rb.telem_encode(4, 2, seq, vals, prev=prev,
                                          full=full)
            assert nb.telem_decode(raw) == wire.decode_telem(raw)
        prev = vals


@pytest.mark.parametrize("gateway,seq,stage,t_usec,flags", [
    (0, 0, 0, 0, 1), (7, 123456, 3, 2 ** 40 + 5, 0),
    (-1, 2 ** 31 - 1, 255, 2 ** 64 - 1, 255)])
def test_span_contexts(gateway, seq, stage, t_usec, flags):
    raw = nb.span_encode(gateway, seq, stage, t_usec, flags)
    assert len(raw) == wire.SPAN_CTX_SIZE
    assert raw == wire.encode_span_ctx(gateway, seq, stage, t_usec, flags)
    assert raw == rb.span_encode(gateway, seq, stage, t_usec, flags)
    assert nb.span_decode(raw) == wire.decode_span_ctx(raw)
    assert nb.span_decode(b"\0" * wire.SPAN_CTX_SIZE) is None


def _pickups(eng):
    out = []
    while (m := eng.pickup_next()) is not None:
        out.append((m.type, m.origin, m.pid, m.vote, m.data))
    return out


@pytest.mark.parametrize("ws,latency,seed", [(2, 0, 1), (5, 0, 1),
                                             (8, 3, 42), (11, 2, 7)])
def test_bcast_matches_the_python_engines(ws, latency, seed):
    from rlo_tpu_torch.engine import EngineManager, ProgressEngine, drain
    from rlo_tpu_torch.transport.loopback import LoopbackWorld

    world = LoopbackWorld(ws, latency, seed)
    mgr = EngineManager()
    pes = [ProgressEngine(world.transport(r), manager=mgr)
           for r in range(ws)]
    for r in range(ws):
        pes[r].bcast(f"x-{r}".encode() * (r + 1))
    drain([world], pes)
    py = [sorted((t, o, d) for t, o, _, _, d in _pickups(e)) for e in pes]
    with nb.NativeWorld(ws, latency=latency, seed=seed) as cw:
        nes = [nb.NativeEngine(cw, r) for r in range(ws)]
        for r in range(ws):
            nes[r].bcast(f"x-{r}".encode() * (r + 1))
        cw.drain()
        c = [sorted((t, o, d) for t, o, _, _, d in _pickups(e))
             for e in nes]
        assert [e.sent_bcast_cnt for e in nes] == [1] * ws
    assert c == py
    assert all(len(got) == ws - 1 for got in c)


@pytest.mark.parametrize("ws", [2, 3, 5, 8])
@pytest.mark.parametrize("veto", [None, 0, "last"])
def test_iar_round_matches_the_python_engines(ws, veto):
    from rlo_tpu_torch.bridge import run_judged_proposal as py_round

    veto = ws - 1 if veto == "last" else veto
    for proposer in sorted({0, ws // 2, ws - 1}):
        acted = {"py": [], "c": []}

        def judge_for(rank):
            return lambda payload, ctx: int(rank != veto and
                                            payload == b"prop")
        want = py_round(ws, b"prop", proposer, judge_for,
                        lambda r, p: acted["py"].append((r, p)))
        got = nb.run_judged_proposal(ws, b"prop", proposer, judge_for,
                                     lambda r, p: acted["c"].append((r, p)))
        assert got == want == int(veto is None)
        assert sorted(acted["c"]) == sorted(acted["py"])


def test_a_raising_judge_is_an_error_not_a_crash():
    def judge_for(rank):
        def judge(payload, ctx):
            if rank == 2:
                raise KeyError("judge of rank 2")
            return 1
        return judge
    with pytest.raises(nb.CallbackError, match="judge of rank 2") as e:
        nb.run_judged_proposal(4, b"p", 0, judge_for)
    assert isinstance(e.value.__cause__, KeyError)
    # an action that raises surfaces too; the library stays usable
    with pytest.raises(nb.CallbackError, match="action"):
        nb.run_judged_proposal(3, b"p", 1, None,
                               lambda r, p: (_ for _ in ()).throw(
                                   ValueError("action")))
    assert nb.run_judged_proposal(3, b"p", 1) == 1


def test_the_two_libraries_keep_their_trace_rings_apart():
    port, ref = nb.load(), rb.load()
    assert port._name != ref._name
    for b in (nb, rb):
        b.trace_clear()
        b.trace_set(True)
    try:
        for i in range(5):
            nb.trace_emit(1, 3, a=1000 + i)
        rb.trace_emit(2, 3, a=7)
        got, other = nb.trace_drain(), rb.trace_drain()
        assert [e["a"] for e in got] == [1000 + i for i in range(5)]
        assert [(e["rank"], e["a"]) for e in other] == [(2, 7)]
        # a C engine of one library traces into its own ring only
        with nb.NativeWorld(3) as w:
            es = [nb.NativeEngine(w, r) for r in range(3)]
            es[0].bcast(b"t")
            w.drain()
        assert nb.trace_drain() and not rb.trace_drain()
    finally:
        for b in (nb, rb):
            b.trace_set(False)
            b.trace_clear()


def test_builds_land_under_their_own_names_in_build():
    lib = build.build()
    assert lib.parent == build.BUILD_DIR == build._DIR / "_build"
    assert lib.name == "librlo_torch_core.so"
    assert build.lib_path(True).name == "librlo_torch_core_fmpi.so"
    assert nb.load()._name == str(lib)
    assert "rlo_tpu_torch/native/_build" in str(lib)
    # the sources stand alone: nothing includes from the JAX package's
    for src in build.SOURCES + build.HEADERS:
        text = (build._DIR / src).read_text()
        assert "rlo_tpu/" not in text and "/root/" not in text, src
