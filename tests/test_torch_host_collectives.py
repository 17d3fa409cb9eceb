"""The port's ``ops/collectives.py`` (``Comm``) against the JAX package's.

The same coroutine collectives over the port's loopback world and its
deterministic simulator (``SimWorld``) and over the JAX package's: the
results, every frame sent (bytes), the ``coll_steps``/``coll_bytes``
counters, the ``Ev.STEP`` events of an instrumented run and, under the
simulator, the delivery schedule's digest must be equal. The port's
array codec (``_pack_array``) is the one its bridge uses.
"""

import itertools

import numpy as np
import pytest

import rlo_tpu.ops.collectives as rc
import rlo_tpu_torch.ops.collectives as pc
from rlo_tpu.transport.loopback import LoopbackWorld as RefLoopback
from rlo_tpu.transport.sim import SimWorld as RefSim
from rlo_tpu.utils.tracing import Tracer as RefTracer
from rlo_tpu_torch.transport.loopback import LoopbackWorld
from rlo_tpu_torch.transport.sim import SimWorld
from rlo_tpu_torch.utils.tracing import Tracer

PKGS = {"ref": (rc, RefLoopback, RefSim, RefTracer),
        "port": (pc, LoopbackWorld, SimWorld, Tracer)}
WORLD_SIZES = [2, 3, 5, 8]


def _data(ws, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return [rng.integers(0, 1 << 12, shape).astype(dtype)
                for _ in range(ws)]
    return [rng.standard_normal(shape).astype(dtype) for _ in range(ws)]


#: (name, method, kwargs, per-rank argument maker (ws, seed) -> list)
CASES = [
    ("rd_sum", "allreduce", dict(algorithm="recursive_doubling"),
     lambda ws, s: _data(ws, (33,), np.float32, s)),
    ("ring_sum", "allreduce", dict(algorithm="ring"),
     lambda ws, s: _data(ws, (4, 25), np.float32, s)),
    ("ring_min_ragged", "allreduce", dict(op="min", algorithm="ring"),
     lambda ws, s: _data(ws, (ws * 3 + 1,), np.float64, s)),
    ("auto_prod", "allreduce", dict(op="prod"),
     lambda ws, s: _data(ws, (7,), np.float32, s)),
    ("rd_and", "allreduce", dict(op="and", algorithm="recursive_doubling"),
     lambda ws, s: _data(ws, (9,), np.int32, s)),
    ("ring_or", "allreduce", dict(op="or", algorithm="ring"),
     lambda ws, s: _data(ws, (11,), np.int64, s)),
    ("reduce_scatter", "reduce_scatter", dict(op="max"),
     lambda ws, s: _data(ws, (2 * ws + 1,), np.float32, s)),
    ("all_gather", "all_gather", {},
     lambda ws, s: _data(ws, (3, 2), np.int32, s)),
    ("all_to_all", "all_to_all", {},
     lambda ws, s: [_data(ws, (5,), np.float32, s * 100 + r)
                    for r in range(ws)]),
    ("barrier", "barrier", {}, lambda ws, s: [None] * ws),
]


def _drive(pkg, world_kind, ws, case, seed, members=None):
    """Run one case on ``pkg``'s Comm over ``world_kind``; returns the
    results, the frames sent, the counters and the STEP events."""
    mod, Loop, Sim, Trc = PKGS[pkg]
    name, method, kwargs, make = case
    ranks = list(range(ws)) if members is None else sorted(members)
    if world_kind == "sim":
        world = Sim(ws, seed=seed)
        clock = world.clock
    else:
        world = Loop(ws, latency=2, seed=seed)
        ticks = itertools.count()
        clock = lambda: next(ticks) * 1e-3  # noqa: E731
    comms = [mod.Comm(world.transport(r), members=members) for r in ranks]
    frames = []
    for c in comms:
        send = c.tp.isend

        def logged(dst, tag, data, _src=c.real_rank, _send=send):
            frames.append((_src, dst, tag, bytes(data)))
            return _send(dst, tag, data)
        c.tp.isend = logged
    tracer = Trc(enabled=True)
    for c in comms:
        c.instrument(clock, tracer)
    args = make(len(ranks), seed)
    coros = [getattr(c, method)(*([] if a is None else [a]), **kwargs)
             for c, a in zip(comms, args)]
    if world_kind == "sim":
        results = [None] * len(coros)
        alive = set(range(len(coros)))
        while alive:
            for i in list(alive):
                try:
                    next(coros[i])
                except StopIteration as e:
                    results[i] = e.value
                    alive.discard(i)
            if alive:
                world.step()
        digest = world.schedule_digest()
    else:
        results = mod.run_collectives(coros)
        digest = None
    events = [(e.rank, int(e.kind), e.a, e.b, e.c, e.d, e.ts_usec)
              for e in tracer.events()]
    counters = [(c.coll_steps, c.coll_bytes) for c in comms]
    return results, frames, counters, events, digest


def _same_results(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_results(g, w)
    elif isinstance(want, np.ndarray):
        assert g_bytes(got) == g_bytes(want) and got.dtype == want.dtype \
            and got.shape == want.shape
    else:
        assert got == want


def g_bytes(a):
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("world_kind", ["loopback", "sim"])
@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_comm_equals_the_jax_package(case, ws, world_kind):
    got = _drive("port", world_kind, ws, case, seed=ws)
    want = _drive("ref", world_kind, ws, case, seed=ws)
    _same_results(got[0], want[0])
    assert got[1] == want[1]              # every frame, byte for byte
    assert got[2] == want[2]              # coll_steps, coll_bytes
    assert got[3] == want[3]              # Ev.STEP events
    assert got[4] == want[4]              # the simulator's schedule
    if case[1] not in ("barrier", "all_to_all"):  # the probed schedules
        assert got[3], "no STEP event"


@pytest.mark.parametrize("world_kind", ["loopback", "sim"])
def test_sub_communicator_equals_the_jax_package(world_kind):
    ws, members = 7, [0, 2, 3, 6]
    for case in CASES:
        got = _drive("port", world_kind, ws, case, seed=1, members=members)
        want = _drive("ref", world_kind, ws, case, seed=1, members=members)
        _same_results(got[0], want[0])
        assert got[1:] == want[1:], case[0]
        assert {src for src, *_ in got[1]} <= set(members)


def test_blocking_driver_and_codec():
    x = np.arange(12, dtype=np.int16).reshape(3, 4)
    packed = pc._pack_array(x)
    assert packed == rc._pack_array(x)
    y = pc._unpack_array(packed)
    assert y.dtype == x.dtype and np.array_equal(y, x)
    assert y.flags.writeable
    # run_blocking: each rank spins its own coroutine on a thread
    import threading
    w = LoopbackWorld(3)
    outs = [None] * 3

    def work(r):
        outs[r] = pc.run_blocking(pc.Comm(w.transport(r)).allreduce(
            x + r, algorithm="ring"))
    threads = [threading.Thread(target=work, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for o in outs:
        assert np.array_equal(o, 3 * x + 3)
    # the bridge keeps no codec of its own: the hybrid's bcast is
    # NativeBackend's, which packs with this module's codec
    import rlo_tpu_torch
    from rlo_tpu_torch import bridge
    assert not hasattr(bridge, "_pack_array")
    with rlo_tpu_torch.init("hybrid", world_size=3, device="cpu") as h:
        assert all(y.dtype == x.dtype and np.array_equal(y, x)
                   for y in h.bcast(1, x))


def test_errors_match():
    for mod, Loop in ((rc, RefLoopback), (pc, LoopbackWorld)):
        w = Loop(3)
        with pytest.raises(ValueError, match=">= 2 members"):
            mod.Comm(w.transport(0), members=[0])
        with pytest.raises(ValueError, match="not in members"):
            mod.Comm(w.transport(1), members=[0, 2])
        c = mod.Comm(w.transport(0))
        with pytest.raises(ValueError, match="unknown algorithm"):
            mod.run_blocking(c.allreduce(np.ones(2), algorithm="tree"))
        with pytest.raises(ValueError, match="one chunk per rank"):
            mod.run_blocking(c.all_to_all([np.ones(2)]))
    assert pc.OPS.keys() == rc.OPS.keys()
    for op in pc.OPS:
        for dt in (np.float32, np.int32):
            assert pc._identity_for(op, np.dtype(dt)) == \
                rc._identity_for(op, np.dtype(dt))
