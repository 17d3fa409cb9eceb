"""The port's progress engine against the JAX package's, scenario by
scenario.

Each seeded scenario runs once on each package's engines over that
package's own loopback world; the two runs must give exactly the same
per-rank pickups, decisions, raw frames (every ``isend``, wrapped),
``TRACER`` events (without ``ts_usec``) and metrics counters, and where
the scenario runs on an injected clock the whole metrics snapshot
(timing histograms, link stats, phase profiler) as well. A mixed world,
whose ranks alternate between the two packages' engines, must reach the
reference's decisions and pickups. Wire frames are held byte-equal under
hypothesis.

Scenarios follow the reference's own engine suites: broadcast counts and
every-rank broadcast (``tests/test_engine_bcast.py``), hacky-sack under
latency and reorder fuzz, consensus from every proposer, ARQ under
seeded burst loss (``tests/test_reliability.py``), failure detection
(``tests/test_failure.py``), membership admission
(``tests/test_membership.py``) and a ``members=`` subset
(``tests/test_subcomm.py``).
"""

import random
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import rlo_tpu.engine as ref_engine
import rlo_tpu.transport.loopback as ref_loopback
import rlo_tpu.utils.tracing as ref_tracing
import rlo_tpu.wire as ref_wire
import rlo_tpu_torch.engine as port_engine
import rlo_tpu_torch.transport.loopback as port_loopback
import rlo_tpu_torch.utils.tracing as port_tracing
import rlo_tpu_torch.wire as port_wire

PKGS = {
    "ref": SimpleNamespace(engine=ref_engine, loopback=ref_loopback,
                           tracer=ref_tracing.TRACER, wire=ref_wire),
    "port": SimpleNamespace(engine=port_engine, loopback=port_loopback,
                            tracer=port_tracing.TRACER, wire=port_wire),
}

WORLD_SIZES = [2, 3, 4, 5, 6, 7, 8, 11, 16, 23, 32]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Run:
    """One package's world: a loopback world whose transports record
    every frame, an engine manager and one engine a rank (``pkg_of(r)``
    picks each rank's package; a mixed world alternates them)."""

    def __init__(self, pkg_of, ws, *, latency=0, seed=None, clock=None,
                 members=None, **kw):
        world_pkg = PKGS[pkg_of(0)]
        self._drain = world_pkg.engine.drain
        self.world = world_pkg.loopback.LoopbackWorld(ws, latency=latency,
                                                      seed=seed)
        self.frames = []
        self.clock = clock
        ranks = list(range(ws)) if members is None else list(members)
        for r in range(ws):
            t = self.world.transport(r)
            send = t.isend

            def isend(dst, tag, data, send=send, r=r):
                self.frames.append((r, dst, int(tag), bytes(data)))
                return send(dst, tag, data)
            t.isend = isend
        self.mgr = world_pkg.engine.EngineManager()
        extra = {} if clock is None else {"clock": clock}
        if members is not None:
            extra["members"] = members
        self.engines = [
            PKGS[pkg_of(r)].engine.ProgressEngine(
                self.world.transport(r), manager=self.mgr, **extra, **kw)
            for r in ranks]
        self.decisions = []

    def drain(self):
        self._drain([self.world], self.engines)

    def spin(self, ticks, dt=0.5):
        for _ in range(ticks):
            self.clock.advance(dt)
            self.mgr.progress_all()

    def propose(self, i, payload, pid):
        """Engine i proposes; progress until it decides; record it."""
        eng = self.engines[i]
        rc = eng.submit_proposal(payload, pid=pid)
        for _ in range(100_000):
            if rc != -1:
                break
            if self.clock is not None:
                self.clock.advance(0.1)
            self.mgr.progress_all()
            rc = eng.vote_my_proposal()
        self.decisions.append(rc)
        return rc

    def pickups(self):
        out = []
        for e in self.engines:
            got = []
            while (m := e.pickup_next()) is not None:
                got.append((int(m.type), m.origin, m.pid, m.vote, m.data))
            out.append(got)
        return out


def record(run, tracer, full_metrics):
    """Everything the two packages must agree on after a scenario."""
    snaps = [e.metrics() for e in run.engines]
    return {
        "pickups": run.pickups(),
        "decisions": list(run.decisions),
        "frames": list(run.frames),
        "events": [(e.rank, e.kind.name, e.a, e.b, e.c, e.d)
                   for e in tracer.events()],
        "metrics": snaps if full_metrics
        else [s["counters"] for s in snaps],
    }


def play(scenario, pkg, *args):
    """Run ``scenario`` on package ``pkg``'s engines with its tracer on;
    returns the record."""
    tracer = PKGS[pkg].tracer
    tracer.clear()
    with tracer.enable():
        run, full = scenario(lambda r: pkg, *args)
        rec = record(run, tracer, full)
    tracer.clear()
    for e in run.engines:
        e.cleanup()
    return rec


def assert_same(scenario, *args):
    want = play(scenario, "ref", *args)
    got = play(scenario, "port", *args)
    for key in want:
        assert got[key] == want[key], key
    return want


# ---------------------------------------------------------------------------
# Scenarios: each takes pkg_of and its parameters, returns (run, whether
# its clock is injected)
# ---------------------------------------------------------------------------

def sc_single_root(pkg_of, ws):
    run = Run(pkg_of, ws)
    root = ws // 2
    for i in range(5):
        run.engines[root].bcast(f"msg-{i}".encode())
    run.drain()
    return run, False


def sc_every_rank(pkg_of, ws):
    run = Run(pkg_of, ws)
    for r in range(ws):
        run.engines[r].bcast(f"from-{r}".encode())
    run.drain()
    return run, False


def sc_latency_fuzz(pkg_of, ws, latency, seed):
    run = Run(pkg_of, ws, latency=latency, seed=seed)
    for r in range(ws):
        run.engines[r].bcast(f"fuzz-{r}".encode())
    run.drain()
    return run, False


def sc_hacky_sack(pkg_of, ws, latency, seed):
    run = Run(pkg_of, ws, latency=latency, seed=seed)
    rng = random.Random(7 + seed)
    holder = 0
    for i in range(20):
        run.engines[holder].bcast(f"ball-{i}".encode())
        holder = rng.choice([r for r in range(ws) if r != holder])
        if i % 5 == 4:
            run.mgr.progress_all()
    run.drain()
    return run, False


def sc_consensus(pkg_of, ws, proposer):
    """Approve, then a veto from a rank other than the proposer, then a
    proposer self-veto, each from ``proposer``."""
    votes = {"v": [1] * ws}
    run = Run(pkg_of, ws, judge_cb=None)
    for r, e in enumerate(run.engines):
        e.set_app(judge_cb=lambda p, ctx, r=r: votes["v"][r])
    run.propose(proposer, b"approve", proposer)
    run.drain()
    votes["v"][(proposer + 3) % ws] = 0
    run.propose(proposer, b"veto", proposer)
    run.drain()
    votes["v"] = [1] * ws
    votes["v"][proposer] = 0
    run.propose(proposer, b"self-veto", proposer)
    run.drain()
    return run, False


def sc_arq_loss(pkg_of, seed):
    """ARQ under seeded burst loss and reorder, on an injected clock,
    with metrics and the phase profiler on."""
    clock = FakeClock()
    run = Run(pkg_of, 6, latency=2, seed=seed, clock=clock, arq_rto=1.0,
              arq_max_retries=12)
    for e in run.engines:
        e.enable_metrics(True)
        e.enable_profiler(True)
    run.world.set_burst_loss(0.15, burst_len=2)
    for r in (0, 3, 5):
        run.engines[r].bcast(f"lossy-{r}".encode())
    run.spin(60)
    run.world.set_burst_loss(0.0)
    run.engines[2].bcast(b"after")
    run.spin(60)
    return run, True


def sc_failure(pkg_of, ws, dead):
    """Heartbeat failure detection on an injected clock: kill a rank,
    let the survivors detect it and re-form, then broadcast and run a
    consensus round among them."""
    clock = FakeClock()
    run = Run(pkg_of, ws, clock=clock, failure_timeout=4.0,
              heartbeat_interval=1.0)
    for e in run.engines:
        e.enable_metrics(True)
    run.spin(4)
    run.world.kill_rank(dead)
    run.engines[dead].cleanup()
    run.spin(40)
    alive = [r for r in range(ws) if r != dead]
    run.engines[alive[1]].bcast(b"survivors")
    run.spin(20)
    run.propose(alive[0], b"after-failure", alive[0])
    run.spin(20)
    run.engines = [run.engines[r] for r in alive]
    return run, True


def sc_membership(pkg_of, how):
    """Membership admission on an injected clock: a false-positive
    failure notice (the live rank rejoins through the IAR admission
    round) or an explicit rejoin, then traffic from the readmitted
    rank."""
    clock = FakeClock()
    run = Run(pkg_of, 4, seed=3, clock=clock, failure_timeout=20.0,
              heartbeat_interval=2.0)
    for e in run.engines:
        e.enable_metrics(True)
    run.spin(3, dt=1.0)
    if how == "false_positive":
        run.engines[0]._announce_failed(1)
        back = 1
    else:
        run.engines[2].rejoin()
        back = 2
    run.spin(80, dt=1.0)
    run.engines[back].bcast(b"back")
    run.spin(20, dt=1.0)
    return run, True


def sc_subset(pkg_of, members, proposer):
    """Engines over a rank subset of an 8-rank world: a broadcast from
    every member, then approve and veto rounds from ``proposer`` (a
    position)."""
    votes = {"v": [1] * len(members)}
    run = Run(pkg_of, 8, members=members)
    for i, e in enumerate(run.engines):
        e.set_app(judge_cb=lambda p, ctx, i=i: votes["v"][i])
    for i, e in enumerate(run.engines):
        e.bcast(f"sub-{i}".encode())
    run.drain()
    run.propose(proposer, b"sub-approve", proposer)
    run.drain()
    votes["v"][(proposer + 1) % len(members)] = 0
    run.propose(proposer, b"sub-veto", proposer)
    run.drain()
    return run, False


# ---------------------------------------------------------------------------
# The parity tests
# ---------------------------------------------------------------------------

CASES = (
    [pytest.param(sc_single_root, (ws,), id=f"single_root-ws{ws}")
     for ws in WORLD_SIZES]
    + [pytest.param(sc_every_rank, (ws,), id=f"every_rank-ws{ws}")
       for ws in WORLD_SIZES]
    + [pytest.param(sc_latency_fuzz, a, id="latency_fuzz-{}-{}-{}".format(*a))
       for a in [(4, 3, 0), (7, 5, 1), (8, 4, 2), (16, 6, 3), (23, 8, 4)]]
    + [pytest.param(sc_hacky_sack, (ws, lat, seed),
                    id=f"hacky_sack-ws{ws}-lat{lat}-seed{seed}")
       for ws in (4, 8, 16) for lat, seed in ((2, 99), (5, 11))]
    + [pytest.param(sc_consensus, (ws, p), id=f"consensus-ws{ws}-p{p}")
       for ws in (5, 8) for p in range(ws)]
    + [pytest.param(sc_arq_loss, (seed,), id=f"arq_loss-seed{seed}")
       for seed in range(4)]
    + [pytest.param(sc_failure, (ws, dead), id=f"failure-ws{ws}-dead{dead}")
       for ws, dead in ((4, 3), (6, 2), (8, 5))]
    + [pytest.param(sc_membership, (how,), id=f"membership-{how}")
       for how in ("false_positive", "rejoin")]
    + [pytest.param(sc_subset, ([0, 2, 5, 7], p), id=f"subset-p{p}")
       for p in range(4)]
)


@pytest.mark.parametrize("scenario,args", CASES)
def test_port_engine_matches_reference(scenario, args):
    want = assert_same(scenario, *args)
    # the scenario did something: frames went out and events were traced
    assert want["frames"] and want["events"]


def test_scenarios_reach_the_reference_oracles():
    """The records compared above carry the reference suites' own
    oracles: counts, decisions, failure and readmission."""
    rec = play(sc_single_root, "port", 8)
    assert [len(p) for p in rec["pickups"]] == [5] * 4 + [0] + [5] * 3
    rec = play(sc_consensus, "port", 8, 3)
    assert rec["decisions"] == [1, 0, 0]
    rec = play(sc_failure, "port", 6, 2)
    assert rec["decisions"] == [1]
    assert all(m["counters"]["view_changes"] >= 1 for m in rec["metrics"])
    rec = play(sc_membership, "port", "false_positive")
    assert rec["metrics"][1]["counters"]["rejoins"] >= 1
    back = [p for p in rec["pickups"][0]
            if p[0] == int(port_wire.Tag.BCAST) and p[4] == b"back"]
    assert len(back) == 1
    rec = play(sc_arq_loss, "port", 1)
    assert sum(m["counters"]["arq_retransmits"] for m in rec["metrics"]) > 0
    assert all(m["counters"]["arq_unacked"] == 0 for m in rec["metrics"])


def _mixed(r):
    return "ref" if r % 2 == 0 else "port"


@pytest.mark.parametrize("ws,proposer", [(4, 1), (7, 4), (8, 6)])
def test_mixed_world_reaches_reference_decisions(ws, proposer):
    """Ranks alternate between the two packages' engines on one world:
    their frames interoperate, and the decisions and pickups equal an
    all-reference run's."""
    def scenario(pkg_of):
        run, _ = sc_consensus(pkg_of, ws, proposer)
        for r in range(ws):
            run.engines[r].bcast(f"mixed-{r}".encode())
        run.drain()
        return run

    def play_mixed(pkg_of):
        for p in PKGS.values():
            p.tracer.clear()
        run = scenario(pkg_of)
        out = (list(run.decisions), run.pickups(), list(run.frames))
        for e in run.engines:
            e.cleanup()
        return out

    want = play_mixed(lambda r: "ref")
    got = play_mixed(_mixed)
    assert got[0] == want[0] == [1, 0, 0]
    assert got[1] == want[1]
    assert got[2] == want[2]


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------

i32 = st.integers(-2 ** 31, 2 ** 31 - 1)


@settings(max_examples=200, deadline=None)
@given(origin=i32, pid=i32, vote=i32, seq=i32, epoch=i32,
       payload=st.binary(max_size=512), new_seq=i32, new_epoch=i32)
def test_wire_frames_byte_equal(origin, pid, vote, seq, epoch, payload,
                                new_seq, new_epoch):
    ref = ref_wire.Frame(origin, pid, vote, payload, seq, epoch)
    port = port_wire.Frame(origin, pid, vote, payload, seq, epoch)
    raw = ref.encode()
    assert port.encode() == raw
    assert port_wire.Frame.decode(raw) == port
    assert port_wire.restamp_link(raw, new_seq, new_epoch) == \
        ref_wire.restamp_link(raw, new_seq, new_epoch)
    assert port_wire.restamp_epoch(raw, new_epoch) == \
        ref_wire.restamp_epoch(raw, new_epoch)


@settings(max_examples=100, deadline=None)
@given(rank=st.integers(0, 2 ** 20), epoch=st.integers(0, 2 ** 20),
       seq=st.integers(0, 2 ** 31), full=st.booleans(),
       vals=st.lists(st.integers(0, 2 ** 40),
                     min_size=len(ref_wire.TELEM_KEYS),
                     max_size=len(ref_wire.TELEM_KEYS)))
def test_telemetry_records_byte_equal(rank, epoch, seq, full, vals):
    prev = None if full else [v // 2 for v in vals]
    cur = vals
    raw = ref_wire.encode_telem(rank, epoch, seq, cur, prev)
    assert port_wire.encode_telem(rank, epoch, seq, cur, prev) == raw
    assert port_wire.decode_telem(raw) == ref_wire.decode_telem(raw)


def test_tags_and_constants_equal():
    assert {t.name: int(t) for t in port_wire.Tag} == \
        {t.name: int(t) for t in ref_wire.Tag}
    for name in ("HEADER_SIZE", "SEQ_OFFSET", "EPOCH_OFFSET", "MSG_SIZE_MAX",
                 "SPAN_CTX_SIZE", "TELEM_HEADER_SIZE"):
        assert getattr(port_wire, name) == getattr(ref_wire, name), name
    assert {int(t) for t in port_wire.BCAST_TAGS} == \
        {int(t) for t in ref_wire.BCAST_TAGS}
    assert port_engine.INCARNATION_SHIFT == ref_engine.INCARNATION_SHIFT
    assert [s.name for s in port_engine.ReqState] == \
        [s.name for s in ref_engine.ReqState]
