"""The port's fleet telescope (``rlo_tpu_torch/observe``, with
``utils/timeline.py`` and the two topology helpers the ledgers need)
against the JAX package's on the CPU, on the same seeded inputs:

  - request spans: the sampled rid set, the span-context trailer bytes
    and the ``Ev.SPAN`` events;
  - the telemetry plane over a loopback world on an injected clock:
    every digest's bytes (``wire.encode_telem``), the digests'
    destinations and the ``FleetView`` snapshots;
  - watchdog rule parsing (the grammar, its rejections, the default
    rules) and trips, and the incident bundle of the churn cascade
    written under ``tmp_path`` (its JSON files compared as parsed JSON,
    its JSONL dumps line by line);
  - remedy records' bytes;
  - the cost ledgers of every schedule at world sizes 2-16;
  - ``merge_timeline``, ``trace_stats`` and the timeline CLI on the
    same per-rank dumps (parsed JSON; the one difference is the
    ``otherData.generator`` name, each package's own module);
  - ``topology.ring_reduce_scatter_chunk`` and ``topology.describe``.
"""

import importlib
import json
import logging

import pytest

from rlo_tpu import topology as ref_topo
from rlo_tpu import wire as ref_wire
from rlo_tpu.engine import EngineManager as RefManager
from rlo_tpu.engine import ProgressEngine as RefEngine
from rlo_tpu.engine import drain as ref_drain
from rlo_tpu.observe import remedy as ref_remedy
from rlo_tpu.observe import spans as ref_spans
from rlo_tpu.observe import telemetry as ref_telem
from rlo_tpu.observe import watchdog as ref_wd
from rlo_tpu.transport import sim as ref_sim
from rlo_tpu.transport.loopback import LoopbackWorld as RefLoopback
from rlo_tpu.utils import timeline as ref_tl
from rlo_tpu.utils import tracing as ref_tracing
from rlo_tpu.workloads.weather import make_weather as ref_weather
from rlo_tpu_torch import observe as port_observe
from rlo_tpu_torch import topology as port_topo
from rlo_tpu_torch import wire as port_wire
from rlo_tpu_torch.engine import EngineManager, ProgressEngine, drain
from rlo_tpu_torch.observe import remedy as port_remedy
from rlo_tpu_torch.observe import spans as port_spans
from rlo_tpu_torch.observe import telemetry as port_telem
from rlo_tpu_torch.observe import watchdog as port_wd
from rlo_tpu_torch.transport import sim as port_sim
from rlo_tpu_torch.transport.loopback import LoopbackWorld
from rlo_tpu_torch.utils import timeline as port_tl
from rlo_tpu_torch.utils import tracing as port_tracing
from rlo_tpu_torch.workloads.weather import make_weather as port_weather

# the packages export the function ``ledger``, which hides the module
ref_ledger = importlib.import_module("rlo_tpu.observe.ledger")
port_ledger = importlib.import_module("rlo_tpu_torch.observe.ledger")

logging.getLogger("rlo_tpu").setLevel(logging.ERROR)
logging.getLogger("rlo_tpu_torch").setLevel(logging.ERROR)

PKGS = {
    "ref": dict(spans=ref_spans, telem=ref_telem, wd=ref_wd, sim=ref_sim,
                tracing=ref_tracing, wire=ref_wire, weather=ref_weather,
                world=RefLoopback, manager=RefManager, engine=RefEngine,
                drain=ref_drain, tl=ref_tl),
    "port": dict(spans=port_spans, telem=port_telem, wd=port_wd,
                 sim=port_sim, tracing=port_tracing, wire=port_wire,
                 weather=port_weather, world=LoopbackWorld,
                 manager=EngineManager, engine=ProgressEngine, drain=drain,
                 tl=port_tl),
}


def test_export_surface_equals_reference():
    import rlo_tpu.observe as ref_observe
    assert port_observe.__all__ == ref_observe.__all__
    for name in port_observe.__all__:
        assert hasattr(port_observe, name), name
    assert port_observe.STAGE_NAMES == ref_observe.STAGE_NAMES
    assert port_observe.DEFAULT_RULES == ref_observe.DEFAULT_RULES
    assert [(s.name, int(s)) for s in port_observe.Stage] == \
        [(s.name, int(s)) for s in ref_observe.Stage]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _spans(pkg, sample, seed):
    P = PKGS[pkg]
    ring = P["tracing"].Tracer(enabled=True)
    now = [0.0]
    rec = P["spans"].SpanRecorder(3, lambda: now[0], sample=sample,
                                  seed=seed, tracer=ring)
    out = []
    for g in range(4):
        for s in range(40):
            rid = (g, (g << 20) + s)
            on = rec.sampled(rid)
            out.append(on)
            stage = 1 + (s % 7)
            t0 = 0.25 * s + 1e-7 * g
            out.append(rec.ctx(rid, stage, t0, on))
            if on:
                rec.emit(rid, stage, t0, t0 + 0.013 * (s + 1))
    out.append([(e.rank, e.kind.name, e.a, e.b, e.c, e.d, e.ts_usec)
                for e in ring.events()])
    return out


@pytest.mark.parametrize("sample,seed", [(1, 0), (3, 0), (3, 7), (8, 1)])
def test_span_events_equal_reference(sample, seed):
    want = _spans("ref", sample, seed)
    assert want[-1]
    assert _spans("port", sample, seed) == want


# ---------------------------------------------------------------------------
# the telemetry plane over a loopback world
# ---------------------------------------------------------------------------

def _telemetry(pkg, ws, seed):
    """Loopback ranks on one injected clock, a plane a rank, traffic
    between emissions; returns every digest sent (bytes, src, dst) and
    every rank's FleetView snapshot."""
    P = PKGS[pkg]
    world = P["world"](ws, latency=2, seed=seed)
    mgr = P["manager"]()
    now = [0.0]
    engines = [P["engine"](world.transport(r), manager=mgr,
                           clock=lambda: now[0]) for r in range(ws)]
    tag = int(P["wire"].Tag.TELEM)
    sent = []
    for e in engines:
        e.enable_metrics()
        orig = e.send_direct

        def spy(dst, data, tag=P["wire"].Tag.SERVE, _o=orig, _r=e.rank):
            if int(tag) == int(P["wire"].Tag.TELEM):
                sent.append((_r, dst, bytes(data)))
            return _o(dst, data, tag=tag)
        e.send_direct = spy
    extras = [{"pages_in_use": 3 * r, "pages_free": 40 - r,
               "serve_inflight": r} for r in range(ws)]
    planes = [P["telem"].TelemetryPlane(e, interval=1.0, full_every=3,
                                        extra=(lambda x=x: x))
              for e, x in zip(engines, extras)]
    snaps = []
    for rnd in range(7):
        for i in range(rnd + 1):
            engines[(rnd + i) % ws].bcast(b"t%d-%d" % (rnd, i))
        P["drain"]([world], engines)
        extras[rnd % ws]["pages_in_use"] += 5
        now[0] += 1.0
        for p in planes:
            p.pump()
        P["drain"]([world], engines)
        for p in planes:
            p.pump()
    for p in planes:
        p.flush()
    P["drain"]([world], engines)
    for p in planes:
        p.pump()
    for r, p in enumerate(planes):
        snaps.append(p.view.snapshot(now[0], self_epoch=engines[r].epoch))
        snaps.append(p.stats())
    for e in engines:
        e.cleanup()
    return sent, snaps, tag


@pytest.mark.parametrize("ws,seed", [(4, 0), (5, 3), (8, 1)])
def test_telemetry_digests_and_views_equal_reference(ws, seed):
    want_sent, want_snaps, _ = _telemetry("ref", ws, seed)
    got_sent, got_snaps, _ = _telemetry("port", ws, seed)
    assert len(want_sent) > ws
    assert got_sent == want_sent              # the digests' bytes
    assert got_snaps == want_snaps
    assert want_snaps[0]["present"] == ws


def test_telemetry_merge_helpers_equal_reference():
    dicts = [{"a": i, "b": 2 * i, f"k{i}": 1} for i in range(5)]
    assert port_telem.merge_counter_dicts(dicts) == \
        ref_telem.merge_counter_dicts(dicts)
    from rlo_tpu.utils.metrics import Histogram
    snaps = []
    for s in range(4):
        h = Histogram()
        for v in range(s, 400, 7 + s):
            h.observe(v * 13.5)
        snaps.append(h.snapshot())
    assert port_telem.merge_histograms(snaps) == \
        ref_telem.merge_histograms(snaps)


# ---------------------------------------------------------------------------
# the watchdog: rules, trips, bundles
# ---------------------------------------------------------------------------

RULE_TEXTS = (
    "rejoin-cascade: sum(rejoins) / 30s >= 0.5",
    "lag: max(epoch_lag_max) >= 8",
    "calm: sum(arq_retransmits) / 2.5s < 1e-3",
    "eq: max(pages_free) == 4",
    "bad rule text",
    "x: sum(not_a_key) >= 1",
    "y: median(rejoins) >= 1",
) + tuple(ref_wd.DEFAULT_RULES)


def _parsed(mod, text):
    try:
        r = mod.parse_rule(text)
    except ValueError as e:
        return ("ValueError", str(e))
    return (r.name, r.key, r.threshold, r.agg, r.mode, r.window, r.op,
            r.spec())


@pytest.mark.parametrize("text", RULE_TEXTS)
def test_rule_parsing_equals_reference(text):
    assert _parsed(port_wd, text) == _parsed(ref_wd, text)


def _trips(pkg):
    P = PKGS[pkg]
    world = P["sim"].SimWorld(3, seed=0)
    mgr = P["manager"]()
    engines = [P["engine"](world.transport(r), manager=mgr,
                           clock=world.clock) for r in range(3)]
    plane = P["telem"].TelemetryPlane(engines[0], interval=0.5)
    wd = P["wd"].Watchdog(plane, ["sent: sum(sent_bcast) >= 2",
                                  "rate: sum(sent_bcast) / 2s >= 0.5"],
                          cooldown=3.0)
    out = [[i.to_dict() for i in wd.check()]]
    for i in range(12):
        engines[i % 2].bcast(b"x%d" % i)
        world.advance(0.7)
        mgr.progress_all()
        plane.pump()
        out.append([i.to_dict() for i in wd.check()])
    out.append([i.to_dict() for i in wd.incidents])
    for e in engines:
        e.cleanup()
    return out


def test_watchdog_trips_equal_reference():
    want = _trips("ref")
    assert len(want[-1]) >= 2
    assert _trips("port") == want


def _cascade(pkg, seed, d):
    P = PKGS[pkg]
    w = P["weather"]("churn", seed=1, world_size=16, rate=0.05,
                     duration=60.0, start=8.0, mean_down=20.0,
                     min_down=13.0, min_live=14, settle=25.0,
                     immortal=(0,))
    return P["sim"].Scenario(
        world_size=16, seed=seed, duration=60.0, weather=w,
        failure_timeout=3.0, heartbeat_interval=1.0, arq_rto=1.5,
        arq_max_retries=6, op_deadline=30.0, check_delivery=False,
        telemetry=True,
        watchdog_rules=["rejoin-cascade: sum(rejoins) / 30s >= 0.02"],
        incident_dir=str(d))


def _bundle(root):
    """Every file of every bundle under ``root``: JSON parsed, JSONL as
    parsed lines, with the bundle's own path taken out."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_dir():
            continue
        rel = str(p.relative_to(root))
        if p.suffix == ".jsonl":
            out[rel] = [json.loads(ln) for ln in p.read_text().splitlines()]
        else:
            doc = json.loads(p.read_text())
            if p.name == "incident.json":
                doc["bundle_dir"] = None
            out[rel] = doc
    return out


def test_incident_bundle_equals_reference(tmp_path):
    want_res = _cascade("ref", 5, tmp_path / "ref").run()
    got_res = _cascade("port", 5, tmp_path / "port").run()
    assert want_res["incidents"]
    norm = [dict(i, bundle_dir=None) for i in want_res["incidents"]]
    assert [dict(i, bundle_dir=None) for i in got_res["incidents"]] == norm
    for key in want_res:
        if key != "incidents":
            assert got_res[key] == want_res[key], key
    want, got = _bundle(tmp_path / "ref"), _bundle(tmp_path / "port")
    assert "rejoin-cascade_0/incident.json" in want
    assert sorted(got) == sorted(want)
    for name in want:
        if name.endswith("trace.json"):
            want[name]["otherData"].pop("generator")
            got[name]["otherData"].pop("generator")
        assert got[name] == want[name], name


# ---------------------------------------------------------------------------
# remedy records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ref_remedy.REMEDY_KINDS)
def test_remedy_record_bytes_equal_reference(kind):
    for target, level, version, proposer in (
            (-1, 0, 1, 0), (3, 2, 17, 5), (15, -1, 2 ** 31 - 1, 15),
            (0, 16, 0, 1023)):
        p = port_remedy.RemedyRecord(kind, target, level, version, proposer)
        r = ref_remedy.RemedyRecord(kind, target, level, version, proposer)
        assert p.encode() == r.encode()
        assert (p.key(), p.name()) == (r.key(), r.name())
        back = port_remedy.RemedyRecord.decode(kind, r.encode())
        assert back == p
        assert port_remedy.RemedyRecord.decode(kind, r.encode()[:-1]) is None
    assert port_remedy.RemedyRecord.decode(99, bytes(16)) is None


# ---------------------------------------------------------------------------
# cost ledgers and the topology helpers they replay
# ---------------------------------------------------------------------------

def _account(mod, alg, n, nbytes, **kw):
    try:
        led = mod.ledger(alg, n, nbytes, **kw)
    except ValueError as e:   # LedgerError, or a schedule's own refusal
        return (type(e).__name__, str(e))
    return (led.digest(), led.num_steps, led.total_bytes,
            led.sent_bytes_by_rank(), led.bytes_per_rank,
            led.step_table(), led.final,
            [(s.algorithm, s.index, s.nbytes, s.edge_nbytes,
              [(e.src, e.dst, e.nbytes, e.chunk, e.mask) for e in s.edges])
             for s in led.steps])


@pytest.mark.parametrize("n", range(2, 17))
def test_ledger_accounts_equal_reference(n):
    assert port_ledger.ALGORITHMS == ref_ledger.ALGORITHMS
    assert port_ledger.COMPOSITES == ref_ledger.COMPOSITES
    assert port_ledger.SCHEDULES == ref_ledger.SCHEDULES
    for alg in ref_ledger.SCHEDULES:
        for nbytes, itemsize in ((0, 4), (1000, 4), (4096, 2), (12345, 1)):
            origins = range(n) if alg.endswith("_bcast") else (0,)
            for origin in origins:
                kw = dict(itemsize=itemsize, origin=origin)
                assert _account(port_ledger, alg, n, nbytes, **kw) == \
                    _account(ref_ledger, alg, n, nbytes, **kw), \
                    (alg, n, nbytes, origin)


def test_ledger_rejects_as_reference():
    for args in (("nope", 4, 8), ("ring_allreduce", 0, 8),
                 ("ring_allreduce", 4, -1), ("skip_ring_bcast", 4, 8, 4)):
        kw = {"origin": args[3]} if len(args) > 3 else {}
        assert _account(port_ledger, *args[:3], **kw) == \
            _account(ref_ledger, *args[:3], **kw)


@pytest.mark.parametrize("ws", range(1, 17))
def test_topology_helpers_equal_reference(ws):
    for r in range(ws):
        for step in range(ws + 2):
            assert port_topo.ring_reduce_scatter_chunk(ws, r, step) == \
                ref_topo.ring_reduce_scatter_chunk(ws, r, step)
    try:
        want = ref_topo.describe(ws)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            port_topo.describe(ws)
        return
    assert port_topo.describe(ws) == want


# ---------------------------------------------------------------------------
# the timeline merger
# ---------------------------------------------------------------------------

def _dumps(pkg, d, wall=True):
    """Per-rank JSONL dumps of a loopback soak with tracing and metrics
    on (the timeline smoke's scenario), and spans. ``wall``: the engines
    run on the wall clock with the phase profiler on, as the smoke does;
    else on a clock that advances 1 ms a reading, without the profiler
    (whose slices are wall-clock durations), so that both packages emit
    the same events."""
    P = PKGS[pkg]
    tracer = P["tracing"].TRACER
    ws = 4
    world = P["world"](ws, latency=2, seed=7)
    mgr = P["manager"]()
    ticks = [0]

    def clock():
        ticks[0] += 1
        return ticks[0] * 1e-3
    kw = {} if wall else {"clock": clock}
    engines = [P["engine"](world.transport(r), manager=mgr, arq_rto=0.01,
                           **kw) for r in range(ws)]
    for e in engines:
        e.enable_metrics()
        if wall:
            e.enable_profiler()
    tracer.clear()
    with tracer.enable():
        world.dup_next(0, 1, 2)
        world.drop_next(1, 3, 1)
        for i in range(6):
            engines[i % ws].bcast(f"m{i}".encode())
        P["drain"]([world], engines)
        for e in engines:
            while e.pickup_next() is not None:
                pass
        engines[1].submit_proposal(b"smoke", pid=9)
        P["drain"]([world], engines)
        rec = P["spans"].SpanRecorder(2, lambda: 0.0, tracer=tracer)
        for s in range(5):
            rec.emit((1, s), 1 + s, 0.001 * s, 0.002 * s + 0.0005)
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for r in range(ws):
        p = d / f"rank{r}.jsonl"
        tracer.dump_jsonl(str(p), rank=r)
        paths.append(str(p))
    tracer.clear()
    for e in engines:
        e.cleanup()
    return paths


def _strip(events):
    return [{k: v for k, v in e.items() if k != "ts_usec"} for e in events]


def test_trace_dumps_equal_reference_but_for_wall_time(tmp_path):
    want = _dumps("ref", tmp_path / "ref", wall=False)
    got = _dumps("port", tmp_path / "port", wall=False)
    for w, g in zip(want, got):
        wl = [json.loads(ln) for ln in open(w)]
        gl = [json.loads(ln) for ln in open(g)]
        assert [list(e) for e in gl] == [list(e) for e in wl]  # key order
        assert _strip(gl) == _strip(wl)


@pytest.mark.parametrize("maker", ("ref", "port"))
def test_merge_timeline_equals_reference(maker, tmp_path):
    paths = _dumps(maker, tmp_path / "dumps")
    want = ref_tl.merge_timeline(paths, out_path=tmp_path / "ref.json")
    got = port_tl.merge_timeline(paths, out_path=tmp_path / "port.json")
    port_tl.validate_chrome_trace(got)
    assert got["otherData"].pop("generator") == "rlo_tpu_torch.utils.timeline"
    want["otherData"].pop("generator")
    assert got == want
    on_disk = json.loads((tmp_path / "port.json").read_text())
    on_disk["otherData"].pop("generator")
    assert on_disk == got
    assert port_tl.count_flow_edges(got) == ref_tl.count_flow_edges(want) > 0
    stats = port_tl.trace_stats(got)
    assert stats == ref_tl.trace_stats(want)
    assert port_tl.render_trace_stats(stats) == \
        ref_tl.render_trace_stats(stats)
    assert port_tl.render_request_stats(stats) == \
        ref_tl.render_request_stats(stats)
    # slices of more than one usec
    assert _no_gen(port_tl.merge_timeline(paths, slice_usec=5)) == \
        _no_gen(ref_tl.merge_timeline(paths, slice_usec=5))


def _no_gen(trace):
    trace["otherData"].pop("generator")
    return trace


def test_timeline_cli_equals_reference(tmp_path, capsys):
    paths = _dumps("ref", tmp_path / "dumps")
    outs = {}
    for name, mod in (("ref", ref_tl), ("port", port_tl)):
        out = tmp_path / f"{name}.json"
        assert mod.main(["merge", "--out", str(out), *paths]) == 0
        merged = json.loads(capsys.readouterr().out)
        assert mod.main(["stats", str(out)]) == 0
        table = capsys.readouterr().out
        assert mod.main(["stats", "--json", str(out)]) == 0
        outs[name] = (dict(merged, out=None), table,
                      json.loads(capsys.readouterr().out))
    assert outs["port"] == outs["ref"]


def test_timeline_smoke_runs_on_the_port(capsys):
    assert port_tl.main(["smoke"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["ok"] and res["flow_edges"] > 0 and res["phase_slices"] > 0
