"""The port's tracing against the JAX package's.

``Ev``/``Event``/``Tracer`` are copies: the numbering, the ring's drop
accounting and the JSONL dump must match the reference's, and the
reference suite's scenario (one bcast + one vetoed IAR round at ws 8)
must give the same event stream, ``ts_usec`` aside, on both packages'
engines. The counterparts of ``tests/test_tracing.py:162-220`` (the
Python ring; the C ring has no counterpart in the port), and the
``torch.profiler`` hooks that replace ``jax.profiler``'s: ``annotate``
names a range the profiler records, ``profile`` writes a Chrome trace.
"""

import json
import threading

import pytest
import torch

import rlo_tpu.engine as ref_engine
import rlo_tpu.transport.loopback as ref_loopback
import rlo_tpu.utils.tracing as ref_tracing
import rlo_tpu_torch.engine as port_engine
import rlo_tpu_torch.transport.loopback as port_loopback
import rlo_tpu_torch.utils.tracing as port_tracing
from rlo_tpu_torch.utils.tracing import TRACER, Ev, Tracer, annotate, profile

WS = 8


def _scenario(engine_mod, loopback_mod, tracer, metrics):
    """One bcast from rank 2 + one vetoed proposal from rank 0 (the
    reference suite's scenario); returns the events without ts_usec and
    the metrics snapshots."""
    world = loopback_mod.LoopbackWorld(WS)
    mgr = engine_mod.EngineManager()
    engines = [engine_mod.ProgressEngine(
        world.transport(r),
        judge_cb=lambda payload, ctx, r=r: 0 if r == WS - 1 else 1,
        manager=mgr) for r in range(WS)]
    if metrics:
        for e in engines:
            e.enable_metrics()
    tracer.clear()
    with tracer.enable():
        engines[2].bcast(b"hello")
        engine_mod.drain([world], engines)
        for e in engines:
            while e.pickup_next() is not None:
                pass
        engines[0].submit_proposal(b"prop", pid=0)
        engine_mod.drain([world], engines)
    events = [(e.rank, e.kind.name, e.a, e.b, e.c, e.d)
              for e in tracer.events()]
    tracer.clear()
    snaps = [e.metrics() for e in engines]
    for e in engines:
        e.cleanup()
    return events, snaps


@pytest.mark.parametrize("metrics", [False, True])
def test_engine_event_streams_match_reference(metrics):
    want, want_snaps = _scenario(ref_engine, ref_loopback,
                                 ref_tracing.TRACER, metrics)
    got, got_snaps = _scenario(port_engine, port_loopback, TRACER, metrics)
    assert got == want
    kinds = {k for _, k, *_ in got}
    assert {"BCAST_INIT", "DELIVER", "PROPOSAL_SUBMIT", "JUDGE", "VOTE",
            "DECISION"} <= kinds
    assert [s["counters"] for s in got_snaps] == \
        [s["counters"] for s in want_snaps]
    assert [{p: {k: v for k, v in ls.items() if k != "rtt_ewma_usec"}
             for p, ls in s["links"].items()} for s in got_snaps] == \
        [{p: {k: v for k, v in ls.items() if k != "rtt_ewma_usec"}
          for p, ls in s["links"].items()} for s in want_snaps]


def test_event_kinds_numbered_as_reference():
    assert {e.name: int(e) for e in Ev} == \
        {e.name: int(e) for e in ref_tracing.Ev}
    ev = port_tracing.Event(5, 1, Ev.VOTE, 1, 2, 3, 4)
    ref = ref_tracing.Event(5, 1, ref_tracing.Ev.VOTE, 1, 2, 3, 4)
    assert ev.to_dict() == ref.to_dict()


@pytest.mark.parametrize("make", [Tracer, ref_tracing.Tracer],
                         ids=["port", "ref"])
def test_tracer_ring_reports_dropped(make):
    """Overflow accounting: a ring at capacity reports ``dropped`` as
    emitted minus capacity and keeps the ``capacity`` newest events,
    the same in both packages."""
    cap, extra = 64, 9
    t = make(capacity=cap)
    with t.enable():
        for i in range(cap + extra):
            t.emit(0, Ev.DELIVER, i)
    assert t.dropped == extra
    evs = t.events()
    assert len(evs) == cap
    assert [e.a for e in evs] == list(range(extra, cap + extra))


def test_tracer_disabled_emits_nothing():
    t = Tracer()
    t.emit(0, Ev.BCAST_INIT, 1, 2)
    assert t.events() == []


def test_tracer_ring_drops_oldest():
    t = Tracer(capacity=4)
    with t.enable():
        for i in range(10):
            t.emit(i, Ev.DELIVER)
    assert len(t.events()) == 4
    assert t.dropped == 6
    assert [e.rank for e in t.events()] == [6, 7, 8, 9]


def test_dump_jsonl_matches_reference(tmp_path):
    recs = []
    for mod in (port_tracing, ref_tracing):
        t = mod.Tracer()
        with t.enable():
            t.emit(1, mod.Ev.VOTE, 5, 1, ts_usec=42)
            t.emit(2, mod.Ev.DECISION, 5, 0, ts_usec=43)
        path = tmp_path / f"{mod.__name__}.jsonl"
        assert t.dump_jsonl(str(path)) == 2
        assert t.dump_jsonl(str(path) + ".r1", rank=1) == 1
        recs.append(path.read_text())
    assert recs[0] == recs[1]
    rec = json.loads(recs[0].splitlines()[0])
    assert rec["kind"] == "VOTE" and rec["rank"] == 1 and rec["a"] == 5


def test_profiler_annotation_and_trace(tmp_path):
    """``annotate`` names a range the profiler records around the work
    inside it; ``profile`` writes a Chrome trace holding that range."""
    with profile(str(tmp_path)) as prof:
        with annotate("rlo-allreduce"):
            x = torch.ones((8, 8)) @ torch.ones((8, 8))
    assert float(x[0, 0]) == 8.0
    names = [e.key for e in prof.key_averages()]
    assert "rlo-allreduce" in names
    ann = [e for e in prof.events() if e.name == "rlo-allreduce"]
    mm = [e for e in prof.events() if e.name in ("aten::mm", "aten::matmul")]
    assert ann and mm
    assert all(ann[0].time_range.start <= e.time_range.start
               and e.time_range.end <= ann[0].time_range.end for e in mm)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "rlo-allreduce"
               for ev in trace["traceEvents"])


def test_annotation_outside_a_profile_is_free():
    with annotate("no-profiler"):
        y = torch.arange(4).sum()
    assert int(y) == 6


def _counting_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    return entered


def test_annotation_outside_a_profile_enters_no_record_function(
        monkeypatch):
    """Outside a profile ``annotate`` opens no ``record_function`` (it
    costs ~6 us even with no profiler); inside one it does."""
    entered = _counting_record_function(monkeypatch)
    with annotate("rlo.off"):
        torch.ones(2).sum()
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with annotate("rlo.on"):
            torch.ones(2).sum()
    assert entered == ["rlo.on"]


class _FakeEvent:
    """A CUDA event's stand-in: each record is the next tick of one
    clock, a millisecond apart; ``done`` says whether the device has
    passed it."""
    clock = [0]
    done = True

    def record(self):
        _FakeEvent.clock[0] += 1
        self.t = _FakeEvent.clock[0]

    def query(self):
        return _FakeEvent.done

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_spans_path_across_threads():
    """A range opened on another thread while the main thread holds one
    is filed under its own thread's path (autograd's device thread runs
    the backward and the recompute inside the main thread's backward),
    and two threads that each hold a step keep their paths apart."""
    spans = port_tracing.DeviceSpans(event=_FakeEvent)
    with spans.timed("rlo.train.backward"):
        th = threading.Thread(target=lambda: _nested(spans))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    tot = spans.totals()
    # ticks: backward 1, recompute 2, ffn 3/4, recompute 5, backward 6
    assert tot == {"rlo.train.backward": (5e-3, 1),
                   "rlo.train.recompute": (3e-3, 1),
                   "rlo.train.recompute/rlo.layer.ffn": (1e-3, 1)}
    with spans.timed("rlo.train.optimizer"):
        pass
    assert spans.totals()["rlo.train.optimizer"] == (1e-3, 1)
    assert len(spans.totals()) == 4

    # two ranks' threads, each inside its own step, interleaved
    spans = port_tracing.DeviceSpans(event=_FakeEvent)
    opened = [threading.Barrier(2), threading.Barrier(2)]

    def rank():
        with spans.timed("rlo.train.step"):
            opened[0].wait(timeout=30)
            with spans.timed("rlo.train.forward"):
                opened[1].wait(timeout=30)

    ths = [threading.Thread(target=rank) for _ in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=30)
    assert {p: n for p, (_, n) in spans.totals().items()} == {
        "rlo.train.step": 2, "rlo.train.step/rlo.train.forward": 2}


def _nested(spans):
    with spans.timed("rlo.train.recompute"):
        with spans.timed("rlo.layer.ffn"):
            pass


def test_device_spans_keep_only_the_ranges_in_flight(monkeypatch):
    """A closed range whose events the device has passed is folded into
    the totals when the next range closes; one it has not reached waits,
    and ``totals`` waits for it."""
    spans = port_tracing.DeviceSpans(event=_FakeEvent)
    monkeypatch.setattr(_FakeEvent, "done", False)
    for _ in range(3):
        with spans.timed("rlo.layer.ffn"):
            pass
    assert len(spans._pending) == 3
    monkeypatch.setattr(_FakeEvent, "done", True)
    with spans.timed("rlo.layer.attention"):
        pass
    assert len(spans._pending) == 0
    for _ in range(1000):
        with spans.timed("rlo.layer.ffn"):
            pass
    assert len(spans._pending) == 0
    tot = spans.totals()
    assert sorted(tot) == ["rlo.layer.attention", "rlo.layer.ffn"]
    assert tot["rlo.layer.ffn"][1] == 1003
    assert tot["rlo.layer.ffn"][0] == pytest.approx(1.003)
    assert tot["rlo.layer.attention"] == (1e-3, 1)


def test_annotation_times_device_spans_only_in_a_profile(monkeypatch):
    """With CUDA up, ``annotate`` files a range's stream time under its
    path while a profiler records, and nothing outside one; its NVTX
    range opens and closes either way."""
    spans = port_tracing.DeviceSpans(event=_FakeEvent)
    nvtx = []
    monkeypatch.setattr(port_tracing, "DEVICE_SPANS", spans)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", nvtx.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: nvtx.append("pop"))
    with annotate("rlo.train.step"):
        pass
    assert spans.totals() == {}
    assert nvtx == ["rlo.train.step", "pop"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with annotate("rlo.train.step"):
            with annotate("rlo.train.forward"):
                pass
    assert spans.totals() == {"rlo.train.step": (3e-3, 1),
                              "rlo.train.step/rlo.train.forward": (1e-3, 1)}
    assert nvtx[2:] == ["rlo.train.step", "rlo.train.forward", "pop", "pop"]
