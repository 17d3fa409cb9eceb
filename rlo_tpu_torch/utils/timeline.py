"""Cross-rank causal timelines: merge per-rank tracer dumps into a
Chrome trace-event / Perfetto file.

The port's own copy of ``rlo_tpu/utils/timeline.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_observe.py`` holds them equal).

A chaos-soak run (tests/test_reliability.py) is ~10k log lines of
interleaved retransmits, dedups and view changes; this module turns
the same information into a timeline a human can scrub: one track per
rank, one slice per protocol event, and **flow edges** (the Chrome
trace ``s``/``f`` arrow pairs) connecting every store-and-forward
send to its receipt on the next hop.

Correlation model (docs/DESIGN.md §7): events are joined on the
protocol's own exactly-once identity — ``(origin, seq)`` for
Tag.BCAST (the per-origin sequence stamp receivers already dedup on)
and ``(origin, pid)`` for IAR proposals/decisions and FAILURE/ABORT
notices. The receive-side anchor is the ``BCAST_FWD`` event (emitted
on every non-duplicate receipt, including leaf receipts that forward
nothing), whose ``d`` field names the immediate sender; the send-side
anchor is that sender's own ``BCAST_INIT`` (when it is the origin) or
``BCAST_FWD`` (when it relayed). No topology knowledge is needed, so
the merge stays correct across elastic view changes.

Input: per-rank JSONL files from ``Tracer.dump_jsonl`` (or native
events from ``bindings.trace_drain()``, which share the schema), or
iterables of event dicts. Output: the Chrome trace-event JSON object
(``{"traceEvents": [...]}``), loadable in Perfetto / chrome://tracing.

CLI::

    python -m rlo_tpu_torch.utils.timeline merge --out trace.json \
        r0.jsonl r1.jsonl
    python -m rlo_tpu_torch.utils.timeline smoke   # loopback soak -> validate
    python -m rlo_tpu_torch.utils.timeline stats trace.json  # per-rank totals
"""

from __future__ import annotations

import bisect
import json
import logging
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

logger = logging.getLogger("rlo_tpu_torch.timeline")

#: transport tags whose frames are store-and-forward broadcast — the
#: tags BCAST_FWD / BCAST_INIT events can carry in ``a`` (mirror of
#: rlo_tpu_torch.wire.BCAST_TAGS; numeric to keep this module importable
#: without the engine stack)
FLOW_TAGS = {0: "bcast", 2: "proposal", 4: "decision",
             12: "failure", 14: "abort"}

#: phase-profiler stage names, indexed by the Ev.PHASE ``a`` field —
#: the metrics.ENGINE_PHASE_KEYS snapshot order (imported so the
#: timeline can never drift from the schema; utils.metrics has no
#: engine/jax dependencies, keeping this module standalone-importable)
from rlo_tpu_torch.utils.metrics import ENGINE_PHASE_KEYS as PHASE_NAMES
#: request-span stage names, indexed by the Ev.SPAN ``a`` field —
#: imported for the same no-drift reason (observe.spans depends only
#: on utils.tracing + wire, both engine/jax-free)
from rlo_tpu_torch.observe.spans import STAGE_NAMES as SPAN_STAGE_NAMES
#: collective schedule names, indexed by the Ev.STEP ``a`` field —
#: imported for the same no-drift reason (observe.ledger depends only
#: on rlo_tpu_torch.topology, engine/jax-free)
from rlo_tpu_torch.observe.ledger import ALGORITHMS as COLL_ALGORITHMS

Source = Union[str, Path, Iterable[Dict]]


def load_jsonl(path: Union[str, Path]) -> List[Dict]:
    """Load one per-rank dump, tolerating crashed-rank artifacts: a
    missing or empty file yields no events, and a truncated final line
    (the rank died mid-write) is dropped — in both cases the merge
    keeps the SURVIVING tracks instead of raising, because a partial
    timeline of a wedged chaos run is precisely when you need one.
    A malformed line anywhere except the tail still raises (that is
    corruption, not a crash artifact)."""
    out = []
    try:
        f = open(path)
    except FileNotFoundError:
        logger.warning("timeline: per-rank dump %s missing (rank "
                       "crashed before dump?); keeping other tracks",
                       path)
        return out
    with f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                logger.warning(
                    "timeline: %s truncated at line %d (rank crashed "
                    "mid-dump?); dropping the partial record", path,
                    i + 1)
                break
            raise
    if not out:
        logger.warning("timeline: per-rank dump %s is empty; keeping "
                       "other tracks", path)
    return out


def _flow_key(ev: Dict):
    """(tag, origin, identity) for a send- or receive-side anchor."""
    kind = ev.get("kind")
    if kind == "BCAST_INIT":
        return (ev.get("a"), ev.get("rank"), ev.get("c"))
    if kind == "BCAST_FWD":
        return (ev.get("a"), ev.get("b"), ev.get("c"))
    return None


def merge_timeline(sources: List[Source],
                   out_path: Optional[Union[str, Path]] = None,
                   slice_usec: int = 1) -> Dict:
    """Merge per-rank event dumps into one Chrome trace object.

    ``sources``: JSONL paths and/or iterables of event dicts (the
    ``Event.to_dict()`` / native ``trace_drain()`` schema: ts_usec,
    rank, kind, a, b, c, d). Ranks may be split across sources any
    way — events carry their rank. When ``out_path`` is given the
    trace is also written there as JSON."""
    events: List[Dict] = []
    for s in sources:
        if isinstance(s, (str, Path)):
            events.extend(load_jsonl(s))
        else:
            events.extend(s)
    events.sort(key=lambda e: (e.get("ts_usec", 0), e.get("rank", 0)))
    ranks = sorted({e["rank"] for e in events})
    t0 = events[0]["ts_usec"] if events else 0

    trace_events: List[Dict] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "ts": 0,
         "args": {"name": "rlo_tpu"}},
    ]
    for r in ranks:
        trace_events.append(
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": r,
             "ts": 0, "args": {"name": f"rank {r}"}})

    # request-span tracks (docs/DESIGN.md §19): every traced rid gets
    # its own thread under a second "requests" process — stage slices
    # land there, wire-hop receipt markers stay on the rank tracks
    span_rids = sorted({(e.get("d", 0), e.get("c", 0)) for e in events
                        if e.get("kind") == "SPAN"
                        and e.get("b", 0) >= 0})
    rid_tid = {rid: i for i, rid in enumerate(span_rids)}
    if span_rids:
        trace_events.append(
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "ts": 0, "args": {"name": "requests"}})
        for rid, tid in rid_tid.items():
            label = (f"placement v{rid[1]}" if rid[0] < 0
                     else f"req {rid[0]}:{rid[1]}")
            trace_events.append(
                {"ph": "M", "name": "thread_name", "pid": 1,
                 "tid": tid, "ts": 0, "args": {"name": label}})
    # rid -> [(end_ts, start_ts, stage, rank, slice_ts)] for the
    # per-request flow edges
    span_chain: Dict = {}

    # one X slice per protocol event (instants become short slices so
    # flow events have something to bind to)
    # send-side anchors: (tag, origin, ident) -> {rank: sorted [ts]}
    anchors: Dict = {}
    # collective step-slice starts: (alg, op*1024+step) -> {rank: ts}.
    # SPMD ranks issue ops in identical order, so the pair names ONE
    # schedule step globally and every rank contributes one anchor
    step_anchors: Dict = {}
    for e in events:
        ts = e["ts_usec"] - t0
        if e.get("kind") == "STEP":
            # collective data-plane step (docs/DESIGN.md §21): like
            # PHASE, a duration slice emitted at step END spanning
            # [end - dur, end]; named algorithm:step so a ring's
            # per-step slices line up across rank tracks
            a = e.get("a", -1)
            alg = (COLL_ALGORITHMS[a] if 0 <= a < len(COLL_ALGORITHMS)
                   else f"alg{a}")
            c = e.get("c", 0)
            dur = max(int(e.get("b", 0)), slice_usec)
            start = max(0, ts - dur)
            trace_events.append({
                "ph": "X", "cat": "coll", "name": f"{alg}:{c % 1024}",
                "pid": 0, "tid": e["rank"], "ts": start, "dur": dur,
                "args": {"op": c // 1024, "step": c % 1024,
                         "usec": e.get("b", 0),
                         "from": e.get("d", -1)}})
            step_anchors.setdefault((a, c), {})[e["rank"]] = start
            continue
        if e.get("kind") == "PHASE":
            # profiler stage sample (docs/DESIGN.md §10): a true
            # duration slice — emitted at stage END with the measured
            # duration in b, so the slice spans [end - dur, end] and
            # nests visually under the protocol events it timed
            a = e.get("a", -1)
            name = (PHASE_NAMES[a] if 0 <= a < len(PHASE_NAMES)
                    else f"phase{a}")
            dur = max(int(e.get("b", 0)), slice_usec)
            trace_events.append({
                "ph": "X", "cat": "phase", "name": name, "pid": 0,
                "tid": e["rank"], "ts": max(0, ts - dur), "dur": dur,
                "args": {"usec": e.get("b", 0)},
            })
            continue
        if e.get("kind") == "SPAN":
            stage = e.get("a", -1)
            name = SPAN_STAGE_NAMES.get(stage, f"stage{stage}")
            rid = (e.get("d", 0), e.get("c", 0))
            rid_s = f"{rid[0]}:{rid[1]}"
            dur = int(e.get("b", 0))
            if dur < 0:
                # wire-hop receipt of a span-stamped record: an
                # instant on the RANK track, not a stage boundary
                trace_events.append({
                    "ph": "X", "cat": "span_hop",
                    "name": f"hop {name}", "pid": 0,
                    "tid": e["rank"], "ts": ts, "dur": slice_usec,
                    "args": {"rid": rid_s}})
                continue
            slice_ts = max(0, ts - dur)
            trace_events.append({
                "ph": "X", "cat": "span", "name": name, "pid": 1,
                "tid": rid_tid[rid], "ts": slice_ts,
                "dur": max(dur, slice_usec),
                "args": {"rid": rid_s, "rank": e["rank"],
                         "usec": dur}})
            span_chain.setdefault(rid, []).append(
                (ts, ts - dur, stage, e["rank"], slice_ts))
            continue
        trace_events.append({
            "ph": "X", "cat": "proto", "name": e["kind"],
            "pid": 0, "tid": e["rank"], "ts": ts, "dur": slice_usec,
            "args": {k: e.get(k, 0) for k in ("a", "b", "c", "d")},
        })
        key = _flow_key(e)
        if key is not None:
            anchors.setdefault(key, {}).setdefault(
                e["rank"], []).append(ts)
    for per_rank in anchors.values():
        for lst in per_rank.values():
            lst.sort()

    # flow edges: every receive anchor points back at the immediate
    # sender's latest same-identity anchor at or before the receive
    flow_id = 0
    for e in events:
        if e.get("kind") != "BCAST_FWD":
            continue
        key = _flow_key(e)
        src = e.get("d", -1)
        sender_ts = anchors.get(key, {}).get(src)
        if not sender_ts:
            continue  # sender's dump missing (partial capture): skip
        recv_ts = e["ts_usec"] - t0
        i = bisect.bisect_right(sender_ts, recv_ts) - 1
        if i < 0:
            # every same-identity sender anchor is LATER than the
            # receive — cross-process clock skew; a backwards edge
            # would fail validation, so skip it like a missing dump
            continue
        send_ts = sender_ts[i]
        name = FLOW_TAGS.get(e.get("a"), f"tag{e.get('a')}")
        label = f"{name} {key[1]}:{key[2]}"
        flow_id += 1
        trace_events.append({"ph": "s", "cat": "flow", "name": label,
                             "id": flow_id, "pid": 0, "tid": src,
                             "ts": send_ts})
        trace_events.append({"ph": "f", "bp": "e", "cat": "flow",
                             "name": label, "id": flow_id, "pid": 0,
                             "tid": e["rank"], "ts": recv_ts})

    # per-hop collective flow edges (docs/DESIGN.md §21): every step
    # completion that received data points back at the sender's step
    # slice START — the sender transmits at the top of its step, so
    # the receiver's completion is causally no earlier; a violation
    # (cross-process clock skew) is skipped like a missing dump
    for e in events:
        if e.get("kind") != "STEP":
            continue
        src = e.get("d", -1)
        if src < 0:
            continue  # send-only step: no receive edge to draw
        key = (e.get("a", -1), e.get("c", 0))
        send_ts = step_anchors.get(key, {}).get(src)
        recv_ts = e["ts_usec"] - t0
        if send_ts is None or recv_ts < send_ts:
            continue
        a = e.get("a", -1)
        alg = (COLL_ALGORITHMS[a] if 0 <= a < len(COLL_ALGORITHMS)
               else f"alg{a}")
        label = f"{alg}:{e.get('c', 0) % 1024}"
        flow_id += 1
        trace_events.append({"ph": "s", "cat": "coll_flow",
                             "name": label, "id": flow_id, "pid": 0,
                             "tid": src, "ts": send_ts})
        trace_events.append({"ph": "f", "bp": "e", "cat": "coll_flow",
                             "name": label, "id": flow_id, "pid": 0,
                             "tid": e["rank"], "ts": recv_ts})

    # per-request causal chain: arrows between consecutive spans of a
    # rid in the analyzer's (end, start, stage, rank) total order —
    # the same order rlo-trace walks, so the rendered chain IS the
    # attribution chain
    for rid, chain in span_chain.items():
        chain.sort()
        tid = rid_tid[rid]
        label = f"req {rid[0]}:{rid[1]}"
        for (a_end, *_r1, a_slice), (b_end, _bs, _st, _rk, b_slice) \
                in zip(chain, chain[1:]):
            flow_id += 1
            trace_events.append(
                {"ph": "s", "cat": "span_flow", "name": label,
                 "id": flow_id, "pid": 1, "tid": tid, "ts": a_end})
            trace_events.append(
                {"ph": "f", "bp": "e", "cat": "span_flow",
                 "name": label, "id": flow_id, "pid": 1, "tid": tid,
                 "ts": max(b_slice, a_end)})

    trace = {"traceEvents": trace_events, "displayTimeUnit": "ms",
             "otherData": {"generator": "rlo_tpu_torch.utils.timeline",
                           "ranks": ranks, "events": len(events),
                           "flow_edges": flow_id}}
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(trace, f)
    return trace


def count_flow_edges(trace: Dict) -> int:
    return sum(1 for e in trace.get("traceEvents", [])
               if e.get("ph") == "s")


def trace_stats(trace: Dict) -> Dict:
    """Per-rank totals from a merged Chrome trace — the quick triage
    view an incident bundle links to (docs/DESIGN.md §17): protocol
    event counts by kind, phase-profiler slice counts + total usec by
    stage, collective step slices + total usec by algorithm (§21),
    and flow edges sent/received per rank."""
    ranks: Dict[int, Dict] = {}

    def ent(tid) -> Dict:
        e = ranks.get(tid)
        if e is None:
            e = ranks[tid] = {"events": {}, "phases": {}, "coll": {},
                              "flows_out": 0, "flows_in": 0}
        return e

    #: per-request span totals (--by-request): rid -> stage usec/count
    requests: Dict[str, Dict] = {}

    def req_ent(rid: str) -> Dict:
        e = requests.get(rid)
        if e is None:
            e = requests[rid] = {"spans": 0, "hops": 0, "stages": {}}
        return e

    for e in trace.get("traceEvents", []):
        ph = e.get("ph")
        tid = e.get("tid", -1)
        if ph == "X":
            cat = e.get("cat")
            if cat == "phase":
                slot = ent(tid)["phases"].setdefault(
                    e.get("name", "?"), {"count": 0, "usec": 0})
                slot["count"] += 1
                slot["usec"] += int(e.get("args", {}).get(
                    "usec", e.get("dur", 0)))
            elif cat == "span":
                r = req_ent(e.get("args", {}).get("rid", "?"))
                r["spans"] += 1
                name = e.get("name", "?")
                slot = r["stages"].setdefault(
                    name, {"count": 0, "usec": 0})
                slot["count"] += 1
                slot["usec"] += int(e.get("args", {}).get("usec", 0))
            elif cat == "coll":
                # bucket by algorithm (the name's prefix), not per
                # step — the per-step view is rlo-scope's job
                alg = e.get("name", "?").rsplit(":", 1)[0]
                slot = ent(tid)["coll"].setdefault(
                    alg, {"count": 0, "usec": 0})
                slot["count"] += 1
                slot["usec"] += int(e.get("args", {}).get(
                    "usec", e.get("dur", 0)))
            elif cat == "span_hop":
                req_ent(e.get("args", {}).get("rid", "?"))["hops"] += 1
            else:
                evs = ent(tid)["events"]
                name = e.get("name", "?")
                evs[name] = evs.get(name, 0) + 1
        elif ph == "s" and e.get("cat") != "span_flow":
            ent(tid)["flows_out"] += 1
        elif ph == "f" and e.get("cat") != "span_flow":
            ent(tid)["flows_in"] += 1
    return {"ranks": {str(r): ranks[r] for r in sorted(ranks)},
            "events_total": sum(
                sum(e["events"].values()) for e in ranks.values()),
            "flow_edges": count_flow_edges(trace),
            "requests": {r: requests[r] for r in sorted(requests)}}


def render_trace_stats(stats: Dict) -> str:
    """Text table for :func:`trace_stats`."""
    kinds: List[str] = sorted({k for e in stats["ranks"].values()
                               for k in e["events"]})
    lines = [f"timeline stats — {stats['events_total']} protocol "
             f"events, {stats['flow_edges']} flow edges"]
    hdr = "rank " + " ".join(f"{k:>12}" for k in kinds) + \
        "   flows(out/in)   phase slices (total usec)"
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for r, e in stats["ranks"].items():
        row = f"{r:>4} " + " ".join(
            f"{e['events'].get(k, 0):>12}" for k in kinds)
        row += f"   {e['flows_out']:>5}/{e['flows_in']:<5}"
        if e["phases"]:
            tot = sum(p["count"] for p in e["phases"].values())
            usec = sum(p["usec"] for p in e["phases"].values())
            row += f"   {tot} ({usec} us)"
        if e.get("coll"):
            tot = sum(p["count"] for p in e["coll"].values())
            usec = sum(p["usec"] for p in e["coll"].values())
            row += f"   coll {tot} ({usec} us)"
        lines.append(row)
    return "\n".join(lines)


def render_request_stats(stats: Dict) -> str:
    """Text table for the per-request block of :func:`trace_stats`
    (``stats --by-request``): one row per traced rid with its span /
    hop counts and per-stage usec totals — the incident-bundle triage
    view for a tripped latency SLO (docs/DESIGN.md §19)."""
    reqs = stats.get("requests", {})
    lines = [f"timeline stats --by-request — {len(reqs)} traced "
             f"requests"]
    if not reqs:
        return lines[0]
    stages = sorted({s for r in reqs.values() for s in r["stages"]})
    hdr = f"{'rid':>12} {'spans':>6} {'hops':>5} " + \
        " ".join(f"{s:>14}" for s in stages)
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for rid, r in reqs.items():
        row = f"{rid:>12} {r['spans']:>6} {r['hops']:>5} "
        row += " ".join(
            f"{r['stages'][s]['usec']:>14}" if s in r["stages"]
            else f"{'-':>14}" for s in stages)
        lines.append(row)
    return "\n".join(lines)


def validate_chrome_trace(trace: Dict) -> None:
    """Validate the Chrome trace-event JSON schema (the subset this
    module emits): raises ValueError on the first violation. Checks
    JSON-serializability, required per-event fields, and that every
    flow start has a matching finish no earlier than it."""
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as ex:
        raise ValueError(f"trace is not JSON-serializable: {ex}")
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    starts: Dict = {}
    finishes: Dict = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = e.get("ph")
        if ph not in ("M", "X", "B", "E", "i", "s", "t", "f"):
            raise ValueError(f"traceEvents[{i}]: unknown ph {ph!r}")
        for fld in ("name", "pid", "tid"):
            if fld not in e:
                raise ValueError(f"traceEvents[{i}]: missing {fld!r}")
        if ph != "M" and "ts" not in e:
            raise ValueError(f"traceEvents[{i}]: missing 'ts'")
        if ph == "X":
            if not isinstance(e.get("dur"), (int, float)) \
                    or e["dur"] < 0:
                raise ValueError(
                    f"traceEvents[{i}]: X event needs dur >= 0")
        if ph in ("s", "f"):
            if "id" not in e:
                raise ValueError(f"traceEvents[{i}]: flow without id")
            (starts if ph == "s" else finishes)[e["id"]] = e
    for fid, s in starts.items():
        f = finishes.get(fid)
        if f is None:
            raise ValueError(f"flow {fid}: start without finish")
        if f["ts"] < s["ts"]:
            raise ValueError(f"flow {fid}: finish before start")
    for fid in finishes:
        if fid not in starts:
            raise ValueError(f"flow {fid}: finish without start")


# ---------------------------------------------------------------------------
# CLI: merge files, or run the self-contained loopback smoke
# ---------------------------------------------------------------------------

def _smoke(out: Optional[str]) -> Dict:
    """4-rank loopback soak with tracing + metrics on, loss/duplication
    injection and ARQ recovery; dump per-rank JSONL, merge, validate.
    The check.sh observability smoke step (and a usage example)."""
    import tempfile

    from rlo_tpu_torch.engine import EngineManager, ProgressEngine, drain
    from rlo_tpu_torch.transport.loopback import LoopbackWorld
    from rlo_tpu_torch.utils.tracing import TRACER

    ws = 4
    world = LoopbackWorld(ws, latency=2, seed=7)
    mgr = EngineManager()
    engines = [ProgressEngine(world.transport(r), manager=mgr,
                              arq_rto=0.01) for r in range(ws)]
    for e in engines:
        e.enable_metrics()
        e.enable_profiler()  # §10 phase slices ride the same timeline
    TRACER.clear()
    with TRACER.enable():
        world.dup_next(0, 1, 2)
        world.drop_next(1, 3, 1)
        for i in range(6):
            engines[i % ws].bcast(f"m{i}".encode())
        drain([world], engines)
        for e in engines:
            while e.pickup_next() is not None:
                pass
        engines[1].submit_proposal(b"smoke", pid=9)
        drain([world], engines)
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for r in range(ws):
            p = str(Path(td) / f"rank{r}.jsonl")
            TRACER.dump_jsonl(p, rank=r)
            paths.append(p)
        trace = merge_timeline(paths, out_path=out)
    TRACER.clear()
    validate_chrome_trace(trace)
    edges = count_flow_edges(trace)
    if edges < 1:
        raise AssertionError("smoke produced no flow edges")
    phase_slices = sum(1 for ev in trace["traceEvents"]
                       if ev.get("cat") == "phase")
    if phase_slices < 1:
        raise AssertionError("smoke produced no profiler phase slices")
    snap = engines[0].metrics()
    if snap["phases"]["send"]["count"] < 1:
        raise AssertionError("profiler recorded no send-stage samples")
    for e in engines:
        e.cleanup()
    return {"ok": True, "ranks": ws, "events": trace["otherData"]["events"],
            "flow_edges": edges, "phase_slices": phase_slices,
            "rank0_tx_frames": sum(l["tx_frames"]
                                   for l in snap["links"].values())}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="merge per-rank JSONL dumps")
    mp.add_argument("inputs", nargs="+")
    mp.add_argument("--out", required=True)
    sp = sub.add_parser("smoke", help="loopback soak -> timeline -> "
                                      "schema validation")
    sp.add_argument("--out", default=None)
    st = sub.add_parser("stats", help="per-rank frame/phase totals "
                                      "from a merged trace (the "
                                      "incident-bundle triage view)")
    st.add_argument("trace", help="merged Chrome trace JSON (the "
                                  "merge subcommand's --out, or an "
                                  "incident bundle's trace.json)")
    st.add_argument("--json", action="store_true")
    st.add_argument("--by-request", action="store_true",
                    help="per-rid span/stage totals instead of the "
                         "per-rank table (traced runs, docs/DESIGN.md "
                         "§19)")
    args = ap.parse_args(argv)
    if args.cmd == "stats":
        with open(args.trace) as f:
            stats = trace_stats(json.load(f))
        if args.json:
            print(json.dumps(stats))
        elif args.by_request:
            print(render_request_stats(stats))
        else:
            print(render_trace_stats(stats))
        return 0
    if args.cmd == "merge":
        trace = merge_timeline(args.inputs, out_path=args.out)
        validate_chrome_trace(trace)
        print(json.dumps({"ok": True,
                          "events": trace["otherData"]["events"],
                          "flow_edges": count_flow_edges(trace),
                          "out": args.out}))
        return 0
    print(json.dumps(_smoke(args.out)))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
