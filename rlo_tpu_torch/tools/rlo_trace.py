"""rlo-trace — fleet-wide causal request tracing analyzer
(docs/DESIGN.md §19).

The port's copy of ``rlo_tpu/tools/rlo_trace.py``, over the port's
``observe/spans.py`` and ``utils/tracing.Ev``.

Consumes ``Ev.SPAN`` events — either merged from per-rank tracer JSONL
dumps (``Tracer.dump_jsonl``, one file per rank/process) or captured
live from a seeded fabric scenario (``--scenario``) — reconstructs each
request's span set, computes its CRITICAL PATH, and prints fleet
latency attribution: p50/p99 TTFT and e2e decomposed by stage, plus a
``--request GW:SEQ`` single-request waterfall.

The critical path is the deterministic backward walk from the
request's last ``deliver`` span: at each step the predecessor is the
latest-finishing span that ended at or before the current span's
start (ties broken by the total (end, start, stage, rank) order), so
the walk telescopes — per-stage attribution sums EXACTLY to the
request's end-to-end latency in integer microseconds. Wire-hop
receipt markers (duration -1) never join the critical path; they are
reported as hop counts and rendered by the timeline tool.

All numbers derive from span vtimes (the engine's injectable clock),
so the same seeded scenario produces bit-identical reports across
runs — the property check.sh's smoke gate and
tests/test_spans.py pin.

Shared runner conventions (tools/runner.py): ``--json`` for a
machine-readable report, exit 0 clean / 1 findings (incomplete or
inconsistent traces) / 2 unusable input.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from rlo_tpu_torch.observe.spans import STAGE_NAMES, Stage
from rlo_tpu_torch.tools.runner import Finding, ToolError
from rlo_tpu_torch.utils.tracing import Ev

Rid = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Span:
    """One stage-boundary span, integer-usec endpoints on the engine
    clock. ``sort_key`` is the total order every deterministic
    tie-break in the analyzer uses."""
    rid: Rid
    stage: int
    start: int
    end: int
    rank: int

    @property
    def sort_key(self) -> Tuple[int, int, int, int]:
        return (self.end, self.start, self.stage, self.rank)

    def to_dict(self) -> Dict:
        return {"stage": STAGE_NAMES.get(self.stage, str(self.stage)),
                "start_usec": self.start, "end_usec": self.end,
                "rank": self.rank}


def parse_rid(text: str) -> Rid:
    """'GW:SEQ' -> (gw, seq)."""
    try:
        gw, seq = text.split(":")
        return (int(gw), int(seq))
    except ValueError:
        raise ToolError(f"bad --request {text!r}: want GW:SEQ")


def rid_str(rid: Rid) -> str:
    return f"{rid[0]}:{rid[1]}"


def _norm(ev) -> Optional[Tuple[int, int, int, int, int, int]]:
    """One SPAN event -> (ts, rank, a, b, c, d), or None for any other
    kind. Accepts live ``tracing.Event`` objects and JSONL dicts."""
    if isinstance(ev, dict):
        if ev.get("kind") != "SPAN":
            return None
        return (int(ev["ts_usec"]), int(ev["rank"]), int(ev["a"]),
                int(ev["b"]), int(ev["c"]), int(ev["d"]))
    if ev.kind != Ev.SPAN:
        return None
    return (ev.ts_usec, ev.rank, ev.a, ev.b, ev.c, ev.d)


def collect(events) -> Tuple[Dict[Rid, List[Span]],
                             Dict[Rid, int]]:
    """Group SPAN events by rid: stage-boundary spans (duration >= 0)
    and wire-hop receipt counts (duration -1)."""
    spans: Dict[Rid, List[Span]] = {}
    hops: Dict[Rid, int] = {}
    for ev in events:
        t = _norm(ev)
        if t is None:
            continue
        ts, rank, stage, dur, seq, gw = t
        rid = (gw, seq)
        if dur < 0:
            hops[rid] = hops.get(rid, 0) + 1
        else:
            spans.setdefault(rid, []).append(
                Span(rid, stage, ts - dur, ts, rank))
    return spans, hops


def critical_path(spans: Sequence[Span]) -> Optional[List[Span]]:
    """Deterministic backward walk from the latest ``deliver`` span;
    None when the request never delivered (incomplete trace)."""
    order = sorted(spans, key=lambda s: s.sort_key)
    delivers = [i for i, s in enumerate(order)
                if s.stage == Stage.DELIVER]
    if not delivers:
        return None
    t0 = min(s.start for s in order)
    at = delivers[-1]
    path = [order[at]]
    while order[at].start > t0:
        # latest-finishing strict predecessor in the total order whose
        # end fits before the current span starts — the index strictly
        # decreases, so the walk terminates even across zero-duration
        # markers
        pred = None
        for j in range(at - 1, -1, -1):
            if order[j].end <= order[at].start:
                pred = j
                break
        if pred is None:
            break
        at = pred
        path.append(order[at])
    path.reverse()
    return path


def analyze_request(spans: Sequence[Span]) -> Optional[Dict]:
    """Critical path + exact integer attribution for one rid; None
    when the request never delivered."""
    path = critical_path(spans)
    if path is None:
        return None
    t0 = min(s.start for s in spans)
    attr: Dict[int, int] = {}
    prev = t0
    for s in path:
        attr[s.stage] = attr.get(s.stage, 0) + (s.end - prev)
        prev = s.end
    e2e = path[-1].end - t0
    queues = sorted((s for s in spans if s.stage == Stage.QUEUE),
                    key=lambda s: s.sort_key)
    ttft = queues[0].end - t0 if queues else None
    return {
        "t0_usec": t0,
        "e2e_usec": e2e,
        "ttft_usec": ttft,
        "path": path,
        "attribution": attr,
        "requeues": sum(1 for s in path
                        if s.stage == Stage.REQUEUE),
    }


def percentile(vals: Sequence[int], q: float) -> Optional[int]:
    """Nearest-rank percentile over integers — deterministic, no
    interpolation (bit-for-bit across runs is the contract)."""
    if not vals:
        return None
    vs = sorted(vals)
    return vs[max(0, math.ceil(q / 100.0 * len(vs)) - 1)]


def analyze(events, request: Optional[Rid] = None
            ) -> Tuple[Dict, List[Finding]]:
    """Fleet report + findings over merged SPAN events."""
    spans, hops = collect(events)
    client = {rid: v for rid, v in spans.items() if rid[0] >= 0}
    placement = {rid: v for rid, v in spans.items() if rid[0] < 0}
    findings: List[Finding] = []
    per_req: Dict[Rid, Dict] = {}
    for rid in sorted(client):
        r = analyze_request(client[rid])
        if r is None:
            findings.append(Finding(
                "T1", "<trace>", 0,
                f"request {rid_str(rid)} has spans but never "
                f"delivered (incomplete trace)", severity="warning"))
            continue
        if sum(r["attribution"].values()) != r["e2e_usec"]:
            findings.append(Finding(
                "T2", "<trace>", 0,
                f"request {rid_str(rid)} attribution does not "
                f"telescope to e2e — analyzer invariant broken"))
        per_req[rid] = r

    e2e = [r["e2e_usec"] for r in per_req.values()]
    ttft = [r["ttft_usec"] for r in per_req.values()
            if r["ttft_usec"] is not None]
    stages: Dict[str, Dict] = {}
    total_e2e = sum(e2e)
    for sid in sorted(STAGE_NAMES):
        per = [r["attribution"][sid] for r in per_req.values()
               if sid in r["attribution"]]
        if not per:
            continue
        tot = sum(per)
        stages[STAGE_NAMES[sid]] = {
            "count": len(per),
            "total_usec": tot,
            "share_pct": round(100.0 * tot / total_e2e, 2)
            if total_e2e else 0.0,
            "p50_usec": percentile(per, 50),
            "p99_usec": percentile(per, 99),
        }
    report = {
        "requests": len(client),
        "complete": len(per_req),
        "ttft_usec": {"p50": percentile(ttft, 50),
                      "p99": percentile(ttft, 99)},
        "e2e_usec": {"p50": percentile(e2e, 50),
                     "p99": percentile(e2e, 99)},
        "stages": stages,
        "failover": sorted(rid_str(r) for r, v in per_req.items()
                           if v["requeues"] > 0),
        "placement_rounds": len(placement),
        "wire_hops": sum(hops.values()),
    }
    if request is not None:
        if request not in client:
            raise ToolError(f"request {rid_str(request)} has no spans "
                            f"in the trace")
        r = per_req.get(request)
        detail = {
            "rid": rid_str(request),
            "spans": [s.to_dict() for s in
                      sorted(client[request],
                             key=lambda s: s.sort_key)],
            "hops": hops.get(request, 0),
        }
        if r is not None:
            detail.update(
                t0_usec=r["t0_usec"], e2e_usec=r["e2e_usec"],
                ttft_usec=r["ttft_usec"], requeues=r["requeues"],
                critical_path=[s.to_dict() for s in r["path"]],
                attribution={STAGE_NAMES[k]: v for k, v in
                             sorted(r["attribution"].items())})
        report["request"] = detail
    return report, findings


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def load_dumps(paths: Sequence[str]) -> List[Dict]:
    """Merge per-rank tracer JSONL dumps into one event list."""
    events: List[Dict] = []
    for p in paths:
        path = Path(p)
        if not path.exists():
            raise ToolError(f"no such dump: {p}")
        try:
            with open(path) as f:
                for ln, line in enumerate(f, start=1):
                    line = line.strip()
                    if line:
                        events.append(json.loads(line))
        except (OSError, json.JSONDecodeError) as e:
            raise ToolError(f"unreadable dump {p}: {e}")
    return events


def run_scenario(kind: str, seed: int, world_size: int,
                 sample: int) -> List:
    """Run a seeded traced fabric scenario and return its live span
    ring — the self-contained smoke path check.sh gates."""
    from rlo_tpu_torch.serving.scenario import make_fabric_scenario
    from rlo_tpu_torch.transport.sim import FABRIC_SCENARIO_KINDS
    if kind not in FABRIC_SCENARIO_KINDS:
        raise ToolError(f"unknown scenario {kind!r} "
                        f"(have {', '.join(FABRIC_SCENARIO_KINDS)})")
    sc = make_fabric_scenario(kind, seed, world_size=world_size)
    sc.trace_sample = sample
    sc.run()
    return sc.tracer.events()


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _fmt_usec(v: Optional[int]) -> str:
    if v is None:
        return "-"
    return f"{v / 1e3:.1f}ms" if v >= 1000 else f"{v}us"

def render(report: Dict) -> str:
    out = [f"rlo-trace: {report['complete']}/{report['requests']} "
           f"requests delivered, {report['placement_rounds']} "
           f"placement rounds, {report['wire_hops']} wire hops"]
    t, e = report["ttft_usec"], report["e2e_usec"]
    out.append(f"  ttft  p50 {_fmt_usec(t['p50'])}  "
               f"p99 {_fmt_usec(t['p99'])}")
    out.append(f"  e2e   p50 {_fmt_usec(e['p50'])}  "
               f"p99 {_fmt_usec(e['p99'])}")
    out.append("  critical-path attribution by stage:")
    for name, s in report["stages"].items():
        out.append(f"    {name:<14} {s['share_pct']:6.2f}%  "
                   f"p50 {_fmt_usec(s['p50_usec']):>9}  "
                   f"p99 {_fmt_usec(s['p99_usec']):>9}  "
                   f"(n={s['count']})")
    if report["failover"]:
        out.append(f"  failover (requeue on critical path): "
                   f"{', '.join(report['failover'])}")
    req = report.get("request")
    if req is not None:
        out.append(f"  request {req['rid']} waterfall "
                   f"({req['hops']} hops):")
        if "critical_path" not in req:
            out.append("    (never delivered)")
            for s in req["spans"]:
                out.append(f"    {s['stage']:<14} rank {s['rank']} "
                           f"[{s['start_usec']}..{s['end_usec']}]")
        else:
            crit = {(s["stage"], s["start_usec"], s["end_usec"],
                     s["rank"]) for s in req["critical_path"]}
            t0 = req["t0_usec"]
            for s in req["spans"]:
                mark = "*" if (s["stage"], s["start_usec"],
                               s["end_usec"], s["rank"]) in crit \
                    else " "
                out.append(
                    f"   {mark}{s['stage']:<14} rank "
                    f"{s['rank']:<3} +{s['start_usec'] - t0:>8} .. "
                    f"+{s['end_usec'] - t0:>8}")
            out.append(f"    e2e {_fmt_usec(req['e2e_usec'])}, ttft "
                       f"{_fmt_usec(req.get('ttft_usec'))}, "
                       f"requeues {req['requeues']} "
                       f"(* = critical path)")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rlo_tpu_torch.tools.rlo_trace",
        description="Causal request-trace analyzer: merge per-rank "
                    "tracer JSONL dumps (or run a seeded traced "
                    "scenario) and print fleet critical-path latency "
                    "attribution (docs/DESIGN.md §19).")
    ap.add_argument("dumps", nargs="*",
                    help="per-rank tracer JSONL dumps to merge")
    ap.add_argument("--scenario", default=None, metavar="KIND",
                    help="run a seeded traced fabric scenario instead "
                         "of reading dumps (fabric_kill, ...)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=8)
    ap.add_argument("--sample", type=int, default=1,
                    help="trace 1/N of requests (scenario mode)")
    ap.add_argument("--request", default=None, metavar="GW:SEQ",
                    help="single-request waterfall detail")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the text report (findings only)")
    args = ap.parse_args(argv)
    try:
        if args.scenario is not None:
            events = run_scenario(args.scenario, args.seed,
                                  args.world_size, args.sample)
        elif args.dumps:
            events = load_dumps(args.dumps)
        else:
            raise ToolError("nothing to analyze: pass JSONL dumps or "
                            "--scenario KIND")
        rid = parse_rid(args.request) if args.request else None
        report, findings = analyze(events, request=rid)
    except ToolError as e:
        print(f"rlo-trace: error: {e}", file=sys.stderr)
        return 2
    if args.json:
        report["findings"] = [f.to_json() for f in findings]
        json.dump(report, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        if not args.quiet:
            print(render(report))
        for f in findings:
            print(f)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
