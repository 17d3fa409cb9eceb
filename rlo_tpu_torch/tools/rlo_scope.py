"""rlo-scope — collective data-plane observatory (docs/DESIGN.md §21).

The port's copy of ``rlo_tpu/tools/rlo_scope.py``, over the port's
``observe/ledger.py`` and ``ops/collectives.py``.

Joins measured Ev.STEP timings from the instrumented engine-substrate
collectives (ops/collectives.py ``Comm.instrument``) against the
deterministic cost ledger (observe/ledger.py) and attributes bandwidth
per schedule step:

  - per-step achieved GB/s (ledger edge bytes over the step's median
    completion-to-completion duration across ranks);
  - predicted-vs-measured deviation: step counts and payload bytes the
    instrumentation observed vs what the ledger says the proven
    schedule moves — any mismatch is a finding, because the ledger is
    cross-checked against rlo-prover P2 and cannot itself be wrong
    without failing tests/test_ledger.py;
  - straggler edges: ranks whose step duration exceeds 1.5x the
    fleet median for that step;
  - a bus-utilisation headline: ideal schedule span (steps x the
    fabric's minimum hop latency) over the measured span.

Two input modes, same report:

  - **seeded sim run** (default; the check.sh smoke): spin the
    requested schedule over the deterministic SimWorld substrate with
    instrumentation on — the report is bit-for-bit reproducible per
    (schedule, n, seed);
  - **per-rank tracer dumps**: merge ``Tracer.dump_jsonl`` files from
    a real run and join the same ledger (``--nbytes`` tells the join
    what the payload was; events deliberately do not carry bytes).

Soundness caveat (also in DESIGN.md §21): SimWorld models per-hop
LATENCY, not wire bandwidth, so sim-substrate "GB/s" figures are
relative attribution weights — good for finding the slow step or rank,
meaningless as absolute throughput.  Wall-clock GB/s legs live in
benchmarks/collective_bench.py.

Exit codes (shared runner contract): 0 clean, 1 findings, 2 bad
invocation.  ``--json`` emits the machine-readable report.

This module is in rlo-lint R5's determinism scope: no wall clock, no
module-level randomness — time comes from the sim's virtual clock or
from the dumps.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from rlo_tpu_torch.observe.ledger import (ALG_IDS, ALGORITHMS, COMPOSITES,
                                    Ledger, LedgerError, ledger)
from rlo_tpu_torch.tools.runner import Finding, ToolError, emit

#: schedules the seeded sim mode can drive end-to-end on the
#: engine-substrate Comm (allreduce verifies a numeric result too)
SIM_SCHEDULES = ("ring_allreduce", "recursive_doubling")

#: default payload: 1 MB of f32 per rank — BASELINE.json config 1
DEFAULT_NBYTES = 1 << 20


# ---------------------------------------------------------------------------
# seeded sim substrate run
# ---------------------------------------------------------------------------

def run_sim_collective(schedule: str, n: int, nbytes: int,
                       seed: int) -> Dict:
    """Run one instrumented ``schedule`` over an n-rank SimWorld and
    return its raw observation bundle: STEP events, per-rank counter
    totals, the SimWorld schedule digest, virtual wall span, and a
    result-correctness flag.  Deterministic per (schedule, n, seed) —
    benchmarks/collective_bench.py pins these figures exactly."""
    import numpy as np

    from rlo_tpu_torch.ops.collectives import Comm
    from rlo_tpu_torch.transport.sim import SimWorld
    from rlo_tpu_torch.utils.tracing import Tracer

    if schedule not in SIM_SCHEDULES:
        raise ToolError(f"unknown sim schedule {schedule!r} "
                        f"(have {', '.join(SIM_SCHEDULES)})")
    if n < 2:
        raise ToolError(f"need n >= 2 ranks, got {n}")
    if nbytes % 4:
        raise ToolError(f"--nbytes must be f32-aligned, got {nbytes}")
    algorithm = "ring" if schedule == "ring_allreduce" \
        else "recursive_doubling"
    world = SimWorld(n, seed=seed)
    comms = [Comm(world.transport(r)) for r in range(n)]
    tracer = Tracer(enabled=True)
    for c in comms:
        c.instrument(world.clock, tracer)
    xs = [np.full(nbytes // 4, float(r + 1), dtype=np.float32)
          for r in range(n)]
    coros = [c.allreduce(x, algorithm=algorithm)
             for c, x in zip(comms, xs)]
    results: List = [None] * n
    alive = set(range(n))
    for _ in range(10_000_000):
        for i in list(alive):
            try:
                next(coros[i])
            except StopIteration as e:
                results[i] = e.value
                alive.discard(i)
        if not alive:
            break
        world.step()
    if alive:
        raise ToolError(f"{schedule} deadlocked on the sim substrate "
                        f"(ranks {sorted(alive)} never finished)")
    expect = float(n * (n + 1) // 2)
    correct = all(r is not None and bool(np.all(r == expect))
                  for r in results)
    return {
        "schedule": schedule, "n": n, "nbytes": nbytes, "seed": seed,
        "events": [e.to_dict() for e in tracer.events()],
        "coll_steps": [c.coll_steps for c in comms],
        "coll_bytes": [c.coll_bytes for c in comms],
        "schedule_digest": world.schedule_digest(),
        "min_delay_usec": int(world.min_delay * 1e6),
        "result_correct": correct,
        "sim_events": world.events,
        "drain_vtime_usec": int(world.now * 1e6),
    }


# ---------------------------------------------------------------------------
# ledger join + attribution
# ---------------------------------------------------------------------------

def _ledger_for(schedule: str, n: int, nbytes: int) -> Ledger:
    try:
        return ledger(schedule, n, nbytes)
    except LedgerError as e:
        raise ToolError(f"cannot build the {schedule} ledger for "
                        f"n={n}: {e}")


def _infer_schedule(algs: Sequence[str]) -> str:
    """Name the (possibly composite) schedule a set of atomic
    algorithm names came from — dump mode's join key."""
    present = set(algs)
    for comp, phases in COMPOSITES.items():
        if present == set(phases):
            return comp
    if len(present) == 1:
        return next(iter(present))
    raise ToolError(f"events mix schedules {sorted(present)}; pass "
                    f"--schedule to disambiguate")


def analyze(events: Sequence[Dict], schedule: Optional[str],
            nbytes: int, *, measured_steps: Optional[List[int]] = None,
            measured_bytes: Optional[List[int]] = None,
            min_delay_usec: Optional[int] = None,
            result_correct: Optional[bool] = None) -> Tuple[
                Dict, List[Finding]]:
    """Join STEP ``events`` (Event.to_dict schema) against the cost
    ledger and build the attribution report + findings."""
    steps_ev = [e for e in events if e.get("kind") == "STEP"]
    if not steps_ev:
        raise ToolError("no Ev.STEP events to analyze — was the run "
                        "instrumented (Comm.instrument)?")
    ranks = sorted({e["rank"] for e in steps_ev})
    n = len(ranks)
    algs = [ALGORITHMS[e["a"]] if 0 <= e["a"] < len(ALGORITHMS)
            else None for e in steps_ev]
    if None in algs:
        raise ToolError("events carry unknown schedule ids — dump is "
                        "newer than this checkout's ALGORITHMS table?")
    if schedule is None:
        schedule = _infer_schedule(algs)
    led = _ledger_for(schedule, n, nbytes)

    # group measured durations by (atomic alg, step index); ops are
    # folded together — SPMD ranks issue ops in identical order, so
    # per-(alg, step) medians stay meaningful across repeated ops
    by_step: Dict[Tuple[str, int], List[Tuple[int, int]]] = {}
    for e, alg in zip(steps_ev, algs):
        by_step.setdefault((alg, e["c"] % 1024), []).append(
            (e["rank"], int(e["b"])))

    findings: List[Finding] = []
    anchor = "rlo_tpu_torch/ops/collectives.py"
    # predicted step identities from the ledger
    predicted = {(s.algorithm, s.index): s for s in led.steps}
    n_ops = max((len(v) for v in by_step.values()), default=0) // \
        max(n, 1) or 1
    missing = sorted(k for k in predicted if k not in by_step)
    extra = sorted(k for k in by_step if k not in predicted)
    if missing:
        findings.append(Finding(
            "S1", anchor, 0,
            f"{schedule} n={n}: ledger steps "
            f"{[f'{a}:{i}' for a, i in missing[:4]]} have no measured "
            f"events — instrumentation dropped steps"))
    if extra:
        findings.append(Finding(
            "S1", anchor, 0,
            f"{schedule} n={n}: measured steps "
            f"{[f'{a}:{i}' for a, i in extra[:4]]} are not in the "
            f"ledger — executor ran steps the proof never saw"))
    if measured_steps is not None:
        want = led.num_steps * n_ops
        bad = [(r, got) for r, got in zip(ranks, measured_steps)
               if got != want]
        if bad:
            findings.append(Finding(
                "S1", anchor, 0,
                f"{schedule} n={n}: coll_steps counter disagrees with "
                f"the ledger's {want} sends/rank: ranks "
                f"{bad[:4]} — send-path drift"))
    if measured_bytes is not None:
        per_rank = led.sent_bytes_by_rank()
        bad = [(r, got, per_rank[i] * n_ops) for i, (r, got)
               in enumerate(zip(ranks, measured_bytes))
               if got != per_rank[i] * n_ops]
        if bad:
            findings.append(Finding(
                "S2", anchor, 0,
                f"{schedule} n={n}: measured payload bytes deviate "
                f"from the ledger (rank, measured, predicted): "
                f"{bad[:4]}"))
    if result_correct is False:
        findings.append(Finding(
            "S3", anchor, 0,
            f"{schedule} n={n}: the reduction returned a WRONG "
            f"result — attribution aside, the collective is broken"))

    # per-step attribution table
    table = []
    span_usec = 0
    for (alg, idx) in sorted(by_step):
        obs = by_step[(alg, idx)]
        durs = sorted(d for _, d in obs)
        med = durs[len(durs) // 2]
        worst = durs[-1]
        pred = predicted.get((alg, idx))
        ebytes = pred.edge_nbytes if pred is not None else 0
        stragglers = sorted(r for r, d in obs
                            if med > 0 and d > 1.5 * med)
        table.append({
            "algorithm": alg, "step": idx,
            "edge_bytes": ebytes,
            "dur_med_usec": med, "dur_max_usec": worst,
            "gbps_med": (round(ebytes / med / 1000, 6)
                         if med else None),
            "stragglers": stragglers,
        })
        span_usec += worst
    # straggler edges are REPORT content, not findings: on a randomly
    # delayed fabric (and any real one) some rank is always slowest —
    # findings are reserved for contract violations (S1/S2/S3), so a
    # healthy instrumented run exits 0

    ideal = (led.num_steps * n_ops * min_delay_usec
             if min_delay_usec else None)
    report = {
        "schedule": schedule, "n": n, "nbytes": nbytes,
        "ledger": {
            "steps": led.num_steps,
            "total_bytes": led.total_bytes,
            "bytes_per_rank": led.bytes_per_rank,
            "digest": led.digest(),
        },
        "measured": {
            "step_events": len(steps_ev),
            "ops": n_ops,
            "span_usec": span_usec,
            "coll_steps": measured_steps,
            "coll_bytes": measured_bytes,
        },
        "steps": table,
        "bus_fraction": (round(ideal / span_usec, 4)
                         if ideal and span_usec else None),
    }
    return report, findings


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def render(report: Dict) -> str:
    led = report["ledger"]
    mea = report["measured"]
    out = [f"rlo-scope: {report['schedule']} n={report['n']} "
           f"payload {report['nbytes']} B — {led['steps']} ledger "
           f"steps, {led['bytes_per_rank']} B/rank predicted, "
           f"{mea['step_events']} step events measured"]
    if report["bus_fraction"] is not None:
        out.append(f"  bus utilisation {report['bus_fraction']:.1%} "
                   f"(ideal latency floor over measured span "
                   f"{mea['span_usec']}us)")
    out.append(f"  {'step':<26} {'bytes/edge':>10} {'med':>9} "
               f"{'max':>9} {'GB/s':>7}  stragglers")
    for row in report["steps"]:
        gb = (f"{row['gbps_med']:.6f}"
              if row["gbps_med"] is not None else "-")
        strag = ",".join(map(str, row["stragglers"])) or "-"
        out.append(
            f"  {row['algorithm'] + ':' + str(row['step']):<26} "
            f"{row['edge_bytes']:>10} {row['dur_med_usec']:>7}us "
            f"{row['dur_max_usec']:>7}us {gb:>7}  {strag}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def load_dumps(paths: Sequence[str]) -> List[Dict]:
    out: List[Dict] = []
    for p in paths:
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        except OSError as e:
            raise ToolError(f"unreadable dump {p}: {e}")
        except json.JSONDecodeError as e:
            raise ToolError(f"malformed dump {p}: {e}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rlo_tpu_torch.tools.rlo_scope",
        description="Collective data-plane attribution: join measured "
                    "Ev.STEP timings against the deterministic cost "
                    "ledger (docs/DESIGN.md §21).")
    ap.add_argument("dumps", nargs="*",
                    help="per-rank tracer JSONL dumps to merge "
                         "(default: run a seeded sim collective)")
    ap.add_argument("--schedule", default="ring_allreduce",
                    help=f"schedule to run / join "
                         f"({', '.join(SIM_SCHEDULES)}; dump mode "
                         f"infers when omitted)")
    ap.add_argument("--n", type=int, default=8,
                    help="world size for the sim run (default 8)")
    ap.add_argument("--nbytes", type=int, default=DEFAULT_NBYTES,
                    help="per-rank payload bytes (default 1 MiB — "
                         "BASELINE.json config 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the text report (findings only)")
    args = ap.parse_args(argv)
    try:
        if args.dumps:
            events = load_dumps(args.dumps)
            # an explicitly passed --schedule pins the join; the
            # argparse default only applies to sim mode
            sched = args.schedule if "--schedule" in (argv if argv
                   is not None else sys.argv) else None
            report, findings = analyze(events, sched, args.nbytes)
        else:
            run = run_sim_collective(args.schedule, args.n,
                                     args.nbytes, args.seed)
            report, findings = analyze(
                run["events"], run["schedule"], run["nbytes"],
                measured_steps=run["coll_steps"],
                measured_bytes=run["coll_bytes"],
                min_delay_usec=run["min_delay_usec"],
                result_correct=run["result_correct"])
            report["seed"] = run["seed"]
            report["sim_schedule_digest"] = run["schedule_digest"]
    except ToolError as e:
        print(f"rlo-scope: error: {e}", file=sys.stderr)
        return 2
    if args.json:
        report["findings"] = [f.to_json() for f in findings]
        json.dump(report, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 1 if findings else 0
    if not args.quiet:
        print(render(report))
    return emit(findings, prog="rlo-scope", ran="S1,S2,S3",
                root=f"{report['schedule']}/n={report['n']}",
                as_json=False, quiet=True)


if __name__ == "__main__":
    sys.exit(main())
