"""perf-gate — mechanical performance-regression gate.

The port's copy of ``rlo_tpu/tools/perf_gate.py``: the same document
schema and rules.

Compares a fresh benchmark run (benchmarks/engine_bench.py or
benchmarks/sim_bench.py JSON) against a committed baseline
(BENCH_engine.json / BENCH_sim.json at the repo root) with the
EXPLICIT per-metric tolerances the benchmark embedded, so hot-path
slowdowns and protocol-shape regressions (an extra frame per hop, an
O(log n) schedule gone O(n)) are caught by CI, not anecdote
(docs/DESIGN.md §10 "baseline/tolerance policy").

Document schema (shared by both benchmarks)::

    {"suite": "engine_bench", "quick": true, "config": {...},
     "metrics": {"<name>": {"value": V,
                            "direction": "higher" | "lower" | "exact",
                            "tolerance": {"factor": F} | {"rel": R}
                                         | {"abs": A} | null}}}

Comparison rules (the BASELINE's direction/tolerance govern):

  - ``exact``      — the values must be equal. Reserved for
                     seed-deterministic metrics (frame counts on the
                     seeded loopback, virtual-time latencies in the
                     simulator): any drift is a protocol change.
  - ``higher``     — higher is better; fails when the fresh value
                     falls below baseline/factor (or baseline*(1-rel),
                     or baseline-abs). Wall-clock throughputs use
                     generous factors so the gate is non-flaky.
  - ``lower``      — lower is better; mirrored.
  - tolerance null — informational: recorded, never gated (but the
                     metric must still EXIST in the fresh run).

Improvements never fail. Structural drift fails the gate in BOTH
directions: a baseline metric missing from the fresh run, a fresh
metric absent from the baseline (it would otherwise run ungated), and
suite/config mismatches. Regenerate the baseline deliberately (re-run
the benchmark with --out onto the committed file) when the benchmark
itself changes shape.

Usage:
    python -m rlo_tpu_torch.tools.perf_gate --baseline BENCH_engine.json \
        --fresh /tmp/fresh.json [-q]

Exit codes: 0 clean, 1 regressions, 2 bad invocation / unreadable or
mismatched inputs — same contract as rlo-lint.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence


class GateError(RuntimeError):
    """Unrecoverable gate failure (missing/unreadable/mismatched
    inputs) — exit code 2, distinct from findings."""


def _load(path) -> Dict:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise GateError(f"cannot read benchmark JSON {path}: {e}")
    for key in ("suite", "metrics"):
        if key not in doc:
            raise GateError(f"{path}: missing {key!r} (not a "
                            f"benchmark document?)")
    return doc


def compare_metric(name: str, base: Dict, fresh_value) -> Optional[str]:
    """One metric against its baseline entry; returns a finding
    message or None. The baseline's direction/tolerance govern."""
    bval = base.get("value")
    direction = base.get("direction", "higher")
    tol = base.get("tolerance")
    if direction not in ("exact", "higher", "lower"):
        # an unknown direction must FAIL, not silently never-gate
        return (f"{name}: unknown direction {direction!r} in the "
                f"baseline (want exact/higher/lower)")
    if direction == "exact":
        if fresh_value != bval:
            return (f"{name}: expected exactly {bval!r}, got "
                    f"{fresh_value!r} — a seed-deterministic metric "
                    f"moved (protocol/schedule change)")
        return None
    if tol is None:
        return None  # informational
    if not isinstance(fresh_value, (int, float)) or \
            not isinstance(bval, (int, float)):
        return f"{name}: non-numeric value ({bval!r} vs {fresh_value!r})"
    if "factor" in tol:
        limit = (bval / tol["factor"] if direction == "higher"
                 else bval * tol["factor"])
    elif "rel" in tol:
        limit = (bval * (1.0 - tol["rel"]) if direction == "higher"
                 else bval * (1.0 + tol["rel"]))
    elif "abs" in tol:
        limit = (bval - tol["abs"] if direction == "higher"
                 else bval + tol["abs"])
    else:
        return f"{name}: unknown tolerance spec {tol!r}"
    if direction == "higher" and fresh_value < limit:
        return (f"{name}: {fresh_value:.4g} fell below the tolerance "
                f"floor {limit:.4g} (baseline {bval:.4g}, {tol})")
    if direction == "lower" and fresh_value > limit:
        return (f"{name}: {fresh_value:.4g} exceeded the tolerance "
                f"ceiling {limit:.4g} (baseline {bval:.4g}, {tol})")
    return None


def run_gate(baseline: Dict, fresh: Dict) -> List[str]:
    """Compare two benchmark documents; returns findings (empty =
    clean). Raises GateError on structural mismatch that makes the
    comparison meaningless (wrong suite / config)."""
    if baseline["suite"] != fresh["suite"]:
        raise GateError(
            f"suite mismatch: baseline is {baseline['suite']!r}, "
            f"fresh is {fresh['suite']!r}")
    if baseline.get("config") != fresh.get("config"):
        raise GateError(
            f"config mismatch: baseline {baseline.get('config')!r} "
            f"vs fresh {fresh.get('config')!r} — run the benchmark "
            f"with the baseline's flags (or regenerate the baseline)")
    findings: List[str] = []
    fresh_metrics = fresh["metrics"]
    for name, base in sorted(baseline["metrics"].items()):
        if name not in fresh_metrics:
            findings.append(
                f"{name}: present in the baseline but missing from "
                f"the fresh run (benchmark coverage regressed)")
            continue
        entry = fresh_metrics[name]
        if not isinstance(entry, dict) or "value" not in entry:
            raise GateError(
                f"fresh metric {name!r} has no 'value' field "
                f"({entry!r}) — not a benchmark document this gate "
                f"understands")
        msg = compare_metric(name, base, entry["value"])
        if msg is not None:
            findings.append(msg)
    # metrics only the fresh run carries are drift in the OTHER
    # direction: an ungated number is indistinguishable from a gated
    # one on a green run, so force the baseline regeneration instead
    # of silently skipping it
    for name in sorted(set(fresh_metrics) - set(baseline["metrics"])):
        findings.append(
            f"{name}: produced by the fresh run but absent from the "
            f"baseline — regenerate the baseline so the metric is "
            f"actually gated")
    return findings


def report_informational(baseline: Dict, fresh: Dict) -> List[str]:
    """Drift-table lines for the INFORMATIONAL metrics (tolerance
    null, non-exact direction): recorded-but-never-gated numbers —
    wall throughputs, ``arq_scan_*`` observations, heal-cost counters
    — printed so they get eyeballed on every check.sh run instead of
    drifting silently until someone regenerates a baseline."""
    lines: List[str] = []
    fresh_metrics = fresh.get("metrics", {})
    for name, base in sorted(baseline["metrics"].items()):
        if base.get("tolerance") is not None or \
                base.get("direction") == "exact":
            continue
        bval = base.get("value")
        entry = fresh_metrics.get(name)
        fval = entry.get("value") if isinstance(entry, dict) else None
        if isinstance(bval, (int, float)) and \
                isinstance(fval, (int, float)) and bval:
            drift = f"{(fval - bval) / abs(bval) * 100.0:+8.1f}%"
        else:
            drift = "       —"
        lines.append(f"  {name:<44} {bval!r:>14} -> {fval!r:>14} "
                     f"{drift}")
    if lines:
        lines.insert(0, f"informational drift "
                        f"({baseline['suite']}, {len(lines)} "
                        f"ungated metrics; baseline -> fresh):")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rlo_tpu_torch.tools.perf_gate",
        description="Mechanical perf-regression gate "
                    "(docs/DESIGN.md §10).")
    ap.add_argument("--baseline", required=True, type=Path,
                    help="committed baseline JSON (BENCH_engine.json /"
                         " BENCH_sim.json)")
    ap.add_argument("--fresh", required=True, type=Path,
                    help="freshly produced benchmark JSON")
    ap.add_argument("--report", action="store_true",
                    help="also print the drift table for "
                         "informational (tolerance-null) metrics")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)
    try:
        baseline = _load(args.baseline)
        fresh = _load(args.fresh)
        findings = run_gate(baseline, fresh)
    except GateError as e:
        print(f"perf-gate: error: {e}", file=sys.stderr)
        return 2
    if args.report:
        for line in report_informational(baseline, fresh):
            print(line)
    for msg in findings:
        print(msg)
    if not args.quiet:
        n = len(findings)
        print(f"perf-gate: {n} regression{'s' if n != 1 else ''} "
              f"({baseline['suite']}, {len(baseline['metrics'])} "
              f"metrics) vs {args.baseline}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
