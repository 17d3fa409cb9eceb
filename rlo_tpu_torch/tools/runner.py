"""runner — shared driver plumbing for rlo-lint, rlo-sentinel,
rlo-prover and rlo-model, plus the merged static report.

The port's copy of ``rlo_tpu/tools/runner.py``; its tool table
names the port's analyzers.

All four analyzers produce the same artifact: a sorted list of
findings, each anchored at a file:line, printed as compiler-style
diagnostics (``file:line: RULE message``) or — with ``--json`` — as a
machine-readable array for CI tooling.  Exit codes are shared too:
0 clean, 1 findings, 2 bad invocation / unparseable inputs.

``python -m rlo_tpu_torch.tools.runner`` runs all four in one process and
emits a single merged findings document: per-tool wall timing, per-tool
finding counts, and every finding stamped with the tool that produced
it.  ``make static`` and check.sh's merged static step consume it.

This module also owns the **anchor-consumption registry** behind the
stale-anchor audit (rlo-sentinel S0): every time a rule *uses* a
suppression/annotation anchor (``rlo-lint: paired-with``,
``rlo-sentinel: guarded-by``, ``rlo-prover: lane-pinned``, ...), it
records the anchor's exact (file, line); the audit then scans every
analyzed source file for anchor spellings and flags the ones no rule
consumed — an anchor that no longer suppresses anything is rot
waiting to mask a real finding.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


@dataclass
class Finding:
    rule: str
    file: str
    line: int
    msg: str
    severity: str = "error"

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} {self.msg}"

    def to_json(self) -> Dict[str, object]:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.msg, "severity": self.severity}


class ToolError(RuntimeError):
    """Unrecoverable analyzer failure (missing input, unparseable
    source) — exit code 2, distinct from findings."""


#: anchor prefixes the audit scans for.  Anything matching
#: ``<prefix><word>`` in an analyzed source file is an anchor
#: occurrence and must be consumed by some rule.
ANCHOR_PREFIXES = ("rlo-lint:", "rlo-sentinel:", "rlo-prover:")


@dataclass
class AnchorRegistry:
    """Records which anchor comment lines the rules actually used."""
    consumed: Set[Tuple[str, int]] = field(default_factory=set)

    def consume(self, file: str, line: int) -> None:
        self.consumed.add((file, line))

    def consume_all(self, file: str, lines: Iterable[int]) -> None:
        for ln in lines:
            self.consumed.add((file, ln))


def find_anchor(lines: Sequence[str], line: int, anchor: str,
                lookback: int = 2) -> Optional[int]:
    """1-indexed line of ``anchor`` within [line - lookback, line], or
    None.  Scans the construct's own line FIRST, then upward — two
    adjacent anchored constructs must each consume their own anchor,
    not both the upper one.  The returned line is what the consumption
    registry records (the anchor's own line, not the construct's)."""
    for ln in range(line, max(1, line - lookback) - 1, -1):
        if ln <= len(lines) and anchor in lines[ln - 1]:
            return ln
    return None


def scan_anchors(lines: Sequence[str]) -> List[Tuple[int, str]]:
    """All (line, anchor-text) occurrences of any known anchor prefix
    in one file's raw lines."""
    out: List[Tuple[int, str]] = []
    for i, text in enumerate(lines, start=1):
        for prefix in ANCHOR_PREFIXES:
            at = text.find(prefix)
            if at >= 0:
                tail = text[at:].strip()
                out.append((i, tail if len(tail) <= 60
                            else tail[:57] + "..."))
                break
    return out


def audit_stale_anchors(rule: str,
                        files: Dict[str, Sequence[str]],
                        registry: AnchorRegistry) -> List[Finding]:
    """The shared stale-anchor pass: any anchor occurrence in an
    analyzed file that no rule consumed this run is a finding."""
    out: List[Finding] = []
    for path in sorted(files):
        for line, text in scan_anchors(files[path]):
            if (path, line) not in registry.consumed:
                out.append(Finding(
                    rule, path, line,
                    f"stale anchor {text!r}: no rule consumed it this "
                    f"run — it suppresses/annotates nothing and should "
                    f"be deleted (or the construct it guarded was "
                    f"edited away)", severity="warning"))
    return out


def emit(findings: Sequence[Finding], *, prog: str, ran: str,
         root: object, as_json: bool, quiet: bool) -> int:
    """Print findings (text or JSON) and return the process exit code."""
    if as_json:
        json.dump([f.to_json() for f in findings], sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        for fnd in findings:
            print(fnd)
        if not quiet:
            print(f"{prog}: {len(findings)} finding"
                  f"{'s' if len(findings) != 1 else ''} ({ran}) in "
                  f"{root}")
    return 1 if findings else 0


# ---------------------------------------------------------------------------
# merged static report (make static / check.sh)
# ---------------------------------------------------------------------------

#: the full analyzer suite, in dependency-free run order
STATIC_TOOLS = (
    ("rlo-lint", "rlo_tpu_torch.tools.rlo_lint", "run_lint"),
    ("rlo-sentinel", "rlo_tpu_torch.tools.rlo_sentinel", "run_sentinel"),
    ("rlo-prover", "rlo_tpu_torch.tools.rlo_prover", "run_prover"),
    ("rlo-model", "rlo_tpu_torch.tools.rlo_model", "run_model"),
)


def run_static(root) -> List[Tuple[str, float, List[Finding]]]:
    """Run every analyzer against ``root``; returns ``(tool, seconds,
    findings)`` per tool.  ToolError propagates (exit 2 at the CLI) —
    an analyzer that cannot parse its inputs is a broken tree, not a
    clean one."""
    import importlib
    import time
    out: List[Tuple[str, float, List[Finding]]] = []
    for tool, modname, fname in STATIC_TOOLS:
        fn = getattr(importlib.import_module(modname), fname)
        # per-tool wall timing for the merged report, never part of any
        # seed-deterministic schedule
        t0 = time.perf_counter()  # rlo-lint: allow-wallclock
        findings = fn(root)
        dt = time.perf_counter() - t0  # rlo-lint: allow-wallclock
        out.append((tool, dt, findings))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    from pathlib import Path
    ap = argparse.ArgumentParser(
        prog="python -m rlo_tpu_torch.tools.runner",
        description="Merged static report: rlo-lint + rlo-sentinel + "
                    "rlo-prover + rlo-model in one process, one "
                    "findings document, per-tool timing.")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--json", action="store_true",
                    help="merged machine-readable document on stdout")
    args = ap.parse_args(argv)
    try:
        results = run_static(args.root)
    except ToolError as e:
        print(f"rlo-static: error: {e}", file=sys.stderr)
        return 2
    merged = [dict(f.to_json(), tool=tool)
              for tool, _dt, fs in results for f in fs]
    timing = " ".join(f"{tool}={dt:.2f}s" for tool, dt, _fs in results)
    if args.json:
        json.dump({
            "root": str(args.root),
            "tools": [{"tool": tool, "seconds": round(dt, 3),
                       "findings": len(fs)}
                      for tool, dt, fs in results],
            "findings": merged,
        }, sys.stdout, indent=1)
        sys.stdout.write("\n")
        print(f"rlo-static: timing {timing}", file=sys.stderr)
    else:
        for tool, _dt, fs in results:
            for f in fs:
                print(f"{f.file}:{f.line}: [{tool}] {f.rule} {f.msg}")
        print(f"rlo-static: timing {timing}")
        print(f"rlo-static: {len(merged)} finding"
              f"{'s' if len(merged) != 1 else ''} across "
              f"{len(results)} analyzers in {args.root}")
    return 1 if merged else 0


if __name__ == "__main__":
    sys.exit(main())
