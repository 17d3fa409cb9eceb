"""rlo-lint — static cross-engine protocol-conformance analyzer.

The port's copy of ``rlo_tpu/tools/rlo_lint.py``: the same rules,
messages, flags and exit codes over the port's engine, wire format,
metrics schema and its copy of the C core (``rlo_tpu_torch/...``); R5's
scope also holds ``tools/rlo_trace.py`` and ``utils/moved_bytes.py``.

The repo's core invariant is that the Python ``ProgressEngine``
(rlo_tpu_torch/engine.py) and the C ``rlo_engine``
(rlo_tpu_torch/native/) speak byte-identical wire frames, expose an identical metrics schema, and
implement the same bcast/IAR state machines (SURVEY.md dual-engine
design; docs/DESIGN.md §§6–8). Runtime parity tests exercise that
invariant; this linter enforces it *statically* — it parses the C
sources/headers and the Python sources (AST only, nothing is imported
or compiled), so a drifted ``#define``, a missing ``Tag`` handler, or
an untyped ctypes call fails fast instead of surfacing as a 64-bit
pointer truncation three PRs later.

Rule families (docs/DESIGN.md §9 has the full catalogue):

  R1 wire parity — every header offset/width/format constant in
     wire.py (the ``<iiiiiQ>`` frame header, SEQ_OFFSET, EPOCH_OFFSET,
     HEADER_SIZE, MSG_SIZE_MAX) matches rlo_core.h/rlo_wire.c byte for
     byte; Tag ⇔ enum rlo_tag, ReqState ⇔ enum rlo_state, bindings
     error codes ⇔ enum rlo_err, HIST_BUCKETS ⇔ RLO_HIST_BUCKETS; and
     each paired constant carries a ``rlo-lint: paired-with`` anchor.
  R2 metrics-schema parity — ENGINE_COUNTER_KEYS (utils/metrics.py)
     ⇔ the leading counter fields of ``struct rlo_stats`` ⇔ the keys
     ProgressEngine.metrics() assembles; ENGINE_PHASE_KEYS ⇔ the
     field order of ``struct rlo_phase_stats`` ⇔ the phase literal
     metrics() assembles ⇔ the engine's ``_phobs()`` observation
     sites (every phase observed, every observation schema-valid).
  R3 ctypes contract — every exported ``rlo_*`` prototype in
     rlo_core.h has a bindings.py declaration whose argtypes/restype
     match the parsed C signature (pointer-returning and 64-bit-
     returning functions are real truncation hazards under the
     implicit-int default); no binding names a symbol the header does
     not export; ctypes Structure mirrors match the C structs field
     for field; CFUNCTYPE callback types match the C typedefs.
  R4 dispatch exhaustiveness — every Tag member is either explicitly
     dispatched in ProgressEngine._progress_once AND the C
     rlo_engine_progress_once switch, or annotated
     ``rlo-lint: default-route`` at its definition site (wire.py for
     the Python side, rlo_core.h for the C side) with a catch-all
     present; every serving-fabric Rec record kind is explicitly
     dispatched in DecodeFabric._on_record (or annotated likewise) —
     docs/DESIGN.md §11; every guarded ReqState assignment is an
     allowed transition; C state assignments name real enum rlo_state
     members.
  R5 determinism hygiene — no wall-clock (``time.time``/``sleep``/…)
     or module-level ``random`` calls in the engine/transport/sim or
     serving-fabric code paths outside the injectable ``clock``/seeded
     ``random.Random`` abstractions the deterministic simulator
     depends on (``# rlo-lint: allow-wallclock`` suppresses a
     sanctioned line).

Anchor comments the linter understands:

  # rlo-lint: paired-with <file>:<symbol>   constant is half of a
                                            cross-language pair
  # rlo-lint: default-route                 this Tag member is served
                                            by the dispatch catch-all
  # rlo-lint: allow-wallclock               sanctioned wall-clock use

Usage:
  python -m rlo_tpu_torch.tools.rlo_lint [--root DIR] [--rules R1,R3]
                                   [--json] [-q]

Exit codes: 0 clean, 1 findings, 2 bad invocation / missing inputs.

Since round 15 the mini C parser lives in the shared front end
``rlo_tpu_torch/tools/csrc.py`` (rlo-sentinel builds its CFG/dataflow layer
on the same model — docs/DESIGN.md §15), findings ride the shared
runner (``--json`` for machine-readable output), and every anchor a
rule *uses* is recorded so rlo-sentinel's S0 stale-anchor audit can
flag the ones that no longer suppress anything.
"""

from __future__ import annotations

import argparse
import ast
import re
import struct
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from rlo_tpu_torch.tools import csrc
from rlo_tpu_torch.tools.csrc import (CHeader, CProto,  # noqa: F401
                                      parse_c_header)
from rlo_tpu_torch.tools.runner import (AnchorRegistry, Finding, ToolError,
                                        emit, find_anchor)

RULE_IDS = ("R1", "R2", "R3", "R4", "R5")

# files the analyzer reads, relative to the repo root
WIRE_PY = "rlo_tpu_torch/wire.py"
METRICS_PY = "rlo_tpu_torch/utils/metrics.py"
ENGINE_PY = "rlo_tpu_torch/engine.py"
BINDINGS_PY = "rlo_tpu_torch/native/bindings.py"
CORE_H = "rlo_tpu_torch/native/rlo_core.h"
WIRE_C = "rlo_tpu_torch/native/rlo_wire.c"
ENGINE_C = "rlo_tpu_torch/native/rlo_engine.c"
FABRIC_PY = "rlo_tpu_torch/serving/fabric.py"
TRACING_PY = "rlo_tpu_torch/utils/tracing.py"

#: R5 scope: the seed-deterministic code paths (engine + transports the
#: simulator drives, plus the serving fabric, which whole fleets replay
#: inside the simulator — docs/DESIGN.md §11 — and the workloads
#: subsystem, whose traces and weather schedules must replay
#: seed-exact for the perf gate's digest pins — docs/DESIGN.md §14).
#: Launchers, benchmarks, and observability tooling may use wall
#: clocks freely.
R5_FILES = (ENGINE_PY, "rlo_tpu_torch/transport/base.py",
            "rlo_tpu_torch/serving/pages.py",
            "rlo_tpu_torch/transport/loopback.py",
            "rlo_tpu_torch/transport/sim.py",
            FABRIC_PY, "rlo_tpu_torch/serving/placement.py",
            "rlo_tpu_torch/serving/backend.py",
            "rlo_tpu_torch/serving/scenario.py",
            "rlo_tpu_torch/workloads/__init__.py",
            "rlo_tpu_torch/workloads/traces.py",
            "rlo_tpu_torch/workloads/weather.py",
            # the telemetry plane + watchdog (round 17): digests pace
            # on the engine clock and watchdog trips are part of the
            # deterministic schedule — a wall-clock/module-random
            # dependency would unpin every instrumented replay
            "rlo_tpu_torch/observe/__init__.py",
            "rlo_tpu_torch/observe/telemetry.py",
            "rlo_tpu_torch/observe/watchdog.py",
            # request-span recorder (round 19): sampling salt and span
            # timestamps are part of the deterministic replay — a
            # module-random draw or wall-clock stamp would unpin the
            # bit-for-bit rlo-trace acceptance property
            "rlo_tpu_torch/observe/spans.py",
            # collective cost ledger + rlo-scope (round 21): ledgers
            # must be a pure function of (schedule, n, nbytes) and the
            # scope report bit-for-bit reproducible per (schedule, n,
            # seed) — wall clocks or module randomness would unpin both
            "rlo_tpu_torch/observe/ledger.py",
            "rlo_tpu_torch/tools/rlo_scope.py",
            "rlo_tpu_torch/tools/rlo_top.py",
            # the analyzers themselves (round 15): a wall-clock or
            # module-random dependency in rlo-lint/rlo-sentinel would
            # make "clean tree" depend on when/where the tool ran —
            # check.sh times the sentinel from the OUTSIDE instead
            "rlo_tpu_torch/tools/rlo_lint.py",
            "rlo_tpu_torch/tools/rlo_sentinel.py",
            "rlo_tpu_torch/tools/rlo_prover.py",
            "rlo_tpu_torch/tools/csrc.py", "rlo_tpu_torch/tools/runner.py",
            "rlo_tpu_torch/tools/perf_gate.py",
            # the port's own: rlo-trace's scenario report and the moved-
            # byte record are pure functions of (seed, schedule, shapes)
            "rlo_tpu_torch/tools/rlo_trace.py",
            "rlo_tpu_torch/utils/moved_bytes.py")

PAIRED_ANCHOR = "rlo-lint: paired-with"
DEFAULT_ROUTE_ANCHOR = "rlo-lint: default-route"
ALLOW_WALLCLOCK_ANCHOR = "rlo-lint: allow-wallclock"


class LintError(ToolError):
    """Unrecoverable analyzer failure (missing input, unparseable
    source) — exit code 2, distinct from findings."""


# the mini C front end moved to csrc.py in round 15 (rlo-sentinel
# shares it); keep the historical local names working
_strip_c_comments = csrc.strip_comments
_line_of = csrc.line_of
_canon_ctype = csrc.canon_ctype
_extract_c_function = csrc.extract_function


# ---------------------------------------------------------------------------
# Python AST helpers
# ---------------------------------------------------------------------------

@dataclass
class PyModule:
    path: str
    raw: str
    lines: List[str]
    tree: ast.Module


def parse_py(path: Path, relpath: str) -> PyModule:
    try:
        raw = path.read_text()
    except OSError as e:
        raise LintError(f"cannot read {relpath}: {e}")
    try:
        tree = ast.parse(raw, filename=relpath)
    except SyntaxError as e:
        raise LintError(f"cannot parse {relpath}: {e}")
    return PyModule(path=relpath, raw=raw, lines=raw.splitlines(),
                    tree=tree)


def _const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _const_int(node.operand)
        return None if inner is None else -inner
    return None


def py_enum_members(mod: PyModule, classname: str) -> Dict[str,
                                                           Tuple[int, int]]:
    """IntEnum class -> {member: (value, line)}."""
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == classname:
            out: Dict[str, Tuple[int, int]] = {}
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    val = _const_int(stmt.value)
                    if val is not None:
                        out[stmt.targets[0].id] = (val, stmt.lineno)
            return out
    raise LintError(f"{mod.path}: class {classname} not found")


def py_top_assigns(mod: PyModule) -> Dict[str, Tuple[ast.AST, int]]:
    out: Dict[str, Tuple[ast.AST, int]] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = (node.value, node.lineno)
    return out


def _find_funcdef(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._rlo_parent = node  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# ctypes expression evaluation (bindings.py AST -> canonical strings)
# ---------------------------------------------------------------------------

class _CFunc:
    """A CFUNCTYPE(...) value: restype + argtypes, canonicalized."""

    def __init__(self, types: List[object]):
        self.ret = types[0] if types else "void"
        self.args = types[1:]

    def __repr__(self) -> str:
        return f"CFUNCTYPE({self.ret}, {', '.join(map(str, self.args))})"


def _eval_ctype(node: ast.AST, env: Dict[str, object]) -> object:
    if isinstance(node, ast.Constant):
        if node.value is None:
            return "void"
        return node.value
    if isinstance(node, ast.Attribute):
        # C.c_int -> "c_int"; anything.X -> "X"
        return node.attr
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        return node.id  # class names (_Stats), unresolved aliases
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_eval_ctype(e, env) for e in node.elts]
    if isinstance(node, ast.Call):
        fn = _eval_ctype(node.func, env)
        args = [_eval_ctype(a, env) for a in node.args]
        if fn == "POINTER":
            return f"POINTER({args[0]})"
        if fn == "CFUNCTYPE":
            return _CFunc(args)
        return f"{fn}({', '.join(map(str, args))})"
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        left = _eval_ctype(node.left, env)
        right = _eval_ctype(node.right, env)
        if isinstance(left, list) and isinstance(right, int):
            return left * right
        return f"{left} * {right}"
    return f"<{type(node).__name__}>"


def _bindings_env(mod: PyModule) -> Dict[str, object]:
    """Canonical values for the simple `name = expr` aliases visible to
    the sig() declarations: module top level plus load()'s own locals
    (other functions' locals would shadow, e.g. frame_roundtrip's
    scratch `p`), resolved iteratively so aliases-of-aliases settle."""
    scopes: List[ast.AST] = [mod.tree]
    load_fn = _find_funcdef(mod.tree, "load")
    if load_fn is not None:
        scopes.append(load_fn)
    assigns: List[Tuple[str, ast.AST]] = []
    for scope in scopes:
        for node in (scope.body if isinstance(scope, (ast.Module,
                                                      ast.FunctionDef))
                     else []):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                assigns.append((node.targets[0].id, node.value))
    env: Dict[str, object] = {}
    for _ in range(3):  # tiny fixpoint: aliases are at most 2 deep
        for name, value in assigns:
            try:
                env[name] = _eval_ctype(value, env)
            except Exception:
                pass
    return env


# ---------------------------------------------------------------------------
# C type -> acceptable ctypes declarations
# ---------------------------------------------------------------------------

#: opaque handles: the bindings deliberately pass these as c_void_p
OPAQUE_STRUCTS = {"rlo_world", "rlo_engine", "rlo_coll"}

#: C structs with a ctypes.Structure mirror in bindings.py — pointer
#: parameters to these must use POINTER(<mirror>), never a bare void*
STRUCT_MIRRORS = {
    "rlo_stats": "_Stats",
    "rlo_link_stats": "_LinkStats",
    "rlo_hist": "_Hist",
    "rlo_engine_state": "_EngineState",
    "rlo_trace_event": "_TraceEvent",
    "rlo_phase_stats": "_PhaseStats",
}

_SCALAR_CTYPES = {
    "int": "c_int", "int32_t": "c_int32", "int64_t": "c_int64",
    "uint8_t": "c_uint8", "uint32_t": "c_uint32",
    "uint64_t": "c_uint64", "long": "c_long",
    "float": "c_float", "double": "c_double", "char": "c_char",
}


def _acceptable(ctype: str, hdr: CHeader) -> Optional[Set[str]]:
    """Set of canonical ctypes strings valid for C type ``ctype``;
    None when the type needs callback-typedef matching."""
    stars = ctype.count("*")
    base = ctype.replace("*", "")
    if base in hdr.fn_typedefs and stars == 0:
        return None  # handled by the CFUNCTYPE matcher
    if stars == 0:
        if base == "void":
            return {"void"}
        if base in _SCALAR_CTYPES:
            return {_SCALAR_CTYPES[base]}
    elif stars == 1:
        if base == "void":
            return {"c_void_p"}
        if base == "char":
            return {"c_char_p"}
        if base in OPAQUE_STRUCTS:
            return {"c_void_p"}
        if base in STRUCT_MIRRORS:
            return {f"POINTER({STRUCT_MIRRORS[base]})"}
        if base in _SCALAR_CTYPES:
            return {f"POINTER({_SCALAR_CTYPES[base]})"}
    elif stars == 2:
        if base in _SCALAR_CTYPES:
            return {f"POINTER(POINTER({_SCALAR_CTYPES[base]}))"}
    raise LintError(f"rlo-lint has no ctypes mapping for C type "
                    f"'{ctype}' — extend _acceptable()")


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _check_pair(findings: List[Finding], rule: str, file_a: str,
                line_a: int, name_a: str, val_a: object, file_b: str,
                name_b: str, val_b: object) -> None:
    if val_a != val_b:
        findings.append(Finding(
            rule, file_a, line_a,
            f"{name_a} = {val_a!r} does not match {file_b}:{name_b} "
            f"= {val_b!r}"))


def _require_anchor(ctx: "LintContext", findings: List[Finding],
                    mod: PyModule, line: int, symbol: str) -> None:
    at = find_anchor(mod.lines, line, PAIRED_ANCHOR)
    if at is None:
        findings.append(Finding(
            "R1", mod.path, line,
            f"paired constant {symbol} lacks a "
            f"'# {PAIRED_ANCHOR} <file:symbol>' anchor comment"))
    else:
        ctx.registry.consume(mod.path, at)


def rule_r1(ctx: "LintContext") -> List[Finding]:
    """Wire parity: header layout, tags, states, error codes."""
    f: List[Finding] = []
    wire, hdr, bindings = ctx.wire, ctx.header, ctx.bindings
    assigns = py_top_assigns(wire)

    # frame header format: offsets derived from the struct fmt string
    fmt = None
    fmt_line = 0
    if "_HEADER" in assigns:
        node, fmt_line = assigns["_HEADER"]
        if isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant):
            fmt = node.args[0].value
    if not isinstance(fmt, str):
        f.append(Finding("R1", wire.path, fmt_line or 1,
                         "_HEADER = struct.Struct(<literal>) not found"))
        return f
    _require_anchor(ctx, f, wire, fmt_line, "_HEADER")
    offsets = [struct.calcsize(fmt[:i + 1]) for i in range(1,
                                                           len(fmt) - 1)]
    offsets.insert(0, 0)
    size = struct.calcsize(fmt)
    _check_pair(f, "R1", wire.path, fmt_line, f"struct fmt {fmt!r} size",
                size, hdr.path, "RLO_HEADER_SIZE",
                hdr.macro("RLO_HEADER_SIZE"))

    for py_name, c_name, fmt_field in (("SEQ_OFFSET", "RLO_SEQ_OFFSET", 3),
                                       ("EPOCH_OFFSET",
                                        "RLO_EPOCH_OFFSET", 4)):
        if py_name not in assigns:
            f.append(Finding("R1", wire.path, 1,
                             f"{py_name} not defined"))
            continue
        node, line = assigns[py_name]
        val = _const_int(node)
        _require_anchor(ctx, f, wire, line, py_name)
        _check_pair(f, "R1", wire.path, line, py_name, val, hdr.path,
                    c_name, hdr.macro(c_name))
        _check_pair(f, "R1", wire.path, line, py_name, val, wire.path,
                    f"field {fmt_field} of {fmt!r}", offsets[fmt_field])

    if "MSG_SIZE_MAX" in assigns:
        node, line = assigns["MSG_SIZE_MAX"]
        _require_anchor(ctx, f, wire, line, "MSG_SIZE_MAX")
        _check_pair(f, "R1", wire.path, line, "MSG_SIZE_MAX",
                    _const_int(node), hdr.path, "RLO_MSG_SIZE_MAX",
                    hdr.macro("RLO_MSG_SIZE_MAX"))
    else:
        f.append(Finding("R1", wire.path, 1, "MSG_SIZE_MAX not defined"))

    # rlo_wire.c must encode at exactly the header-derived offsets
    wc = ctx.wire_c_stripped
    used: Set[int] = set()
    enc = _extract_c_function(wc, "rlo_frame_encode")
    if enc is None:
        f.append(Finding("R1", WIRE_C, 1,
                         "rlo_frame_encode not found in rlo_wire.c"))
    else:
        body, body_line = enc
        for m in re.finditer(
                r"(?:put_i32|put_u64|memcpy)\s*\(\s*dst\s*"
                r"(?:\+\s*(\w+))?", body):
            used.add(hdr.resolve(m.group(1)) if m.group(1) else 0)
        want = set(offsets) | {size}
        if used != want:
            f.append(Finding(
                "R1", WIRE_C, body_line,
                f"rlo_frame_encode writes at offsets "
                f"{sorted(used)}, python fmt {fmt!r} implies "
                f"{sorted(want)} (header + payload base)"))

    # Tag <-> enum rlo_tag (both directions, value equality)
    py_tags = py_enum_members(wire, "Tag")
    c_tags = hdr.enums.get("rlo_tag", {})
    for name, (val, line) in py_tags.items():
        c_name = f"RLO_TAG_{name}"
        if c_name not in c_tags:
            f.append(Finding("R1", wire.path, line,
                             f"Tag.{name} has no {c_name} in {hdr.path}"))
        elif c_tags[c_name][0] != val:
            f.append(Finding(
                "R1", wire.path, line,
                f"Tag.{name} = {val} but {c_name} = "
                f"{c_tags[c_name][0]} ({hdr.path}:{c_tags[c_name][1]})"))
    for c_name, (val, line) in c_tags.items():
        if c_name.replace("RLO_TAG_", "") not in py_tags:
            f.append(Finding("R1", hdr.path, line,
                             f"{c_name} has no Tag member in {wire.path}"))

    # ReqState <-> enum rlo_state
    py_states = py_enum_members(ctx.engine, "ReqState")
    c_states = hdr.enums.get("rlo_state", {})
    for name, (val, line) in py_states.items():
        c_name = f"RLO_{name}"
        if c_name not in c_states:
            f.append(Finding("R1", ctx.engine.path, line,
                             f"ReqState.{name} has no {c_name} in "
                             f"{hdr.path}"))
        elif c_states[c_name][0] != val:
            f.append(Finding(
                "R1", ctx.engine.path, line,
                f"ReqState.{name} = {val} but {c_name} = "
                f"{c_states[c_name][0]}"))
    for c_name, (val, line) in c_states.items():
        if c_name.replace("RLO_", "") not in py_states:
            f.append(Finding("R1", hdr.path, line,
                             f"{c_name} has no ReqState member"))

    # bindings module constants <-> enum rlo_err / rlo_state /
    # RLO_FANOUT_* macros. A symbol missing on EITHER side is itself a
    # finding — a silently skipped pair check is indistinguishable
    # from a passing one.
    b_assigns = py_top_assigns(bindings)
    c_errs = hdr.enums.get("rlo_err", {})
    fanouts = {name: (val, line) for name, (val, line) in
               hdr.macros.items() if name.startswith("RLO_FANOUT_")}

    def const_pair(py_name: str, c_name: str,
                   c_vals: Dict[str, Tuple[int, int]]) -> None:
        if py_name not in b_assigns:
            f.append(Finding(
                "R1", bindings.path, 1,
                f"bindings constant {py_name} (paired with "
                f"{hdr.path}:{c_name}) not defined"))
            return
        node, line = b_assigns[py_name]
        if c_name not in c_vals:
            f.append(Finding(
                "R1", bindings.path, line,
                f"{py_name} has no {c_name} in {hdr.path}"))
            return
        # a paired-with anchor on a bindings constant is optional but,
        # when present, it is consumed by this check (S0 audit)
        at = find_anchor(bindings.lines, line, PAIRED_ANCHOR)
        if at is not None:
            ctx.registry.consume(bindings.path, at)
        _check_pair(f, "R1", bindings.path, line, py_name,
                    _const_int(node), hdr.path, c_name,
                    c_vals[c_name][0])

    for py_name in ("OK", "ERR_ARG", "ERR_TOO_BIG", "ERR_BUSY",
                    "ERR_PROTO", "ERR_NOMEM", "ERR_STALL"):
        const_pair(py_name, "RLO_OK" if py_name == "OK" else
                   f"RLO_{py_name}", c_errs)
    for py_name in ("COMPLETED", "IN_PROGRESS", "FAILED", "INVALID"):
        const_pair(py_name, f"RLO_{py_name}", c_states)
    for py_name in ("FANOUT_SKIP_RING", "FANOUT_FLAT"):
        const_pair(py_name, f"RLO_{py_name}", fanouts)

    # span-context trailer pins (docs/DESIGN.md §19): size, magic and
    # packed layout must match the C codec byte-for-byte — a drifted
    # trailer mis-frames EVERY record of a traced fleet, and a size
    # whose % 4 != 3 destroys the structural discrimination against
    # clean i32-word record bodies
    span_fmt = None
    if "_SPAN_CTX" in assigns:
        snode, _ = assigns["_SPAN_CTX"]
        if isinstance(snode, ast.Call) and snode.args and \
                isinstance(snode.args[0], ast.Constant):
            span_fmt = snode.args[0].value
    py_span_magic = None
    if "SPAN_MAGIC" in assigns:
        mnode, mline = assigns["SPAN_MAGIC"]
        _require_anchor(ctx, f, wire, mline, "SPAN_MAGIC")
        py_span_magic = (mnode.value if isinstance(mnode, ast.Constant)
                         and isinstance(mnode.value, bytes) else None)
        cm = re.search(r'#define\s+RLO_SPAN_MAGIC\s+'
                       r'"((?:[^"\\]|\\.)*)"', hdr.raw)
        if cm is None:
            f.append(Finding("R1", hdr.path, 1,
                             "RLO_SPAN_MAGIC string macro not found"))
        else:
            c_magic = cm.group(1).encode().decode(
                "unicode_escape").encode("latin1")
            if py_span_magic != c_magic:
                f.append(Finding(
                    "R1", wire.path, mline,
                    f"SPAN_MAGIC {py_span_magic!r} != RLO_SPAN_MAGIC "
                    f"{c_magic!r} ({hdr.path})"))
    else:
        f.append(Finding("R1", wire.path, 1, "SPAN_MAGIC not defined"))
    if "SPAN_CTX_SIZE" in assigns:
        node, line = assigns["SPAN_CTX_SIZE"]
        val = _const_int(node)
        _require_anchor(ctx, f, wire, line, "SPAN_CTX_SIZE")
        _check_pair(f, "R1", wire.path, line, "SPAN_CTX_SIZE", val,
                    hdr.path, "RLO_SPAN_CTX_SIZE",
                    hdr.macro("RLO_SPAN_CTX_SIZE"))
        if py_span_magic is not None and isinstance(span_fmt, str):
            _check_pair(f, "R1", wire.path, line, "SPAN_CTX_SIZE",
                        val, wire.path,
                        f"len(SPAN_MAGIC) + calcsize({span_fmt!r})",
                        len(py_span_magic) + struct.calcsize(span_fmt))
        if val is not None and val % 4 != 3:
            f.append(Finding(
                "R1", wire.path, line,
                f"SPAN_CTX_SIZE = {val} but % 4 must be 3: record "
                f"bodies are whole i32 words, so only a %4==3 "
                f"trailer is structurally unambiguous"))
    else:
        f.append(Finding("R1", wire.path, 1,
                         "SPAN_CTX_SIZE not defined"))

    # Ev <-> enum rlo_ev (both directions, value equality): the two
    # tracer rings merge into ONE timeline, so a kind renumbered on
    # one side corrupts every merged trace
    py_evs = py_enum_members(ctx.tracing, "Ev")
    c_evs = hdr.enums.get("rlo_ev", {})
    for name, (val, line) in py_evs.items():
        c_name = f"RLO_EV_{name}"
        if c_name not in c_evs:
            f.append(Finding(
                "R1", ctx.tracing.path, line,
                f"Ev.{name} has no {c_name} in {hdr.path}"))
        elif c_evs[c_name][0] != val:
            f.append(Finding(
                "R1", ctx.tracing.path, line,
                f"Ev.{name} = {val} but {c_name} = "
                f"{c_evs[c_name][0]} ({hdr.path}:{c_evs[c_name][1]})"))
    for c_name, (val, line) in c_evs.items():
        if c_name.replace("RLO_EV_", "") not in py_evs:
            f.append(Finding(
                "R1", hdr.path, line,
                f"{c_name} has no Ev member in utils/tracing.py"))

    # HIST_BUCKETS triple (metrics.py / bindings.py / RLO_HIST_BUCKETS)
    m_assigns = py_top_assigns(ctx.metrics)
    c_hb = hdr.macro("RLO_HIST_BUCKETS")
    for mod, assigns_ in ((ctx.metrics, m_assigns),
                          (bindings, b_assigns)):
        if "HIST_BUCKETS" in assigns_:
            node, line = assigns_["HIST_BUCKETS"]
            if mod is ctx.metrics:
                _require_anchor(ctx, f, mod, line, "HIST_BUCKETS")
            _check_pair(f, "R1", mod.path, line, "HIST_BUCKETS",
                        _const_int(node), hdr.path, "RLO_HIST_BUCKETS",
                        c_hb)
        else:
            f.append(Finding("R1", mod.path, 1,
                             "HIST_BUCKETS not defined"))
    return f


def rule_r2(ctx: "LintContext") -> List[Finding]:
    """Metrics-schema parity: ENGINE_COUNTER_KEYS <-> rlo_stats <->
    ProgressEngine.metrics(); ENGINE_PHASE_KEYS <-> rlo_phase_stats
    <-> the metrics() phase literal <-> _phobs() call sites."""
    f: List[Finding] = []
    metrics, hdr = ctx.metrics, ctx.header
    assigns = py_top_assigns(metrics)
    if "ENGINE_COUNTER_KEYS" not in assigns:
        return [Finding("R2", metrics.path, 1,
                        "ENGINE_COUNTER_KEYS not defined")]
    node, line = assigns["ENGINE_COUNTER_KEYS"]
    _require_anchor(ctx, f, metrics, line, "ENGINE_COUNTER_KEYS")
    if not isinstance(node, (ast.Tuple, ast.List)):
        return f + [Finding("R2", metrics.path, line,
                            "ENGINE_COUNTER_KEYS is not a literal tuple")]
    keys = tuple(e.value for e in node.elts
                 if isinstance(e, ast.Constant))

    stats = hdr.structs.get("rlo_stats")
    if stats is None:
        return f + [Finding("R2", hdr.path, 1,
                            "struct rlo_stats not found")]
    # counters = the leading int64 fields up to the first live-depth
    # (q_*) field; the rest of the struct is queues + histograms
    c_counters: List[str] = []
    for name, ctype, arr, fline in stats:
        if name.startswith("q_"):
            break
        c_counters.append(name)
    if keys != tuple(c_counters):
        f.append(Finding(
            "R2", metrics.path, line,
            f"ENGINE_COUNTER_KEYS {keys} != rlo_stats counter fields "
            f"{tuple(c_counters)} ({hdr.path})"))

    # the Python engine's metrics() literal must assemble the same keys
    mfn = _find_funcdef(ctx.engine.tree, "metrics")
    vals_keys: Optional[Set[str]] = None
    vals_line = line
    if mfn is not None:
        for n in ast.walk(mfn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name) and \
                    n.targets[0].id == "vals" and \
                    isinstance(n.value, ast.Dict):
                vals_keys = {k.value for k in n.value.keys
                             if isinstance(k, ast.Constant)}
                vals_line = n.lineno
    if vals_keys is None:
        f.append(Finding("R2", ctx.engine.path, 1,
                         "ProgressEngine.metrics() counter dict "
                         "('vals') not found"))
    elif vals_keys != set(keys):
        f.append(Finding(
            "R2", ctx.engine.path, vals_line,
            f"metrics() assembles counters {sorted(vals_keys)} but "
            f"ENGINE_COUNTER_KEYS is {sorted(keys)}"))

    # --- phase-profiler schema (docs/DESIGN.md §10): Python registry
    # tuple <-> rlo_phase_stats field order <-> the metrics() 'phs'
    # literal <-> the engine's _phobs() observation sites ---
    if "ENGINE_PHASE_KEYS" not in assigns:
        f.append(Finding("R2", metrics.path, 1,
                         "ENGINE_PHASE_KEYS not defined"))
        return f
    pnode, pline = assigns["ENGINE_PHASE_KEYS"]
    _require_anchor(ctx, f, metrics, pline, "ENGINE_PHASE_KEYS")
    if not isinstance(pnode, (ast.Tuple, ast.List)):
        f.append(Finding("R2", metrics.path, pline,
                         "ENGINE_PHASE_KEYS is not a literal tuple"))
        return f
    pkeys = tuple(e.value for e in pnode.elts
                  if isinstance(e, ast.Constant))
    pstats = hdr.structs.get("rlo_phase_stats")
    if pstats is None:
        f.append(Finding("R2", hdr.path, 1,
                         "struct rlo_phase_stats not found"))
        return f
    c_phases = tuple(name for name, _, _, _ in pstats)
    if pkeys != c_phases:
        f.append(Finding(
            "R2", metrics.path, pline,
            f"ENGINE_PHASE_KEYS {pkeys} != rlo_phase_stats fields "
            f"{c_phases} ({hdr.path}) — the field ORDER is the "
            f"snapshot/trace-index contract"))

    # the Python engine's metrics() phase literal ('phs') must
    # assemble exactly the schema keys (mirror of the 'vals' check)
    phs_keys: Optional[Set[str]] = None
    phs_line = pline
    if mfn is not None:
        for n in ast.walk(mfn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name) and \
                    n.targets[0].id == "phs" and \
                    isinstance(n.value, ast.Dict):
                phs_keys = {k.value for k in n.value.keys
                            if isinstance(k, ast.Constant)}
                phs_line = n.lineno
    if phs_keys is None:
        f.append(Finding("R2", ctx.engine.path, 1,
                         "ProgressEngine.metrics() phase dict "
                         "('phs') not found"))
    elif phs_keys != set(pkeys):
        f.append(Finding(
            "R2", ctx.engine.path, phs_line,
            f"metrics() assembles phases {sorted(phs_keys)} but "
            f"ENGINE_PHASE_KEYS is {sorted(pkeys)}"))

    # every _phobs("<stage>", ...) call site names a schema key, and
    # every key has at least one observation site — a phase with no
    # observations (or an observation into a key the snapshot never
    # emits) is silent schema drift
    observed: Set[str] = set()
    for n in ast.walk(ctx.engine.tree):
        if isinstance(n, ast.Call) and \
                isinstance(n.func, ast.Attribute) and \
                n.func.attr == "_phobs" and n.args and \
                isinstance(n.args[0], ast.Constant):
            key = n.args[0].value
            if key not in pkeys:
                f.append(Finding(
                    "R2", ctx.engine.path, n.lineno,
                    f"_phobs({key!r}) is not an ENGINE_PHASE_KEYS "
                    f"member — the sample would KeyError at runtime"))
            else:
                observed.add(key)
    for key in pkeys:
        if key not in observed:
            f.append(Finding(
                "R2", metrics.path, pline,
                f"phase {key!r} has no _phobs() observation site in "
                f"{ctx.engine.path}"))

    f.extend(_r2_telem(ctx, keys))
    return f


def _consume_pair_anchor(ctx: "LintContext", findings: List[Finding],
                         mod: PyModule, line: int,
                         symbol: str) -> None:
    """R2's paired-with anchor consumption (mirror of R1's
    _require_anchor, reporting under R2)."""
    at = find_anchor(mod.lines, line, PAIRED_ANCHOR)
    if at is None:
        findings.append(Finding(
            "R2", mod.path, line,
            f"paired constant {symbol} lacks a "
            f"'# {PAIRED_ANCHOR} <file:symbol>' anchor comment"))
    else:
        ctx.registry.consume(mod.path, at)


def _r2_telem(ctx: "LintContext",
              counter_keys: Tuple[str, ...]) -> List[Finding]:
    """Telemetry-digest schema parity (docs/DESIGN.md §17):
    wire.py's TELEM_KEYS (= ENGINE_COUNTER_KEYS + TELEM_EXTRA_KEYS)
    <-> the C codec's k_telem_keys name table (rlo_wire.c) <->
    RLO_TELEM_NKEYS, plus the byte-layout constants (magic bytes,
    header size). A digest key added on one side only would decode
    into the wrong slots fleet-wide — this is the same class of drift
    R2's counter check pins, one layer up."""
    f: List[Finding] = []
    wire, hdr = ctx.wire, ctx.header
    assigns = py_top_assigns(wire)

    # TELEM_EXTRA_KEYS: literal tuple + anchor
    if "TELEM_EXTRA_KEYS" not in assigns:
        return [Finding("R2", wire.path, 1,
                        "TELEM_EXTRA_KEYS not defined")]
    enode, eline = assigns["TELEM_EXTRA_KEYS"]
    _consume_pair_anchor(ctx, f, wire, eline, "TELEM_EXTRA_KEYS")
    if not isinstance(enode, (ast.Tuple, ast.List)):
        return f + [Finding("R2", wire.path, eline,
                            "TELEM_EXTRA_KEYS is not a literal tuple")]
    extras = tuple(e.value for e in enode.elts
                   if isinstance(e, ast.Constant))

    # TELEM_KEYS must be exactly the concatenation of the two schema
    # tuples (so the counter block can never be reordered or elided)
    if "TELEM_KEYS" not in assigns:
        f.append(Finding("R2", wire.path, 1, "TELEM_KEYS not defined"))
        return f
    knode, kline = assigns["TELEM_KEYS"]
    if not (isinstance(knode, ast.BinOp) and
            isinstance(knode.op, ast.Add) and
            isinstance(knode.left, ast.Name) and
            knode.left.id == "ENGINE_COUNTER_KEYS" and
            isinstance(knode.right, ast.Name) and
            knode.right.id == "TELEM_EXTRA_KEYS"):
        f.append(Finding(
            "R2", wire.path, kline,
            "TELEM_KEYS must be ENGINE_COUNTER_KEYS + "
            "TELEM_EXTRA_KEYS (the digest schema embeds the counter "
            "schema verbatim)"))
    full = tuple(counter_keys) + extras
    if len(full) > 64:
        f.append(Finding(
            "R2", wire.path, kline,
            f"TELEM schema has {len(full)} keys; the digest mask is "
            f"a u64 (max 64)"))

    # RLO_TELEM_NKEYS + header size + magic bytes
    try:
        nkeys = hdr.macro("RLO_TELEM_NKEYS")
    except csrc.CParseError:
        f.append(Finding("R2", hdr.path, 1,
                         "RLO_TELEM_NKEYS not defined"))
        return f
    if nkeys != len(full):
        f.append(Finding(
            "R2", hdr.path, hdr.macros["RLO_TELEM_NKEYS"][1],
            f"RLO_TELEM_NKEYS = {nkeys} but the wire.py schema has "
            f"{len(full)} keys"))
    if "TELEM_HEADER_SIZE" in assigns:
        hnode, hline = assigns["TELEM_HEADER_SIZE"]
        _consume_pair_anchor(ctx, f, wire, hline, "TELEM_HEADER_SIZE")
        _check_pair(f, "R2", wire.path, hline, "TELEM_HEADER_SIZE",
                    _const_int(hnode), hdr.path,
                    "RLO_TELEM_HEADER_SIZE",
                    hdr.macro("RLO_TELEM_HEADER_SIZE"))
    else:
        f.append(Finding("R2", wire.path, 1,
                         "TELEM_HEADER_SIZE not defined"))
    if "TELEM_MAGIC" in assigns:
        mnode, mline = assigns["TELEM_MAGIC"]
        _consume_pair_anchor(ctx, f, wire, mline, "TELEM_MAGIC")
        py_magic = (mnode.value if isinstance(mnode, ast.Constant)
                    and isinstance(mnode.value, bytes) else None)
        cm = re.search(r'#define\s+RLO_TELEM_MAGIC\s+'
                       r'"((?:[^"\\]|\\.)*)"', hdr.raw)
        if cm is None:
            f.append(Finding("R2", hdr.path, 1,
                             "RLO_TELEM_MAGIC string macro not found"))
        else:
            c_magic = cm.group(1).encode().decode(
                "unicode_escape").encode("latin1")
            if py_magic != c_magic:
                f.append(Finding(
                    "R2", wire.path, mline,
                    f"TELEM_MAGIC {py_magic!r} != RLO_TELEM_MAGIC "
                    f"{c_magic!r} ({hdr.path})"))
    else:
        f.append(Finding("R2", wire.path, 1,
                         "TELEM_MAGIC not defined"))

    # the C codec's key-name table (rlo_wire.c) must list the SAME
    # keys in the SAME mask-bit order
    km = re.search(r"k_telem_keys\s*\[\s*RLO_TELEM_NKEYS\s*\]\s*=\s*"
                   r"\{(.*?)\}\s*;", ctx.wire_c_stripped, re.S)
    if km is None:
        f.append(Finding(
            "R2", WIRE_C, 1,
            "k_telem_keys[RLO_TELEM_NKEYS] name table not found"))
        return f
    c_keys = tuple(re.findall(r'"([^"]*)"', km.group(1)))
    if c_keys != full:
        f.append(Finding(
            "R2", WIRE_C, _line_of(ctx.wire_c_stripped, km.start()),
            f"k_telem_keys {c_keys} != wire.py TELEM schema {full} — "
            f"the mask-bit order IS the decode contract"))
    return f


def _match_ctype(cty: str, got: object, hdr: CHeader,
                 env: Dict[str, object]) -> Optional[str]:
    """None when the binding type `got` is valid for C type `cty`,
    else a message describing the mismatch."""
    base = cty.replace("*", "")
    if base in hdr.fn_typedefs and "*" not in cty:
        ret, params, _ = hdr.fn_typedefs[base]
        if not isinstance(got, _CFunc):
            return (f"expected a CFUNCTYPE for callback type {base}, "
                    f"got {got}")
        sub = _match_ctype(ret, got.ret, hdr, env)
        if sub is not None:
            return f"callback {base} restype: {sub}"
        if len(params) != len(got.args):
            return (f"callback {base} takes {len(params)} args, "
                    f"CFUNCTYPE declares {len(got.args)}")
        for i, p in enumerate(params):
            sub = _match_ctype(p, got.args[i], hdr, env)
            if sub is not None:
                return f"callback {base} arg {i}: {sub}"
        return None
    ok = _acceptable(cty, hdr)
    assert ok is not None
    if isinstance(got, str) and got in ok:
        return None
    return f"C type '{cty}' needs {sorted(ok)}, binding declares {got}"


def rule_r3(ctx: "LintContext") -> List[Finding]:
    """ctypes contract: header prototypes <-> bindings sig() calls,
    struct mirrors, callback typedefs."""
    f: List[Finding] = []
    hdr, bindings = ctx.header, ctx.bindings
    env = _bindings_env(bindings)

    load_fn = _find_funcdef(bindings.tree, "load")
    if load_fn is None:
        return [Finding("R3", bindings.path, 1,
                        "load() not found in bindings.py")]
    sigs: Dict[str, Tuple[object, List[object], int]] = {}
    for n in ast.walk(load_fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and \
                n.func.id == "sig" and len(n.args) == 3 and \
                isinstance(n.args[0], ast.Constant):
            name = n.args[0].value
            restype = _eval_ctype(n.args[1], env)
            argtypes = _eval_ctype(n.args[2], env)
            if not isinstance(argtypes, list):
                f.append(Finding("R3", bindings.path, n.lineno,
                                 f"sig({name!r}): argtypes is not a "
                                 f"list literal"))
                continue
            if name in sigs:
                f.append(Finding("R3", bindings.path, n.lineno,
                                 f"duplicate sig({name!r})"))
            sigs[name] = (restype, argtypes, n.lineno)

    for name, proto in sorted(hdr.protos.items()):
        if name not in sigs:
            f.append(Finding(
                "R3", bindings.path, load_fn.lineno,
                f"exported {name} ({hdr.path}:{proto.line}) has no "
                f"argtypes/restype declaration in load() — calls ride "
                f"the implicit-int default (64-bit truncation hazard)"))
            continue
        restype, argtypes, line = sigs[name]
        msg = _match_ctype(proto.ret, restype, hdr, env)
        if msg is not None:
            f.append(Finding("R3", bindings.path, line,
                             f"{name} restype: {msg}"))
        if len(argtypes) != len(proto.params):
            f.append(Finding(
                "R3", bindings.path, line,
                f"{name} takes {len(proto.params)} parameters "
                f"({hdr.path}:{proto.line}), binding declares "
                f"{len(argtypes)} argtypes"))
        else:
            for i, cty in enumerate(proto.params):
                msg = _match_ctype(cty, argtypes[i], hdr, env)
                if msg is not None:
                    f.append(Finding("R3", bindings.path, line,
                                     f"{name} arg {i}: {msg}"))

    for name, (_, _, line) in sorted(sigs.items()):
        if name not in hdr.protos:
            f.append(Finding(
                "R3", bindings.path, line,
                f"binding declares {name} but {hdr.path} does not "
                f"export it — dead binding or missing prototype"))

    # ctypes.Structure mirrors <-> C struct layouts
    mirrors = {v: k for k, v in STRUCT_MIRRORS.items()}
    for node in bindings.tree.body:
        if not isinstance(node, ast.ClassDef) or node.name not in mirrors:
            continue
        cname = mirrors[node.name]
        cfields = hdr.structs.get(cname)
        if cfields is None:
            f.append(Finding("R3", bindings.path, node.lineno,
                             f"{node.name}: struct {cname} not found in "
                             f"{hdr.path}"))
            continue
        pyfields: List[Tuple[str, object]] = []
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) and \
                    stmt.targets[0].id == "_fields_":
                for elt in getattr(stmt.value, "elts", []):
                    if isinstance(elt, ast.Tuple) and len(elt.elts) == 2 \
                            and isinstance(elt.elts[0], ast.Constant):
                        pyfields.append((elt.elts[0].value,
                                         _eval_ctype(elt.elts[1], env)))
        if [n for n, *_ in cfields] != [n for n, _ in pyfields]:
            f.append(Finding(
                "R3", bindings.path, node.lineno,
                f"{node.name}._fields_ names "
                f"{[n for n, _ in pyfields]} != struct {cname} fields "
                f"{[n for n, *_ in cfields]}"))
            continue
        for (cfname, cty, arr, _), (_, pty) in zip(cfields, pyfields):
            if arr is not None:
                want = f"{_SCALAR_CTYPES.get(cty, cty)} * {arr}"
                if str(pty) != want:
                    f.append(Finding(
                        "R3", bindings.path, node.lineno,
                        f"{node.name}.{cfname}: expected {want}, "
                        f"declared {pty}"))
                continue
            if cty in STRUCT_MIRRORS:
                if pty != STRUCT_MIRRORS[cty]:
                    f.append(Finding(
                        "R3", bindings.path, node.lineno,
                        f"{node.name}.{cfname}: expected "
                        f"{STRUCT_MIRRORS[cty]}, declared {pty}"))
                continue
            msg = _match_ctype(cty, pty, hdr, env)
            if msg is not None:
                f.append(Finding("R3", bindings.path, node.lineno,
                                 f"{node.name}.{cfname}: {msg}"))
    return f


#: legal ReqState transitions (from, to) when the assignment sits under
#: an equality guard on the same state field. Submit may re-arm any
#: settled slot; settled states may only be re-armed or invalidated.
ALLOWED_REQSTATE_TRANSITIONS = {
    ("INVALID", "IN_PROGRESS"), ("COMPLETED", "IN_PROGRESS"),
    ("FAILED", "IN_PROGRESS"),
    ("IN_PROGRESS", "COMPLETED"), ("IN_PROGRESS", "FAILED"),
    ("IN_PROGRESS", "INVALID"), ("COMPLETED", "INVALID"),
    ("FAILED", "INVALID"), ("INVALID", "INVALID"),
}


def _tag_names_in(node: ast.AST, enum_name: str = "Tag") -> Set[str]:
    """Enum members NAMED by a dispatch comparison: `x == Enum.X` or
    `x in (Enum.X, ...)` with literally-enumerated members. A
    membership test against an opaque set name (`tag in
    EPOCH_EXEMPT_TAGS`) deliberately does NOT count — the guard proves
    the tag reached a block, not that the block dispatches it, so a
    deleted handler inside the guard must still be a finding. Used for
    the engine's ``Tag`` dispatch and the serving fabric's ``Rec``
    record dispatch."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if not isinstance(n, ast.Compare) or len(n.ops) != 1:
            continue
        if not isinstance(n.ops[0], (ast.Eq, ast.In)):
            continue
        for cand in [n.comparators[0]]:
            if isinstance(cand, ast.Attribute) and \
                    isinstance(cand.value, ast.Name) and \
                    cand.value.id == enum_name:
                out.add(cand.attr)
            elif isinstance(cand, (ast.Tuple, ast.List, ast.Set)):
                for e in cand.elts:
                    if isinstance(e, ast.Attribute) and \
                            isinstance(e.value, ast.Name) and \
                            e.value.id == enum_name:
                        out.add(e.attr)
    return out


def rule_r4(ctx: "LintContext") -> List[Finding]:
    """Dispatch exhaustiveness + ReqState transition legality."""
    f: List[Finding] = []
    wire, engine, hdr = ctx.wire, ctx.engine, ctx.header
    py_tags = py_enum_members(wire, "Tag")
    c_tags = hdr.enums.get("rlo_tag", {})

    # --- Python dispatch (ProgressEngine._progress_once) ---
    disp = _find_funcdef(engine.tree, "_progress_once")
    if disp is None:
        f.append(Finding("R4", engine.path, 1,
                         "_progress_once (the tag dispatch) not found"))
        py_explicit: Set[str] = set()
        py_catchall = False
    else:
        py_explicit = _tag_names_in(disp)
        py_catchall = any(
            isinstance(n, ast.Attribute) and n.attr == "_on_other"
            for n in ast.walk(disp))

    # --- C dispatch: the progress-turn body. Since the batched-
    # progress refactor (docs/DESIGN.md §13) the switch lives in
    # rlo_engine_progress_budget (rlo_engine_progress_once is a
    # wrapper); older trees keep it in progress_once. ---
    body = _extract_c_function(ctx.engine_c_stripped,
                               "rlo_engine_progress_budget")
    if body is None:
        body = _extract_c_function(ctx.engine_c_stripped,
                                   "rlo_engine_progress_once")
    if body is None:
        f.append(Finding("R4", ENGINE_C, 1,
                         "rlo_engine_progress_budget/_once (the tag "
                         "switch) not found"))
        c_explicit: Set[str] = set()
        c_catchall = False
    else:
        text, _ = body
        c_explicit = {m.group(1) for m in re.finditer(
            r"case\s+RLO_TAG_(\w+)\s*:", text)}
        c_explicit |= {m.group(1) for m in re.finditer(
            r"tag\s*==\s*RLO_TAG_(\w+)", text)}
        c_catchall = re.search(r"\bdefault\s*:", text) is not None

    def annotated(path: str, raw_lines: List[str], line: int) -> bool:
        """The default-route anchor may sit anywhere in the member's
        trailing comment block — scan forward until the next member
        definition or the end of the enum.  A matched anchor is
        consumed (S0 audit): an anchor on a member that GAINED an
        explicit handler is never looked up here, stays unconsumed,
        and rots visibly."""
        for ln in range(line, min(line + 8, len(raw_lines) + 1)):
            text = raw_lines[ln - 1]
            if ln > line and (re.search(r"\w+\s*=\s*-?\d+", text) or
                              "}" in text):
                return False
            if DEFAULT_ROUTE_ANCHOR in text:
                ctx.registry.consume(path, ln)
                return True
        return False

    hdr_lines = hdr.raw.splitlines()
    for name, (val, line) in sorted(py_tags.items(),
                                    key=lambda kv: kv[1][0]):
        if name not in py_explicit:
            if not annotated(wire.path, wire.lines, line):
                f.append(Finding(
                    "R4", wire.path, line,
                    f"Tag.{name} has no handler in ProgressEngine."
                    f"_progress_once and is not annotated "
                    f"'# {DEFAULT_ROUTE_ANCHOR}'"))
            elif not py_catchall:
                f.append(Finding(
                    "R4", engine.path, 1,
                    f"Tag.{name} is default-routed but _progress_once "
                    f"has no _on_other catch-all"))
        c_name = f"RLO_TAG_{name}"
        if c_name in c_tags and name not in c_explicit:
            c_line = c_tags[c_name][1]
            if not annotated(hdr.path, hdr_lines, c_line):
                f.append(Finding(
                    "R4", hdr.path, c_line,
                    f"{c_name} has no case in rlo_engine_progress_once "
                    f"and is not annotated '{DEFAULT_ROUTE_ANCHOR}'"))
            elif not c_catchall:
                f.append(Finding(
                    "R4", ENGINE_C, 1,
                    f"{c_name} is default-routed but the tag switch "
                    f"has no default label"))

    # --- MSYNC sub-kind dispatch (the PR-16 epoch catch-up plane) ---
    # The kind byte is routed by an open if/elif chain in BOTH engines
    # (no catch-all: an unknown kind is ignored on the wire by
    # design), so a sub-kind that loses its arm goes silent, not
    # loud.  Every MSYNC_* constant must be explicitly compared in the
    # dispatcher, and the two engines must agree on the sub-kind set.
    py_kinds: Dict[str, int] = {}
    for n in engine.tree.body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Name) and \
                n.targets[0].id.startswith("MSYNC_"):
            py_kinds[n.targets[0].id] = n.lineno
    mdisp = _find_funcdef(engine.tree, "_on_msync")
    if py_kinds and mdisp is None:
        f.append(Finding("R4", engine.path, 1,
                         "_on_msync (the MSYNC sub-kind dispatch) "
                         "not found"))
    elif py_kinds:
        py_hit = {
            cmp_.comparators[0].id
            for cmp_ in ast.walk(mdisp)
            if isinstance(cmp_, ast.Compare) and len(cmp_.ops) == 1 and
            isinstance(cmp_.ops[0], ast.Eq) and
            isinstance(cmp_.comparators[0], ast.Name)}
        for name, line in sorted(py_kinds.items(),
                                 key=lambda kv: kv[1]):
            if name not in py_hit:
                f.append(Finding(
                    "R4", engine.path, line,
                    f"MSYNC sub-kind {name} has no arm in "
                    f"ProgressEngine._on_msync"))
    c_kinds = {
        m.group(1): _line_of(ctx.engine_c_stripped, m.start())
        for m in re.finditer(r"#define\s+RLO_(MSYNC_\w+)\s+\d",
                             ctx.engine_c_stripped)}
    mbody = _extract_c_function(ctx.engine_c_stripped, "on_msync")
    if c_kinds and mbody is None:
        f.append(Finding("R4", ENGINE_C, 1,
                         "on_msync (the MSYNC sub-kind dispatch) "
                         "not found"))
    elif c_kinds:
        mtext, _ = mbody
        c_hit = {m.group(1) for m in re.finditer(
            r"kind\s*==\s*RLO_(MSYNC_\w+)", mtext)}
        for name, line in sorted(c_kinds.items(),
                                 key=lambda kv: kv[1]):
            if name not in c_hit:
                f.append(Finding(
                    "R4", ENGINE_C, line,
                    f"MSYNC sub-kind RLO_{name} has no arm in "
                    f"on_msync"))
    for name in sorted(set(py_kinds) ^ set(c_kinds)):
        f.append(Finding(
            "R4", engine.path, py_kinds.get(name, 1),
            f"MSYNC sub-kind {name} is defined in only one engine "
            f"(engine.py has {sorted(py_kinds)}, rlo_engine.c has "
            f"{sorted(c_kinds)})"))

    # --- fabric record dispatch (serving/fabric.py, when present) ---
    # New Tag values the fabric rides on are covered by the Tag loop
    # above (SERVE is default-routed in both engines); the fabric's
    # OWN protocol surface is its Rec record kinds, dispatched in
    # DecodeFabric._on_record — hold them to the same exhaustiveness
    # bar so a record kind can never silently lose its handler.
    fab = ctx.extra_py.get(FABRIC_PY)
    if fab is not None:
        try:
            rec_members = py_enum_members(fab, "Rec")
        except LintError:
            rec_members = {}
        fdisp = _find_funcdef(fab.tree, "_on_record")
        if rec_members and fdisp is None:
            f.append(Finding(
                "R4", fab.path, 1,
                "_on_record (the fabric record dispatch) not found"))
        elif rec_members:
            fab_explicit = _tag_names_in(fdisp, enum_name="Rec")
            for name, (_, line) in sorted(rec_members.items(),
                                          key=lambda kv: kv[1][0]):
                if name not in fab_explicit and \
                        not annotated(fab.path, fab.lines, line):
                    f.append(Finding(
                        "R4", fab.path, line,
                        f"Rec.{name} has no branch in DecodeFabric."
                        f"_on_record and is not annotated "
                        f"'# {DEFAULT_ROUTE_ANCHOR}'"))

    # --- ReqState transitions (Python) ---
    states = set(py_enum_members(engine, "ReqState"))
    _attach_parents(engine.tree)
    for n in ast.walk(engine.tree):
        if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
            continue
        tgt = n.targets[0]
        if not (isinstance(tgt, ast.Attribute) and tgt.attr == "state"):
            continue
        val = n.value
        if not (isinstance(val, ast.Attribute) and
                isinstance(val.value, ast.Name) and
                val.value.id == "ReqState"):
            continue
        to_state = val.attr
        if to_state not in states:
            f.append(Finding("R4", engine.path, n.lineno,
                             f"assignment to unknown ReqState."
                             f"{to_state}"))
            continue
        from_state = _guarding_state(n)
        if from_state is not None and \
                (from_state, to_state) not in \
                ALLOWED_REQSTATE_TRANSITIONS:
            f.append(Finding(
                "R4", engine.path, n.lineno,
                f"ReqState transition {from_state} -> {to_state} is "
                f"not in the allowed-transition table"))

    # --- C state assignments name real enum members ---
    c_states = set(hdr.enums.get("rlo_state", {}))
    for m in re.finditer(r"(?:->|\.)state\s*=\s*(RLO_\w+)",
                         ctx.engine_c_stripped):
        if m.group(1) not in c_states:
            f.append(Finding(
                "R4", ENGINE_C,
                _line_of(ctx.engine_c_stripped, m.start()),
                f"state assigned {m.group(1)}, not a member of "
                f"enum rlo_state"))
    return f


def _guarding_state(node: ast.AST) -> Optional[str]:
    """Innermost enclosing `if <...>.state == ReqState.X` whose THEN
    branch contains ``node`` (elif/else ancestry is skipped: being in
    an orelse means the guard is known false)."""
    child = node
    parent = getattr(node, "_rlo_parent", None)
    while parent is not None:
        if isinstance(parent, ast.If) and _in_block(parent.body, child):
            for cmp_ in ast.walk(parent.test):
                if isinstance(cmp_, ast.Compare) and \
                        len(cmp_.ops) == 1 and \
                        isinstance(cmp_.ops[0], ast.Eq) and \
                        isinstance(cmp_.left, ast.Attribute) and \
                        cmp_.left.attr == "state":
                    rhs = cmp_.comparators[0]
                    if isinstance(rhs, ast.Attribute) and \
                            isinstance(rhs.value, ast.Name) and \
                            rhs.value.id == "ReqState":
                        return rhs.attr
        child = parent
        parent = getattr(parent, "_rlo_parent", None)
    return None


def _in_block(block: Sequence[ast.AST], node: ast.AST) -> bool:
    return any(stmt is node or any(n is node for n in ast.walk(stmt))
               for stmt in block)


#: time.* attributes sanctioned in engine/sim code: `monotonic` is the
#: injectable-clock default (the simulator overrides it with virtual
#: time); everything else is a determinism leak.
_TIME_ALLOWED = {"monotonic"}
_RANDOM_ALLOWED = {"Random"}


def rule_r5(ctx: "LintContext") -> List[Finding]:
    """Determinism hygiene in the engine/transport/sim code paths."""
    f: List[Finding] = []
    for rel in R5_FILES:
        mod = ctx.extra_py.get(rel)
        if mod is None:
            continue

        def flag(line: int, msg: str) -> None:
            at = find_anchor(mod.lines, line, ALLOW_WALLCLOCK_ANCHOR,
                             lookback=1)
            if at is None:
                f.append(Finding("R5", mod.path, line, msg))
            else:
                ctx.registry.consume(mod.path, at)

        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Attribute) and \
                    isinstance(n.value, ast.Name):
                if n.value.id == "time" and n.attr not in _TIME_ALLOWED:
                    flag(n.lineno,
                         f"time.{n.attr} in seed-deterministic code — "
                         f"use the injectable world.clock abstraction")
                elif n.value.id == "random" and \
                        n.attr not in _RANDOM_ALLOWED:
                    flag(n.lineno,
                         f"module-level random.{n.attr} in seed-"
                         f"deterministic code — use a seeded "
                         f"random.Random instance")
            elif isinstance(n, ast.ImportFrom) and n.module in (
                    "time", "random"):
                allowed = (_TIME_ALLOWED if n.module == "time"
                           else _RANDOM_ALLOWED)
                for alias in n.names:
                    if alias.name not in allowed:
                        flag(n.lineno,
                             f"from {n.module} import {alias.name} in "
                             f"seed-deterministic code")
    return f


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

@dataclass
class LintContext:
    root: Path
    wire: PyModule
    metrics: PyModule
    engine: PyModule
    bindings: PyModule
    tracing: PyModule
    header: CHeader
    wire_c_stripped: str
    engine_c_stripped: str
    extra_py: Dict[str, PyModule]
    registry: AnchorRegistry


def build_context(root: Path,
                  registry: Optional[AnchorRegistry] = None
                  ) -> LintContext:
    root = Path(root).resolve()
    extra: Dict[str, PyModule] = {}
    engine = parse_py(root / ENGINE_PY, ENGINE_PY)
    extra[ENGINE_PY] = engine
    for rel in R5_FILES:
        if rel not in extra and (root / rel).exists():
            extra[rel] = parse_py(root / rel, rel)
    try:
        wire_c = (root / WIRE_C).read_text()
        engine_c = (root / ENGINE_C).read_text()
    except OSError as e:
        raise LintError(f"cannot read C sources: {e}")
    return LintContext(
        root=root,
        wire=parse_py(root / WIRE_PY, WIRE_PY),
        metrics=parse_py(root / METRICS_PY, METRICS_PY),
        engine=engine,
        bindings=parse_py(root / BINDINGS_PY, BINDINGS_PY),
        tracing=parse_py(root / TRACING_PY, TRACING_PY),
        header=parse_c_header(root / CORE_H, CORE_H),
        wire_c_stripped=_strip_c_comments(wire_c),
        engine_c_stripped=_strip_c_comments(engine_c),
        extra_py=extra,
        registry=registry if registry is not None else AnchorRegistry(),
    )


_RULES = {"R1": rule_r1, "R2": rule_r2, "R3": rule_r3, "R4": rule_r4,
          "R5": rule_r5}


def audit_files(root: Path) -> List[str]:
    """Files whose anchors fall under the stale-anchor audit (the
    files rlo-lint reads; rlo-sentinel unions its own set in)."""
    fixed = [WIRE_PY, METRICS_PY, ENGINE_PY, BINDINGS_PY, TRACING_PY,
             CORE_H, WIRE_C, ENGINE_C]
    return fixed + [rel for rel in R5_FILES
                    if (Path(root) / rel).exists()]


def run_lint(root: Path, rules: Optional[Sequence[str]] = None,
             registry: Optional[AnchorRegistry] = None
             ) -> List[Finding]:
    """Run the selected rule families (default: all) against the tree
    at ``root``; returns findings sorted by file/line.  ``registry``
    (when given) accumulates the anchor lines the rules consumed — the
    input to rlo-sentinel's S0 stale-anchor audit."""
    ctx = build_context(root, registry)
    out: List[Finding] = []
    for rid in rules or RULE_IDS:
        if rid not in _RULES:
            raise LintError(f"unknown rule {rid!r} (have "
                            f"{', '.join(RULE_IDS)})")
        out.extend(_RULES[rid](ctx))
    out.sort(key=lambda x: (x.file, x.line, x.rule))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rlo_tpu_torch.tools.rlo_lint",
        description="Static cross-engine protocol-conformance analyzer "
                    "(rule catalogue: docs/DESIGN.md §9).")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule families (default: all), "
                         "e.g. --rules R1,R3")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)
    rules = ([r.strip().upper() for r in args.rules.split(",") if
              r.strip()] if args.rules else None)
    try:
        findings = run_lint(args.root, rules)
    except ToolError as e:
        print(f"rlo-lint: error: {e}", file=sys.stderr)
        return 2
    return emit(findings, prog="rlo-lint",
                ran=",".join(rules or RULE_IDS), root=args.root,
                as_json=args.json, quiet=args.quiet)


if __name__ == "__main__":
    sys.exit(main())
