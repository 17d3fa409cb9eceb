"""rlo-sentinel — CFG/dataflow analyzer for the dual engines.

The port's copy of ``rlo_tpu/tools/rlo_sentinel.py``, over the port's
C core (``rlo_tpu_torch/native/*.c``), engine and fabric; its S0 audit
runs the port's lint and prover anchor rules, the CUDA sources
included.

rlo-lint (docs/DESIGN.md §9) pins *surface* parity between the Python
``ProgressEngine`` and the C ``rlo_engine``: offsets, keys, signatures,
dispatch coverage.  rlo-sentinel checks the properties that actually
break concurrent dual-engine systems — statically, on every tree,
instead of only when a sanitizer leg happens to execute the broken
path.  It lifts the rlo-lint mini C parser into per-function CFGs
(``rlo_tpu_torch/tools/csrc.py``) and reuses Python ``ast`` for the
engine/serving modules.  Rule catalogue (docs/DESIGN.md §15):

  S0 stale-anchor audit — every ``rlo-lint:`` / ``rlo-sentinel:``
     anchor in an analyzed file must be *consumed* by some rule this
     run; an anchor that no longer suppresses or declares anything is
     annotation rot and gets flagged (shared pass over both tools'
     anchor namespaces).
  S1 GIL-release safety — compute the call graph reachable from the
     GIL-releasing ctypes entry points (``rlo_engine_progress_n``,
     ``rlo_world_progress_all_n``, plus any binding annotated
     ``rlo-sentinel: gil-released``) and flag any write to (or
     address-of) file-scope mutable storage: per-world ownership is
     the concurrency contract the threaded TSan selftest relies on,
     and process-global state breaks it for concurrent drivers even
     on *different* worlds.  A variable that is deliberately shared
     and lock-protected carries ``rlo-sentinel: guarded-by(<lock>)``
     on its declaration.
  S2 wire-input taint — header/payload fields read out of a received
     frame (``rlo_frame_decode`` results and ``get_le32``-style
     payload reads in C; ``struct.unpack`` of wire bytes in Python;
     the transports' receive-record headers) are tainted until they
     pass a bounds/validity check; a tainted value used as an array
     index, an allocation/copy length, or an unchecked buffer access
     without a *dominating* guard is flagged.  ``rlo-sentinel:
     trusted <why>`` suppresses a sanctioned sink line.
  S3 error-path resource leaks — intraprocedural path analysis over
     the C CFGs: an acquisition from the pool/blob/handle allocators
     (or any function annotated ``rlo-sentinel: owns``) must be
     released or ownership-transferred on every path to ``return``.
     Transfer facts are declared at the callee:
     ``rlo-sentinel: transfers(param[, param...])``.
  S4 state-machine absorption — extract the full proposal ReqState
     transition relation from both engines' guarded assignments,
     compute the closure, and prove: settled verdicts never flip
     (COMPLETED/FAILED are absorbing modulo the sanctioned
     re-arm-to-IN_PROGRESS), every state reaches a terminal, and both
     engines induce the SAME relation.

Usage:
  python -m rlo_tpu_torch.tools.rlo_sentinel [--root DIR] [--rules S1,S3]
                                       [--json] [-q]

Exit codes: 0 clean, 1 findings, 2 bad invocation / missing inputs.
Soundness caveats — what the analyzer deliberately does NOT claim —
are documented in docs/DESIGN.md §15.
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from rlo_tpu_torch.tools import csrc
from rlo_tpu_torch.tools.runner import (AnchorRegistry, Finding, ToolError,
                                        audit_stale_anchors, emit)

RULE_IDS = ("S0", "S1", "S2", "S3", "S4")

#: the C library sources (the Makefile's $(SRCS) — what ctypes loads)
C_FILES = (
    "rlo_tpu_torch/native/rlo_topology.c",
    "rlo_tpu_torch/native/rlo_wire.c",
    "rlo_tpu_torch/native/rlo_trace.c",
    "rlo_tpu_torch/native/rlo_world_common.c",
    "rlo_tpu_torch/native/rlo_loopback.c",
    "rlo_tpu_torch/native/rlo_shm.c",
    "rlo_tpu_torch/native/rlo_mpi.c",
    "rlo_tpu_torch/native/rlo_tcp.c",
    "rlo_tpu_torch/native/rlo_engine.c",
    "rlo_tpu_torch/native/rlo_coll.c",
    "rlo_tpu_torch/native/rlo_bench.c",
)
CORE_H = "rlo_tpu_torch/native/rlo_core.h"
ENGINE_PY = "rlo_tpu_torch/engine.py"
WIRE_PY = "rlo_tpu_torch/wire.py"
FABRIC_PY = "rlo_tpu_torch/serving/fabric.py"
BINDINGS_PY = "rlo_tpu_torch/native/bindings.py"
#: Python modules the taint rule walks (the wire-input consumers)
PY_TAINT_FILES = (ENGINE_PY, WIRE_PY, FABRIC_PY)

#: ctypes entry points that release the GIL for their whole (batched)
#: duration — the S1 roots (docs/DESIGN.md §13).  Extended by
#: ``rlo-sentinel: gil-released`` anchors on bindings.py sig() lines.
GIL_ROOTS = ("rlo_engine_progress_n", "rlo_world_progress_all_n")

# ---- anchor spellings -------------------------------------------------------
GUARDED_BY = "rlo-sentinel: guarded-by"
TRUSTED = "rlo-sentinel: trusted"
OWNS = "rlo-sentinel: owns"
TRANSFERS = "rlo-sentinel: transfers"
GIL_RELEASED = "rlo-sentinel: gil-released"
TRANSITION = "rlo-sentinel: transition"

#: built-in allocation/release/no-op call sets for S3
ALLOC_FNS = {"malloc", "calloc", "realloc", "rlo_pool_alloc",
             "rlo_blob_new", "rlo_blob_new_w", "rlo_handle_new",
             "rlo_handle_new_w"}
RELEASE_FNS = {"free", "rlo_pool_free", "rlo_blob_unref",
               "rlo_handle_unref"}

#: C taint sources: functions whose return value derives from wire
#: bytes (S2)
C_TAINT_FNS = {"get_le32", "get_i32", "get_u64", "vote_gen"}
#: decoders whose &out-params are filled from wire bytes: every
#: &-taken argument at a call site becomes tainted (rlo_span_decode is
#: the PR-17 span trailer — gateway/seq/stage/flags all attacker-set)
C_DECODE_FNS = {"rlo_frame_decode", "rlo_span_decode"}
#: receive-record struct bases: any ``<base>.field`` / ``<base>->field``
#: chain rooted at one of these names is wire input (the transports'
#: reassembly headers)
C_TAINT_BASES = {"rhdr", "rec"}
#: C sinks: calls where a tainted value as ANY argument means a
#: wire-controlled allocation size / copy length
C_SIZE_SINKS = {"memcpy", "memmove", "memset", "malloc", "calloc",
                "alloca", "rlo_blob_new", "rlo_blob_new_w",
                "rlo_pool_alloc", "ring_read", "ring_write"}

_RELOP = {"<", ">", "<=", ">=", "==", "!="}

#: proposal state machine (S4): terminal / settled / re-arm semantics
S4_STATES = ("COMPLETED", "IN_PROGRESS", "FAILED", "INVALID")
S4_SETTLED = ("COMPLETED", "FAILED")
S4_TERMINAL = ("COMPLETED", "FAILED", "INVALID")


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

@dataclass
class SentinelContext:
    root: Path
    model: csrc.CModel
    header: csrc.CHeader
    py: Dict[str, ast.Module]
    py_lines: Dict[str, List[str]]
    registry: AnchorRegistry
    #: fn name -> set of parameter indexes whose ownership the callee
    #: takes (from ``transfers(...)`` anchors)
    transfers: Dict[str, Set[int]] = field(default_factory=dict)
    #: fns returning an owned pointer (``owns`` anchors + builtins)
    owns: Set[str] = field(default_factory=set)
    #: extra S1 roots from ``gil-released`` anchors in bindings.py
    extra_roots: List[str] = field(default_factory=list)
    #: file-scope vars with a ``guarded-by`` anchor: name -> anchor line
    guarded_vars: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    #: sanctioned extra S4 edges: (engine, from, to) -> anchor site
    sanctioned_edges: Dict[Tuple[str, str, str], Tuple[str, int]] = \
        field(default_factory=dict)
    #: ``trusted`` anchor lines per file (line -> consumed?)
    trusted_lines: Dict[str, Set[int]] = field(default_factory=dict)


def _parse_py(root: Path, rel: str) -> Tuple[ast.Module, List[str]]:
    try:
        raw = (root / rel).read_text()
    except OSError as e:
        raise ToolError(f"cannot read {rel}: {e}")
    try:
        tree = ast.parse(raw, filename=rel)
    except SyntaxError as e:
        raise ToolError(f"cannot parse {rel}: {e}")
    return tree, raw.splitlines()


def build_context(root: Path) -> SentinelContext:
    root = Path(root).resolve()
    try:
        model = csrc.parse_c_files(root, C_FILES)
        header = csrc.parse_c_header(root / CORE_H, CORE_H)
    except csrc.CParseError as e:
        raise ToolError(str(e))
    py: Dict[str, ast.Module] = {}
    py_lines: Dict[str, List[str]] = {}
    for rel in set(PY_TAINT_FILES) | {BINDINGS_PY}:
        tree, lines = _parse_py(root, rel)
        py[rel] = tree
        py_lines[rel] = lines
    ctx = SentinelContext(root=root, model=model, header=header, py=py,
                          py_lines=py_lines, registry=AnchorRegistry())
    _collect_c_anchors(ctx)
    _collect_py_anchors(ctx)
    return ctx


def _func_def_lines(ctx: SentinelContext, path: str) -> Dict[int, str]:
    """line -> function name for definitions in one C file."""
    return {fn.line: fn.name for fn in ctx.model.funcs.values()
            if fn.path == path}


def _collect_c_anchors(ctx: SentinelContext) -> None:
    """Parse the ownership / shared-state anchor grammar out of the C
    sources.  ``owns``/``transfers(...)`` attach to the function whose
    definition starts on the anchor line or within the next 4 lines;
    ``guarded-by(...)`` attaches to the file-scope variable declared on
    (or within 2 lines below) the anchor line.  Anchors that attach to
    nothing are left unconsumed — the S0 audit reports them."""
    for path, lines in ctx.model.raw_lines.items():
        defs = _func_def_lines(ctx, path)
        vars_here = {v.line: v.name for v in ctx.model.file_vars.values()
                     if v.path == path}
        for i, text in enumerate(lines, start=1):
            m = re.search(r"rlo-sentinel: transfers\(([^)]*)\)", text)
            if m:
                fn = next((defs[ln] for ln in range(i, i + 5)
                           if ln in defs), None)
                if fn is not None:
                    params = ctx.model.funcs[fn].params
                    idxs = set()
                    ok = True
                    for p in m.group(1).split(","):
                        p = p.strip()
                        if p in params:
                            idxs.add(params.index(p))
                        else:
                            ok = False
                    if ok and idxs:
                        ctx.transfers.setdefault(fn, set()).update(idxs)
                        ctx.registry.consume(path, i)
            elif re.search(r"rlo-sentinel: owns\b", text):
                fn = next((defs[ln] for ln in range(i, i + 5)
                           if ln in defs), None)
                if fn is not None:
                    ctx.owns.add(fn)
                    ctx.registry.consume(path, i)
            m = re.search(r"rlo-sentinel: guarded-by\(([^)]*)\)", text)
            if m:
                var = next((vars_here[ln] for ln in range(i, i + 3)
                            if ln in vars_here), None)
                if var is not None:
                    ctx.guarded_vars[var] = (path, i)
                    # consumed only when it actually suppresses (S1)
            m = re.search(
                r"rlo-sentinel: transition (\w+)\s*->\s*(\w+)", text)
            if m:
                eng = "c" if path.endswith(".c") else "py"
                ctx.sanctioned_edges[(eng, m.group(1), m.group(2))] = \
                    (path, i)
            if TRUSTED in text:
                ctx.trusted_lines.setdefault(path, set()).add(i)


def _collect_py_anchors(ctx: SentinelContext) -> None:
    for rel, lines in ctx.py_lines.items():
        for i, text in enumerate(lines, start=1):
            if "#" in text and TRUSTED in text.split("#", 1)[1]:
                ctx.trusted_lines.setdefault(rel, set()).add(i)
            if rel == BINDINGS_PY and "#" in text and \
                    GIL_RELEASED in text.split("#", 1)[1]:
                m = re.search(r'sig\("(\w+)"', text)
                if m:
                    ctx.extra_roots.append(m.group(1))
                    ctx.registry.consume(rel, i)
            m = re.search(r"rlo-sentinel: transition (\w+)\s*->\s*(\w+)",
                          text)
            if m and "#" in text:
                ctx.sanctioned_edges[("py", m.group(1), m.group(2))] = \
                    (rel, i)


def _trusted(ctx: SentinelContext, path: str, line: int) -> bool:
    """A ``trusted <why>`` anchor on the sink/return line or in the
    comment block directly above it (up to 4 lines — the why rarely
    fits on one) suppresses an S2/S3 finding; consumption is
    recorded."""
    for ln in range(line, max(0, line - 5), -1):
        if ln in ctx.trusted_lines.get(path, ()):
            ctx.registry.consume(path, ln)
            return True
    return False


# ---------------------------------------------------------------------------
# S1 — GIL-release safety
# ---------------------------------------------------------------------------

_WRITE_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "|=", "&=", "^=",
              "<<=", ">>=", "++", "--"}


def rule_s1(ctx: SentinelContext) -> List[Finding]:
    f: List[Finding] = []
    model = ctx.model
    roots = list(GIL_ROOTS) + ctx.extra_roots
    reach = csrc.reachable_from(model, roots)
    # locks and C11 atomics are concurrency primitives DESIGNED for
    # shared access — out of scope; everything else file-scope and
    # mutable is a per-world-ownership violation when written from
    # GIL-released code
    mutable = {name: v for name, v in model.file_vars.items()
               if not v.is_const and "atomic_" not in v.decl and
               "pthread_" not in v.decl}
    for fname in sorted(reach):
        fn = model.funcs[fname]
        toks = fn.toks
        # locals shadow file-scope names: any occurrence immediately
        # preceded by an identifier is a declaration (`uint64_t head`)
        shadowed = set(fn.params)
        for k, (kind, text, line) in enumerate(toks):
            if kind == "id" and text in mutable and k and \
                    toks[k - 1][0] == "id" and \
                    toks[k - 1][1] not in csrc._KEYWORDS:
                shadowed.add(text)
        for k, (kind, text, line) in enumerate(toks):
            if kind != "id" or text not in mutable or text in shadowed:
                continue
            prev = toks[k - 1][1] if k else ""
            if prev in (".", "->"):
                continue  # field access, not the file-scope variable
            var = mutable[text]
            nxt = toks[k + 1][1] if k + 1 < len(toks) else ""
            write = nxt in _WRITE_OPS or prev in ("++", "--")
            # writes through the subscripted array: name[...] = / &name
            if nxt == "[":
                try:
                    close = csrc.match_paren(toks, k + 1)
                    after = toks[close + 1][1] if close + 1 < len(toks) \
                        else ""
                    write = write or after in _WRITE_OPS
                except csrc.CParseError:
                    pass
            addr_of = prev == "&"
            if not (write or addr_of):
                continue
            if text in ctx.guarded_vars:
                apath, aline = ctx.guarded_vars[text]
                ctx.registry.consume(apath, aline)
                continue
            what = "write to" if write else "address-of"
            f.append(Finding(
                "S1", fn.path, line,
                f"{what} file-scope mutable '{text}' "
                f"({var.path}:{var.line}) in '{fname}', reachable from "
                f"the GIL-releasing entry points {roots[:2]} — "
                f"concurrent per-world drivers race on process-global "
                f"state (docs/DESIGN.md §13/§15); make it thread-safe "
                f"and annotate the declaration "
                f"'rlo-sentinel: guarded-by(<lock>)', or move it into "
                f"the world/engine"))
    return f


# ---------------------------------------------------------------------------
# S2 — wire-input taint (C side)
# ---------------------------------------------------------------------------

def _norm_chain(toks: Sequence[csrc.Token], start: int) -> Tuple[str, int]:
    """Normalize a field chain starting at token ``start`` (an id):
    returns ("p->rhdr.len", next_index)."""
    parts = [toks[start][1]]
    i = start + 1
    while i + 1 < len(toks) and toks[i][1] in (".", "->") and \
            toks[i + 1][0] == "id":
        parts.append(toks[i][1] + toks[i + 1][1])
        i += 2
    return "".join(parts), i


def _chains_in(toks: Sequence[csrc.Token]) -> List[Tuple[str, int, int]]:
    """All normalized id/field chains in a token run, with (chain,
    first_token_index, line)."""
    out = []
    i = 0
    while i < len(toks):
        if toks[i][0] == "id":
            prev = toks[i - 1][1] if i else ""
            if prev in (".", "->"):
                i += 1
                continue
            chain, j = _norm_chain(toks, i)
            out.append((chain, i, toks[i][2]))
            i = j
        else:
            i += 1
    return out


def _taint_keys_c(fn: csrc.CFunc) -> Dict[str, int]:
    """Tainted keys (normalized var names / field chains) for one C
    function -> first tainted line."""
    keys: Dict[str, int] = {}
    for nd in fn.cfg.nodes:
        toks = nd.stmt.toks
        for k, (kind, text, line) in enumerate(toks):
            if kind != "id":
                continue
            nxt = toks[k + 1][1] if k + 1 < len(toks) else ""
            if text in C_DECODE_FNS and nxt == "(":
                close = csrc.match_paren(toks, k + 1)
                # &out-params are tainted; so is an LHS of the call
                for j in range(k + 2, close):
                    if toks[j][1] == "&" and toks[j + 1][0] == "id":
                        chain, _ = _norm_chain(toks, j + 1)
                        keys.setdefault(chain, line)
                if k >= 2 and toks[k - 1][1] == "=" and \
                        toks[k - 2][0] == "id":
                    keys.setdefault(toks[k - 2][1], line)
            elif text in C_TAINT_FNS and nxt == "(":
                # x = get_le32(...): taint the assignment target (the
                # last id-chain before the '=')
                if k >= 2 and toks[k - 1][1] == "=":
                    lhs = _chains_in(toks[:k - 1])
                    if lhs:
                        keys.setdefault(lhs[-1][0], line)
        # receive-record field chains are tainted wherever they appear
        for chain, _, line in _chains_in(toks):
            segs = re.split(r"->|\.", chain)
            if len(segs) >= 2 and any(s in C_TAINT_BASES
                                      for s in segs[:-1]):
                keys.setdefault(chain, line)
    return keys


def _cond_guards(fn: csrc.CFunc, key: str) -> Set[int]:
    """CFG node indexes of 'if' heads whose condition mentions ``key``
    together with a relational operator (the sanitizer shape)."""
    out: Set[int] = set()
    for nd in fn.cfg.nodes:
        if nd.stmt.kind != "if":
            continue
        toks = nd.stmt.toks
        if any(t[1] in _RELOP for t in toks) and \
                any(c == key for c, _, _ in _chains_in(toks)):
            out.add(nd.idx)
    return out


def rule_s2_c(ctx: SentinelContext) -> List[Finding]:
    f: List[Finding] = []
    for fname in sorted(ctx.model.funcs):
        fn = ctx.model.funcs[fname]
        keys = _taint_keys_c(fn)
        if not keys:
            continue
        dom = fn.cfg.dominators()
        guard_cache: Dict[str, Set[int]] = {}
        for nd in fn.cfg.nodes:
            toks = nd.stmt.toks
            if not toks or nd.stmt.kind in ("if",):
                continue
            loop_head = nd.stmt.kind in ("for", "while", "do")
            for key, src_line in keys.items():
                used_at = _sink_uses_c(toks, key, loop_head=loop_head)
                for sink_line, what in used_at:
                    guards = guard_cache.setdefault(
                        key, _cond_guards(fn, key))
                    if guards & dom[nd.idx]:
                        continue  # a bounds check dominates the sink
                    if _trusted(ctx, fn.path, sink_line):
                        continue
                    f.append(Finding(
                        "S2", fn.path, sink_line,
                        f"wire-tainted '{key}' (from line {src_line}) "
                        f"used as {what} in '{fname}' without a "
                        f"dominating bounds/validity check — a corrupt "
                        f"or hostile frame controls it "
                        f"(docs/DESIGN.md §15)"))
    return f


def _sink_uses_c(toks: Sequence[csrc.Token], key: str,
                 loop_head: bool = False) -> List[Tuple[int, str]]:
    """Sink uses of ``key`` in one statement: subscripts, size-taking
    calls, and (for ``loop_head`` statements) loop-bound comparisons —
    a wire-set count driving a for/while head is unbounded work unless
    a dominating check clamps it (the MSYNC_RSP member-record count is
    the canonical case)."""
    out: List[Tuple[int, str]] = []
    n = len(toks)
    if loop_head and any(t[1] in _RELOP for t in toks) and \
            any(c == key for c, _, _ in _chains_in(toks)):
        # a head that (re)initializes the key is binding a fresh
        # induction variable of the same name, not reading wire input
        rebinds = any(
            toks[k][0] == "id" and toks[k][1] == key and
            k + 1 < n and toks[k + 1][1] == "="
            for k in range(n))
        if not rebinds:
            out.append((toks[0][2], "a loop bound"))
    for k in range(n):
        kind, text, line = toks[k]
        if text == "[":
            try:
                close = csrc.match_paren(toks, k)
            except csrc.CParseError:
                continue
            inner = toks[k + 1:close]
            if any(c == key for c, _, _ in _chains_in(inner)):
                out.append((line, "an array index"))
        elif kind == "id" and text in C_SIZE_SINKS and k + 1 < n and \
                toks[k + 1][1] == "(":
            try:
                close = csrc.match_paren(toks, k + 1)
            except csrc.CParseError:
                continue
            inner = toks[k + 2:close]
            if any(c == key for c, _, _ in _chains_in(inner)):
                out.append((line, f"an allocation/copy length "
                                  f"({text})"))
    return out


# ---------------------------------------------------------------------------
# S2 — wire-input taint (Python side)
# ---------------------------------------------------------------------------

#: parameter names that carry raw wire bytes in the scanned modules
PY_TAINT_PARAMS = {"data", "body", "raw", "payload"}


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _mentions_len_of(test: ast.AST, buf: str) -> bool:
    """True when ``test`` contains ``len(<buf>)`` (any comparison
    context) or a compare on the buffer itself."""
    for n in ast.walk(test):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and \
                n.func.id == "len" and n.args and \
                _dotted(n.args[0]) == buf:
            return True
    return False


def _mentions_name(test: ast.AST, name: str) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Compare):
            for sub in ast.walk(n):
                if _dotted(sub) == name:
                    return True
    return False


def _is_exit_block(body: List[ast.stmt]) -> bool:
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _struct_consts(trees: Sequence[ast.AST]) -> Set[str]:
    """Module-level ``NAME = struct.Struct(...)`` constants across the
    scanned modules.  ``NAME.unpack_from(buf, off)`` parses wire bytes
    exactly like ``struct.unpack_from`` does (the span-trailer codec's
    ``_SPAN_CTX`` is the canonical case) — union across modules so an
    imported Struct constant still counts at its use site."""
    out: Set[str] = set()
    for tree in trees:
        for n in getattr(tree, "body", []):
            if isinstance(n, ast.Assign) and \
                    isinstance(n.value, ast.Call) and \
                    isinstance(n.value.func, ast.Attribute) and \
                    n.value.func.attr == "Struct" and \
                    _dotted(n.value.func.value) == "struct":
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def rule_s2_py(ctx: SentinelContext) -> List[Finding]:
    f: List[Finding] = []
    structs = _struct_consts([ctx.py[rel] for rel in PY_TAINT_FILES])
    for rel in PY_TAINT_FILES:
        tree = ctx.py[rel]
        for fn in [n for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)]:
            f.extend(_s2_py_function(ctx, rel, fn, structs))
    return f


def _s2_py_function(ctx: SentinelContext, rel: str,
                    fn: ast.FunctionDef,
                    structs: Set[str] = frozenset()) -> List[Finding]:
    out: List[Finding] = []
    # tainted buffers: wire-bytes parameters + any .payload chain
    bufs: Set[str] = {a.arg for a in fn.args.args
                      if a.arg in PY_TAINT_PARAMS}
    # tainted ints: targets of struct.unpack/unpack_from
    ints: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and _has_unpack(n.value, structs):
            for tgt in n.targets:
                for t in ([tgt.elts] if isinstance(
                        tgt, (ast.Tuple, ast.List)) else [[tgt]]):
                    for e in t:
                        d = _dotted(e)
                        if d is not None:
                            ints.add(d)

    def buf_of(expr: ast.AST) -> Optional[str]:
        d = _dotted(expr)
        if d is None:
            return None
        if d in bufs or d.endswith(".payload"):
            return d
        return None

    # guard collection: walk with an explicit guard stack
    def walk(stmts: List[ast.stmt], guards: List[ast.AST]) -> None:
        g = list(guards)
        for st in stmts:
            if isinstance(st, ast.If):
                _check_expr(st.test, g, in_test=True)
                walk(st.body, g + [st.test])
                walk(st.orelse, g)
                if _is_exit_block(st.body):
                    g = g + [st.test]   # early-return guard persists
            elif isinstance(st, (ast.For, ast.While)):
                if isinstance(st, ast.While):
                    _check_expr(st.test, g, in_test=False)
                walk(st.body, g)
                walk(st.orelse, g)
            elif isinstance(st, (ast.With,)):
                walk(st.body, g)
            elif isinstance(st, ast.Try):
                walk(st.body, g)
                for h in st.handlers:
                    walk(h.body, g)
                walk(st.finalbody, g)
            elif isinstance(st, ast.FunctionDef):
                continue
            else:
                for e in ast.iter_child_nodes(st):
                    if isinstance(e, ast.expr):
                        _check_one(e, g)
        return

    checked: Set[int] = set()

    def _check_expr(e: ast.AST, guards: List[ast.AST],
                    in_test: bool) -> None:
        """Check sinks inside an if-test; within a BoolOp, earlier
        values guard later ones (the short-circuit idiom)."""
        if isinstance(e, ast.BoolOp):
            seen: List[ast.AST] = []
            for v in e.values:
                _check_one(v, guards + seen)
                seen.append(v)
        else:
            _check_one(e, guards)

    def _check_one(e: ast.AST, guards: List[ast.AST]) -> None:
        for n in ast.walk(e):
            if id(n) in checked:
                continue
            checked.add(id(n))
            # IfExp: the test guards the body
            if isinstance(n, ast.IfExp):
                _check_one(n.test, guards)
                _check_one(n.body, guards + [n.test])
                _check_one(n.orelse, guards)
                for sub in ast.walk(n):
                    checked.add(id(sub))
                continue
            if isinstance(n, ast.Subscript) and not isinstance(
                    n.slice, ast.Slice):
                b = buf_of(n.value)
                if b is not None and not any(
                        _mentions_len_of(g, b) for g in guards):
                    if not _trusted(ctx, rel, n.lineno):
                        out.append(Finding(
                            "S2", rel, n.lineno,
                            f"wire bytes '{b}' indexed without a "
                            f"dominating len({b}) check in "
                            f"'{fn.name}' — a short frame raises "
                            f"IndexError in the receive path"))
                idx = _dotted(n.slice)
                if idx is not None and idx in ints and not any(
                        _mentions_name(g, idx) for g in guards):
                    if not _trusted(ctx, rel, n.lineno):
                        out.append(Finding(
                            "S2", rel, n.lineno,
                            f"wire-tainted '{idx}' used as a subscript "
                            f"in '{fn.name}' without a dominating "
                            f"bounds check"))
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Name) and \
                    n.func.id == "range":
                for a in n.args:
                    d = _dotted(a)
                    if d is not None and d in ints and not any(
                            _mentions_name(g, d) for g in guards):
                        if not _trusted(ctx, rel, n.lineno):
                            out.append(Finding(
                                "S2", rel, n.lineno,
                                f"wire-tainted '{d}' used as a "
                                f"range() loop bound in '{fn.name}' "
                                f"without a dominating bounds check — "
                                f"a hostile count drives unbounded "
                                f"work in the receive path"))
            if _is_unpack_call(n, structs):
                # module-form struct.unpack(_from) carries the buffer
                # at args[1]; Struct-instance method form at args[0]
                bi = 1 if _dotted(n.func.value) == "struct" else 0
                barg = n.args[bi] if len(n.args) > bi else None
                b = buf_of(barg) if barg is not None else None
                if b is not None and not any(
                        _mentions_len_of(g, b) for g in guards):
                    if not _trusted(ctx, rel, n.lineno):
                        out.append(Finding(
                            "S2", rel, n.lineno,
                            f"struct.unpack of wire bytes '{b}' in "
                            f"'{fn.name}' without a dominating "
                            f"len({b}) check — a truncated frame "
                            f"raises struct.error in the receive "
                            f"path"))

    walk(fn.body, [])
    return out


def _has_unpack(node: ast.AST,
                structs: Set[str] = frozenset()) -> bool:
    return any(_is_unpack_call(n, structs) for n in ast.walk(node))


def _is_unpack_call(n: ast.AST,
                    structs: Set[str] = frozenset()) -> bool:
    if not (isinstance(n, ast.Call) and
            isinstance(n.func, ast.Attribute) and
            n.func.attr in ("unpack", "unpack_from")):
        return False
    base = _dotted(n.func.value)
    return base == "struct" or base in structs


# ---------------------------------------------------------------------------
# S3 — error-path resource leaks (C)
# ---------------------------------------------------------------------------

#: calls that never take ownership of a pointer argument
NO_TRANSFER_FNS = {"memset", "memcpy", "memmove", "sizeof", "printf",
                   "fprintf", "snprintf", "put_le32", "get_le32"}


def _stmt_effect(ctx: SentinelContext, toks: Sequence[csrc.Token],
                 var: str) -> Optional[str]:
    """Effect of one statement on tracked local ``var``:
    'kill' (released / transferred / reassigned / returned), None."""
    n = len(toks)
    ids = [(k, t) for k, t in enumerate(toks) if t[0] == "id"]
    mentions = any(t[1] == var and (k == 0 or toks[k - 1][1] not in
                                    (".", "->")) for k, t in ids)
    if not mentions:
        return None
    # release / anchored transfer calls
    for k, (kind, text, line) in enumerate(toks):
        if kind != "id" or k + 1 >= n or toks[k + 1][1] != "(":
            continue
        try:
            close = csrc.match_paren(toks, k + 1)
        except csrc.CParseError:
            continue
        args = _split_args(toks[k + 2:close])
        if text in RELEASE_FNS:
            if any(_arg_is_var(a, var) for a in args):
                return "kill"
        if text == "realloc" and args and _arg_is_var(args[0], var):
            return "kill"
        tr = ctx.transfers.get(text)
        if tr:
            for i in tr:
                if i < len(args) and _arg_mentions(args[i], var):
                    return "kill"
    # return <expr containing var>
    # (handled by the caller via stmt.kind == 'return')
    # assignment analysis: find the top-level '='
    eq = _top_level_assign(toks)
    if eq is not None:
        lhs, rhs = toks[:eq], toks[eq + 1:]
        lhs_ids = [t[1] for t in lhs if t[0] == "id"]
        rhs_chains = [c for c, _, _ in _chains_in(rhs)]
        # reassignment of the tracked var itself ends this generation
        if lhs_ids and lhs_ids[-1] == var and "[" not in \
                [t[1] for t in lhs] and not any(
                    t[1] in (".", "->") for t in lhs):
            return "kill"
        # store of the var into a structure/alias: `x = var;`,
        # `x->f = var;` — ownership moves to the store target
        if rhs_chains == [var]:
            return "kill"
    return None


def _top_level_assign(toks: Sequence[csrc.Token]) -> Optional[int]:
    depth = 0
    for k, (kind, text, line) in enumerate(toks):
        if text in "([{":
            depth += 1
        elif text in ")]}":
            depth -= 1
        elif text == "=" and depth == 0:
            return k
    return None


def _split_args(toks: Sequence[csrc.Token]) -> List[List[csrc.Token]]:
    args: List[List[csrc.Token]] = [[]]
    depth = 0
    for t in toks:
        if t[1] in "([{":
            depth += 1
        elif t[1] in ")]}":
            depth -= 1
        if t[1] == "," and depth == 0:
            args.append([])
        else:
            args[-1].append(t)
    return [a for a in args if a]


def _arg_is_var(arg: Sequence[csrc.Token], var: str) -> bool:
    ids = [t for t in arg if t[0] == "id"]
    return len(ids) == 1 and ids[0][1] == var and not any(
        t[1] in (".", "->") for t in arg)


def _arg_mentions(arg: Sequence[csrc.Token], var: str) -> bool:
    return any(c == var for c, _, _ in _chains_in(arg))


def _acquisitions(ctx: SentinelContext,
                  fn: csrc.CFunc) -> List[Tuple[int, str, int, str]]:
    """(node_idx, var, line, alloc_fn) for every tracked acquisition."""
    allocs = ALLOC_FNS | ctx.owns
    out = []
    for nd in fn.cfg.nodes:
        toks = nd.stmt.toks
        eq = _top_level_assign(toks)
        if eq is None:
            continue
        lhs = toks[:eq]
        lhs_ids = [t[1] for t in lhs if t[0] == "id"]
        if not lhs_ids or any(t[1] in (".", "->", "[") for t in lhs):
            continue
        var = lhs_ids[-1]
        rhs = toks[eq + 1:]
        for k, (kind, text, line) in enumerate(rhs):
            if kind == "id" and text in allocs and k + 1 < len(rhs) \
                    and rhs[k + 1][1] == "(":
                if text == "realloc":
                    continue  # grow-in-place idiom, handled as kill
                out.append((nd.idx, var, nd.stmt.line, text))
                break
    return out


def _null_on_true(cond: Sequence[csrc.Token], var: str) -> bool:
    """Condition proves ``var`` is NULL on the True branch: `!var`
    or `var == 0` (possibly inside `||` — any disjunct mentioning the
    var this way taints the whole True branch conservatively)."""
    for k, (kind, text, line) in enumerate(cond):
        if kind == "id" and text == var:
            prev = cond[k - 1][1] if k else ""
            nxt = cond[k + 1][1] if k + 1 < len(cond) else ""
            nxt2 = cond[k + 2][1] if k + 2 < len(cond) else ""
            if prev == "!":
                return True
            if nxt == "==" and nxt2 == "0":
                return True
    return False


def rule_s3(ctx: SentinelContext) -> List[Finding]:
    f: List[Finding] = []
    for fname in sorted(ctx.model.funcs):
        fn = ctx.model.funcs[fname]
        acqs = _acquisitions(ctx, fn)
        if not acqs:
            continue
        for acq_node, var, acq_line, alloc_fn in acqs:
            f.extend(_leak_paths(ctx, fn, acq_node, var, acq_line,
                                 alloc_fn))
    return f


def _leak_paths(ctx: SentinelContext, fn: csrc.CFunc, acq: int,
                var: str, acq_line: int, alloc_fn: str) -> List[Finding]:
    """Forward propagation from the acquisition: reach any return/exit
    while the var is live and untransferred -> finding."""
    nodes = fn.cfg.nodes
    leaks: Dict[int, int] = {}  # return node idx -> line
    # guards the acquisition sat under (then-branches only): a later
    # if with the SAME condition correlates — its else side implies
    # the acquisition never ran (the `if (out) h = alloc` ...
    # `if (out) *out = h` idiom)
    acq_conds = {tuple(t[1] for t in cond)
                 for cond, taken in nodes[acq].guards if taken}
    # visited with liveness; a node can be reached live at most once
    seen: Set[int] = set()
    work = [acq]
    first = True
    while work:
        i = work.pop()
        if i in seen:
            continue
        seen.add(i)
        nd = nodes[i]
        if not first:
            eff = _stmt_effect(ctx, nd.stmt.toks, var)
            if eff == "kill":
                continue
            if nd.stmt.kind == "return" and any(
                    c == var or c.startswith(var + "->") or
                    c.startswith(var + ".")
                    for c, _, _ in _chains_in(nd.stmt.toks)):
                continue  # returned to the caller: ownership moves
            if nd.stmt.kind == "return":
                leaks[i] = nd.stmt.line
                continue
            if nd.stmt.kind == "exit":
                # fell off the end of a void function while live
                leaks[i] = nodes[acq].stmt.line
                continue
        first = False
        for s in nd.succ:
            if nd.stmt.kind == "if":
                cond_key = tuple(t[1] for t in nd.stmt.toks)
                # branch-sensitive null check: the True branch of
                # `if (!var)` means the alloc failed — nothing leaks
                if _null_on_true(nd.stmt.toks, var) and \
                        s == nd.then_first and len(nd.succ) > 1:
                    continue
                # acquisition-guard correlation: on the else side of
                # the acquisition's own guard the object was never
                # allocated — only the then-edge carries liveness
                if cond_key in acq_conds and nd.then_first is not None \
                        and s != nd.then_first:
                    continue
            work.append(s)
    out = []
    for i, line in sorted(leaks.items()):
        if _trusted(ctx, fn.path, line):
            continue
        out.append(Finding(
            "S3", fn.path, line,
            f"'{var}' acquired from {alloc_fn}() at line {acq_line} in "
            f"'{fn.name}' leaks on the path returning here — no "
            f"free/ownership-transfer occurs (declare callee facts "
            f"with 'rlo-sentinel: transfers(param)' if this call "
            f"hands the object off; docs/DESIGN.md §15)"))
    return out


# ---------------------------------------------------------------------------
# S4 — state-machine absorption
# ---------------------------------------------------------------------------

@dataclass
class Transition:
    frm: Optional[str]   # None = unguarded (source unknown)
    to: str
    file: str
    line: int


def _c_transitions(ctx: SentinelContext) -> List[Transition]:
    out: List[Transition] = []
    fn_name = "rlo_tpu_torch/native/rlo_engine.c"
    states = set(ctx.header.enums.get("rlo_state", {}))
    for fn in ctx.model.funcs.values():
        if fn.path != fn_name:
            continue
        for nd in fn.cfg.nodes:
            toks = nd.stmt.toks
            for k, (kind, text, line) in enumerate(toks):
                if text != "state" or k == 0 or \
                        toks[k - 1][1] not in (".", "->"):
                    continue
                if k + 1 >= len(toks) or toks[k + 1][1] != "=":
                    continue
                rhs = toks[k + 2:]
                tos = [t[1] for t in rhs if t[0] == "id" and
                       t[1] in states]
                if not tos:
                    continue  # opaque RHS (snapshot restore) — caveat
                frm = None
                for cond, taken in reversed(nd.guards):
                    if not taken:
                        continue
                    g = _guard_state_c(cond, states)
                    if g is not None:
                        frm = g
                        break
                for to in tos:
                    out.append(Transition(
                        frm=_strip_rlo(frm) if frm else None,
                        to=_strip_rlo(to), file=fn.path, line=line))
    return out


def _guard_state_c(cond: Sequence[csrc.Token],
                   states: Set[str]) -> Optional[str]:
    for k, (kind, text, line) in enumerate(cond):
        if text == "state" and k + 1 < len(cond) and \
                cond[k + 1][1] == "==" and k + 2 < len(cond) and \
                cond[k + 2][1] in states:
            return cond[k + 2][1]
    return None


def _strip_rlo(name: Optional[str]) -> Optional[str]:
    return name[4:] if name and name.startswith("RLO_") else name


#: Python lvalues belonging to the proposal machine: the attribute
#: chain ends in one of these.  ``msg.state`` is the Python-only op
#: machine (bcast handles) — rlo-lint R4 already polices its legality;
#: the C engine has no twin for it, so it is out of S4's cross-engine
#: scope (docs/DESIGN.md §15).
_PY_PROPOSAL_BASES = ("p", "ps", "prop_state", "my_own_proposal", "own")


def _py_transitions(ctx: SentinelContext) -> List[Transition]:
    out: List[Transition] = []
    tree = ctx.py[ENGINE_PY]
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._sentinel_parent = node  # type: ignore[attr-defined]
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
            continue
        tgt = n.targets[0]
        if not (isinstance(tgt, ast.Attribute) and tgt.attr == "state"):
            continue
        base = _dotted(tgt.value)
        if base is None or base.split(".")[-1] not in \
                _PY_PROPOSAL_BASES:
            continue
        val = n.value
        if not (isinstance(val, ast.Attribute) and
                isinstance(val.value, ast.Name) and
                val.value.id == "ReqState"):
            continue
        out.append(Transition(frm=_py_guard_state(n), to=val.attr,
                              file=ENGINE_PY, line=n.lineno))
    # the dataclass default is the machine's initial state — the twin
    # of the C engine's `e->own.state = RLO_INVALID` at construction
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and \
                node.name == "ProposalState":
            for st in node.body:
                if isinstance(st, ast.AnnAssign) and \
                        isinstance(st.target, ast.Name) and \
                        st.target.id == "state" and \
                        st.value is not None:
                    v = st.value
                    if isinstance(v, ast.Attribute):
                        out.append(Transition(
                            frm=None, to=v.attr, file=ENGINE_PY,
                            line=st.lineno))
    return out


def _py_guard_state(node: ast.AST) -> Optional[str]:
    """Innermost enclosing `if <...>.state == ReqState.X` whose THEN
    branch contains ``node`` (mirror of rlo-lint's _guarding_state)."""
    child = node
    parent = getattr(node, "_sentinel_parent", None)
    while parent is not None:
        if isinstance(parent, ast.If) and any(
                stmt is child or any(x is child for x in ast.walk(stmt))
                for stmt in parent.body):
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
        parent = getattr(parent, "_sentinel_parent", None)
    return None


def rule_s4(ctx: SentinelContext) -> List[Finding]:
    f: List[Finding] = []
    c_tr = _c_transitions(ctx)
    py_tr = _py_transitions(ctx)
    for eng, trs, path in (("c", c_tr, "rlo_tpu_torch/native/rlo_engine.c"),
                           ("py", py_tr, ENGINE_PY)):
        if not trs:
            f.append(Finding("S4", path, 1,
                             f"no ReqState transitions extracted from "
                             f"the {eng} engine — the extractor lost "
                             f"the state machine"))
            continue
        # (a) absorption: a GUARDED edge out of a settled state may
        # only be the submit re-arm (-> IN_PROGRESS); anything else —
        # DONE->IDLE resets, verdict flips — breaks the settled
        # contract readers rely on
        for t in trs:
            if t.frm in S4_SETTLED and t.to != "IN_PROGRESS":
                key = (eng, t.frm, t.to)
                if key in ctx.sanctioned_edges:
                    apath, aline = ctx.sanctioned_edges[key]
                    ctx.registry.consume(apath, aline)
                    continue
                f.append(Finding(
                    "S4", t.file, t.line,
                    f"guarded transition {t.frm} -> {t.to} escapes a "
                    f"settled state: COMPLETED/FAILED are absorbing "
                    f"modulo the submit re-arm (-> IN_PROGRESS); a "
                    f"settled verdict must never flip or reset "
                    f"in-round (docs/DESIGN.md §15)"))
        # (b) reachability: every state reaches a terminal in the
        # closure (unguarded edges may start anywhere)
        edges: Set[Tuple[str, str]] = set()
        for t in trs:
            for frm in ([t.frm] if t.frm else S4_STATES):
                edges.add((frm, t.to))
        for s in S4_STATES:
            reach = _closure(edges, s)
            if not (reach & set(S4_TERMINAL)) and s not in S4_TERMINAL:
                f.append(Finding(
                    "S4", path, 1,
                    f"state {s} reaches no terminal state in the {eng} "
                    f"engine's transition closure — a round entering "
                    f"it wedges forever"))
    # (c) cross-engine equality of the induced relation
    c_guarded = {(t.frm, t.to) for t in c_tr if t.frm}
    py_guarded = {(t.frm, t.to) for t in py_tr if t.frm}
    if c_guarded != py_guarded:
        f.append(Finding(
            "S4", ENGINE_PY, 1,
            f"guarded proposal-state transitions diverge: python "
            f"{sorted(py_guarded)} vs C {sorted(c_guarded)} — the two "
            f"engines no longer implement the same machine"))
    c_unguarded = {t.to for t in c_tr if t.frm is None}
    py_unguarded = {t.to for t in py_tr if t.frm is None}
    if c_unguarded != py_unguarded:
        f.append(Finding(
            "S4", ENGINE_PY, 1,
            f"unguarded proposal-state assignment targets diverge: "
            f"python {sorted(py_unguarded)} vs C "
            f"{sorted(c_unguarded)} — one engine can settle/arm a "
            f"round the other cannot"))
    return f


def _closure(edges: Set[Tuple[str, str]], start: str) -> Set[str]:
    seen: Set[str] = set()
    work = [start]
    while work:
        s = work.pop()
        for a, b in edges:
            if a == s and b not in seen:
                seen.add(b)
                work.append(b)
    return seen


# ---------------------------------------------------------------------------
# S0 — stale-anchor audit (shared pass; consumes both tools' registries)
# ---------------------------------------------------------------------------

def rule_s0(ctx: SentinelContext) -> List[Finding]:
    from rlo_tpu_torch.tools import rlo_lint, rlo_prover
    # run every lint + prover rule purely for the anchor-consumption
    # footprint (the shared grammar in runner.ANCHOR_PREFIXES spans
    # all three analyzers' namespaces)
    try:
        rlo_lint.run_lint(ctx.root, registry=ctx.registry)
    except rlo_lint.LintError as e:
        raise ToolError(f"stale-anchor audit needs a lintable tree: {e}")
    try:
        # only the anchor-consuming families — the P1/P2 schedule
        # sweep and P3 interpretation record nothing in the registry
        # and check.sh already runs the full prover as its own step
        rlo_prover.run_prover(ctx.root, rules=rlo_prover.ANCHOR_RULES,
                              registry=ctx.registry)
    except rlo_prover.ProverError as e:
        raise ToolError(f"stale-anchor audit needs a provable tree: "
                        f"{e}")
    files: Dict[str, Sequence[str]] = {}
    for path, lines in ctx.model.raw_lines.items():
        files[path] = lines
    for rel, lines in ctx.py_lines.items():
        files[rel] = lines
    hdr_raw = ctx.header.raw.splitlines()
    files[CORE_H] = hdr_raw
    for rel in (rlo_lint.audit_files(ctx.root)
                + rlo_prover.audit_files(ctx.root)):
        if rel not in files:
            try:
                files[rel] = (ctx.root / rel).read_text().splitlines()
            except OSError:
                continue
    return [fnd for fnd in audit_stale_anchors(
        "S0", {p: ls for p, ls in files.items()}, ctx.registry)
        if _is_real_anchor(files[fnd.file][fnd.line - 1], fnd.file)]


def _is_real_anchor(line_text: str, path: str) -> bool:
    """Filter prose MENTIONS of anchors from real anchor comments:
    backtick-quoted spellings are documentation, Python anchors must
    sit in a '#' comment, and the analyzers' own sources (which quote
    anchor spellings as string literals) are out of audit scope."""
    from rlo_tpu_torch.tools.runner import ANCHOR_PREFIXES
    if path.startswith("rlo_tpu_torch/tools/"):
        return False
    for prefix in ANCHOR_PREFIXES:
        at = line_text.find(prefix)
        if at < 0:
            continue
        if at > 0 and line_text[at - 1] in "`'\"":
            return False  # quoted mention, not an anchor
        if path.endswith(".py") and "#" not in line_text[:at]:
            return False  # docstring prose, not a comment anchor
        return True
    return False


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_sentinel(root: Path, rules: Optional[Sequence[str]] = None
                 ) -> List[Finding]:
    """Run the selected rule families (default: all) against the tree
    at ``root``; returns findings sorted by file/line.  S0 (the stale-
    anchor audit) must run AFTER the others — it audits what they
    consumed — so it is always ordered last."""
    ctx = build_context(Path(root))
    selected = list(rules or RULE_IDS)
    for rid in selected:
        if rid not in RULE_IDS:
            raise ToolError(f"unknown rule {rid!r} (have "
                            f"{', '.join(RULE_IDS)})")
    out: List[Finding] = []
    for rid in [r for r in RULE_IDS if r != "S0"]:
        # with S0 selected, UNSELECTED rules still run for their
        # anchor-consumption footprint (a guarded-by/trusted anchor is
        # consumed by S1–S3, not by the audit itself) — their findings
        # are just not reported
        if rid not in selected and "S0" not in selected:
            continue
        findings = _RULES[rid](ctx)
        if rid in selected:
            out.extend(findings)
    if "S0" in selected:
        out.extend(rule_s0(ctx))
    out.sort(key=lambda x: (x.file, x.line, x.rule))
    return out


def _rule_s2(ctx: SentinelContext) -> List[Finding]:
    return rule_s2_c(ctx) + rule_s2_py(ctx)


_RULES = {"S1": rule_s1, "S2": _rule_s2, "S3": rule_s3, "S4": rule_s4}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rlo_tpu_torch.tools.rlo_sentinel",
        description="CFG/dataflow analyzer for the dual engines "
                    "(rule catalogue: docs/DESIGN.md §15).")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule families (default: all), "
                         "e.g. --rules S1,S3")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)
    rules = ([r.strip().upper() for r in args.rules.split(",") if
              r.strip()] if args.rules else None)
    try:
        findings = run_sentinel(args.root, rules)
    except ToolError as e:
        print(f"rlo-sentinel: error: {e}", file=sys.stderr)
        return 2
    return emit(findings, prog="rlo-sentinel",
                ran=",".join(rules or RULE_IDS), root=args.root,
                as_json=args.json, quiet=args.quiet)


if __name__ == "__main__":
    sys.exit(main())
