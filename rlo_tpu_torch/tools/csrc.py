"""csrc — the shared mini-C front end of the static analyzers.

rlo-lint (docs/DESIGN.md §9) started with a regex-over-stripped-text C
parser good enough for headers: macros, enums, struct layouts,
prototypes, function-pointer typedefs.  rlo-sentinel (docs/DESIGN.md
§15) needs strictly more — a line-accurate token stream, every function
*body*, per-function control-flow graphs, and a whole-library call
graph (including calls through the transport vtable).  This module is
the lift-out both tools share: the header-level model is the same code
rlo-lint has always run, the statement/CFG layer is new.

Nothing here imports or compiles anything; the input is C source text.
The subset parsed is the subset this repo's C core uses (C11, no
nested functions, no computed goto, one statement grammar of
if/else/while/do/for/switch/case/goto/label/break/continue/return).
Soundness caveats live in docs/DESIGN.md §15.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from rlo_tpu_torch.tools.runner import ToolError


class CParseError(ToolError):
    """Unrecoverable parse failure (missing input, unmatchable braces)."""


# ---------------------------------------------------------------------------
# comment stripping + line accounting (shared with rlo-lint since PR 4)
# ---------------------------------------------------------------------------

def strip_comments(text: str) -> str:
    """Replace comments with spaces, preserving every newline so byte
    offsets keep mapping to the original line numbers."""
    out = []
    i, n = 0, len(text)
    while i < n:
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("".join(c if c == "\n" else " " for c in text[i:j]))
            i = j
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def line_of(text: str, idx: int) -> int:
    return text.count("\n", 0, idx) + 1


# ---------------------------------------------------------------------------
# header-level model (lifted verbatim from rlo_lint PR 4)
# ---------------------------------------------------------------------------

@dataclass
class CProto:
    name: str
    ret: str                       # canonical C type, e.g. "int64_t"
    params: List[str]              # canonical C types
    line: int


@dataclass
class CHeader:
    path: str
    raw: str
    stripped: str
    macros: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    enums: Dict[str, Dict[str, Tuple[int, int]]] = field(
        default_factory=dict)
    structs: Dict[str, List[Tuple[str, str, Optional[int], int]]] = field(
        default_factory=dict)
    protos: Dict[str, CProto] = field(default_factory=dict)
    fn_typedefs: Dict[str, Tuple[str, List[str], int]] = field(
        default_factory=dict)

    def macro(self, name: str) -> int:
        if name not in self.macros:
            raise CParseError(f"{self.path}: macro {name} not found")
        return self.macros[name][0]

    def resolve(self, token: str) -> int:
        """An integer literal or a macro name -> its value."""
        token = token.strip()
        if re.fullmatch(r"-?\d+", token):
            return int(token)
        return self.macro(token)


_CANON_SPACE = re.compile(r"\s+")


def canon_ctype(decl: str) -> str:
    """'const uint8_t  *payload' -> 'uint8_t*' (drop qualifiers and the
    parameter name, normalize pointer spacing)."""
    decl = decl.strip()
    decl = re.sub(r"\bconst\b|\bvolatile\b|\bstruct\b|\benum\b", " ", decl)
    stars = decl.count("*")
    decl = decl.replace("*", " ")
    toks = _CANON_SPACE.sub(" ", decl).strip().split(" ")
    # 'unsigned long long x' style does not occur in this header; the
    # base type is one token, an optional second token is the name
    if len(toks) > 1:
        toks = toks[:-1]  # drop the parameter name
    return "".join(toks) + "*" * stars


def split_params(params: str) -> List[str]:
    params = params.strip()
    if params in ("", "void"):
        return []
    return [canon_ctype(p) for p in params.split(",")]


def parse_c_header(path: Path, relpath: str) -> CHeader:
    try:
        raw = path.read_text()
    except OSError as e:
        raise CParseError(f"cannot read {relpath}: {e}")
    stripped = strip_comments(raw)
    hdr = CHeader(path=relpath, raw=raw, stripped=stripped)

    for m in re.finditer(r"^[ \t]*#[ \t]*define[ \t]+(\w+)[ \t]+(-?\d+)",
                         stripped, re.M):
        hdr.macros[m.group(1)] = (int(m.group(2)), line_of(stripped,
                                                           m.start()))

    for m in re.finditer(r"\benum\s+(\w+)\s*\{(.*?)\}", stripped, re.S):
        members: Dict[str, Tuple[int, int]] = {}
        nextval = 0
        body_off = m.start(2)
        for piece in m.group(2).split(","):
            name_m = re.search(r"(\w+)\s*(?:=\s*(-?\w+))?", piece)
            if not name_m or not re.match(r"[A-Za-z_]", name_m.group(1)):
                continue
            val = (hdr.resolve(name_m.group(2))
                   if name_m.group(2) is not None else nextval)
            nextval = val + 1
            members[name_m.group(1)] = (
                val, line_of(stripped, body_off + piece.index(
                    name_m.group(1))))
            body_off += len(piece) + 1
        hdr.enums[m.group(1)] = members

    for m in re.finditer(
            r"typedef\s+struct\s+(\w+)\s*\{(.*?)\}\s*\w+\s*;",
            stripped, re.S):
        fields: List[Tuple[str, str, Optional[int], int]] = []
        body_off = m.start(2)
        for stmt in m.group(2).split(";"):
            stmt_line = line_of(stripped, body_off)
            body_off += len(stmt) + 1
            s = _CANON_SPACE.sub(" ", stmt).strip()
            if not s:
                continue
            decl_m = re.match(r"([\w ]+?)\s+([\w\[\], *]+)$", s)
            if not decl_m:
                continue
            base = canon_ctype(decl_m.group(1) + " x")
            for one in decl_m.group(2).split(","):
                one = one.strip()
                arr = re.match(r"(\w+)\s*\[\s*(\w+)\s*\]", one)
                if arr:
                    fields.append((arr.group(1), base,
                                   hdr.resolve(arr.group(2)), stmt_line))
                else:
                    stars = one.count("*")
                    fields.append((one.replace("*", "").strip(),
                                   base + "*" * stars, None, stmt_line))
        hdr.structs[m.group(1)] = fields

    # function-pointer typedefs: typedef RET (*name)(PARAMS);
    for m in re.finditer(
            r"typedef\s+([\w \*]+?)\s*\(\s*\*\s*(\w+)\s*\)\s*\(([^)]*)\)",
            stripped, re.S):
        hdr.fn_typedefs[m.group(2)] = (
            canon_ctype(m.group(1) + " x"), split_params(m.group(3)),
            line_of(stripped, m.start()))

    # prototypes: top-level after removing braces bodies / # lines
    flat = re.sub(r"^[ \t]*#.*$", "", stripped, flags=re.M)
    flat = re.sub(r"\{[^{}]*\}", lambda mm: "\n" * mm.group(0).count("\n"),
                  flat)  # enum/struct bodies (no nesting in this header)
    flat = re.sub(r'extern\s+"C"\s*\{', "", flat).replace("{", " ").replace(
        "}", " ")
    for m in re.finditer(
            r"([\w \*\n]+?)\b(rlo_\w+)\s*\(([^()]*)\)\s*;", flat):
        ret_txt = m.group(1).strip()
        if not ret_txt or "typedef" in ret_txt:
            continue
        # keep only the tail type tokens of the return text (the regex
        # may swallow the end of a previous statement)
        ret_tail = re.search(
            r"((?:\w+[ \n]+)*\w+[ \n\*]*)$", ret_txt)
        ret = canon_ctype((ret_tail.group(1) if ret_tail else ret_txt)
                          + " x")
        hdr.protos[m.group(2)] = CProto(
            name=m.group(2), ret=ret, params=split_params(m.group(3)),
            line=line_of(flat, m.start(2)))
    return hdr


def extract_function(stripped: str, name: str) -> Optional[Tuple[str, int]]:
    """Body text (brace-matched, including the braces) + start line of
    function ``name``."""
    m = re.search(rf"\b{name}\s*\([^)]*\)\s*\{{", stripped)
    if not m:
        return None
    depth = 0
    start = stripped.index("{", m.start())
    for i in range(start, len(stripped)):
        if stripped[i] == "{":
            depth += 1
        elif stripped[i] == "}":
            depth -= 1
            if depth == 0:
                return stripped[start:i + 1], line_of(stripped, m.start())
    return None


# ---------------------------------------------------------------------------
# token stream (line-accurate)
# ---------------------------------------------------------------------------

#: token kinds: 'id', 'num', 'str', 'chr', 'punct'
Token = Tuple[str, str, int]

_TOKEN_RE = re.compile(
    r"""(?P<id>[A-Za-z_]\w*)
      | (?P<num>0[xX][0-9a-fA-F]+|\d+\.\d+[fF]?|\.\d+[fF]?|\d+[uUlL]*[fF]?)
      | (?P<str>"(?:[^"\\]|\\.)*")
      | (?P<chr>'(?:[^'\\]|\\.)*')
      | (?P<punct><<=|>>=|\.\.\.|->|\+\+|--|<<|>>|<=|>=|==|!=|&&|\|\|
                  |[-+*/%&|^!~<>=?:;,.(){}\[\]])
    """, re.X)


def tokenize(stripped: str, base_line: int = 1) -> List[Token]:
    """Tokenize comment-stripped C text; each token carries the
    1-indexed line it starts on (offset by ``base_line - 1``)."""
    toks: List[Token] = []
    line = base_line
    pos = 0
    for m in _TOKEN_RE.finditer(stripped):
        line += stripped.count("\n", pos, m.start())
        pos = m.start()
        kind = m.lastgroup or "punct"
        toks.append((kind, m.group(0), line))
    return toks


def match_paren(toks: Sequence[Token], i: int) -> int:
    """``toks[i]`` is an opener; returns the index of its matching
    closer.  Openers/closers: () {} []."""
    pairs = {"(": ")", "{": "}", "[": "]"}
    op = toks[i][1]
    cl = pairs[op]
    depth = 0
    for j in range(i, len(toks)):
        t = toks[j][1]
        if t == op:
            depth += 1
        elif t == cl:
            depth -= 1
            if depth == 0:
                return j
    raise CParseError(f"unbalanced {op!r} at line {toks[i][2]}")


# ---------------------------------------------------------------------------
# statement tree (AST-lite over the token stream)
# ---------------------------------------------------------------------------

@dataclass
class Stmt:
    """One statement.  ``kind`` in {'simple', 'if', 'while', 'do',
    'for', 'switch', 'return', 'break', 'continue', 'goto', 'label',
    'case'}.  ``toks`` is the controlling expression ('if'/'while'/
    'for'/'switch' condition, 'return' value, 'simple' body); nested
    statements live in ``body`` / ``orelse``."""
    kind: str
    toks: List[Token] = field(default_factory=list)
    body: List["Stmt"] = field(default_factory=list)
    orelse: List["Stmt"] = field(default_factory=list)
    line: int = 0
    label: str = ""   # goto target / label name


_KEYWORDS = {
    "if", "else", "while", "do", "for", "switch", "case", "default",
    "goto", "break", "continue", "return", "sizeof", "struct", "enum",
    "union", "static", "const", "volatile", "typedef", "extern",
    "inline", "register", "unsigned", "signed", "void",
}


def parse_statements(toks: List[Token]) -> List[Stmt]:
    """Parse a brace-stripped statement sequence into a Stmt tree."""
    out: List[Stmt] = []
    i = 0
    n = len(toks)

    def one(i: int) -> Tuple[Optional[Stmt], int]:
        if i >= n:
            return None, i
        kind, text, line = toks[i]
        if text == ";":
            return Stmt("simple", [], line=line), i + 1
        if text == "{":
            j = match_paren(toks, i)
            blk = Stmt("simple", [], line=line)
            blk.kind = "block"
            blk.body = parse_statements(toks[i + 1:j])
            return blk, j + 1
        if text == "if":
            j = match_paren(toks, i + 1)
            st = Stmt("if", toks[i + 2:j], line=line)
            then, i2 = one(j + 1)
            st.body = [then] if then else []
            if i2 < n and toks[i2][1] == "else":
                els, i2 = one(i2 + 1)
                st.orelse = [els] if els else []
            return st, i2
        if text in ("while",):
            j = match_paren(toks, i + 1)
            st = Stmt("while", toks[i + 2:j], line=line)
            body, i2 = one(j + 1)
            st.body = [body] if body else []
            return st, i2
        if text == "do":
            st = Stmt("do", [], line=line)
            body, i2 = one(i + 1)
            st.body = [body] if body else []
            # 'while' '(' cond ')' ';'
            if i2 < n and toks[i2][1] == "while":
                j = match_paren(toks, i2 + 1)
                st.toks = toks[i2 + 2:j]
                i2 = j + 1
                if i2 < n and toks[i2][1] == ";":
                    i2 += 1
            return st, i2
        if text == "for":
            j = match_paren(toks, i + 1)
            st = Stmt("for", toks[i + 2:j], line=line)
            body, i2 = one(j + 1)
            st.body = [body] if body else []
            return st, i2
        if text == "switch":
            j = match_paren(toks, i + 1)
            st = Stmt("switch", toks[i + 2:j], line=line)
            body, i2 = one(j + 1)
            st.body = [body] if body else []
            return st, i2
        if text in ("break", "continue"):
            st = Stmt(text, [], line=line)
            i2 = i + 1
            if i2 < n and toks[i2][1] == ";":
                i2 += 1
            return st, i2
        if text == "goto":
            st = Stmt("goto", [], line=line,
                      label=toks[i + 1][1] if i + 1 < n else "")
            i2 = i + 2
            if i2 < n and toks[i2][1] == ";":
                i2 += 1
            return st, i2
        if text == "return":
            j = i + 1
            depth = 0
            while j < n:
                t = toks[j][1]
                if t in "([{":
                    depth += 1
                elif t in ")]}":
                    depth -= 1
                elif t == ";" and depth == 0:
                    break
                j += 1
            return Stmt("return", toks[i + 1:j], line=line), j + 1
        if text == "case":
            j = i + 1
            while j < n and toks[j][1] != ":":
                j += 1
            return Stmt("case", toks[i + 1:j], line=line), j + 1
        if text == "default" and i + 1 < n and toks[i + 1][1] == ":":
            return Stmt("case", [], line=line), i + 2
        if kind == "id" and text not in _KEYWORDS and i + 1 < n and \
                toks[i + 1][1] == ":":
            return Stmt("label", [], line=line, label=text), i + 2
        # plain statement/declaration up to the top-level ';'
        j = i
        depth = 0
        while j < n:
            t = toks[j][1]
            if t in "([{":
                depth += 1
            elif t in ")]}":
                depth -= 1
            elif t == ";" and depth == 0:
                break
            j += 1
        return Stmt("simple", toks[i:j], line=line), j + 1

    while i < n:
        st, i2 = one(i)
        if i2 <= i:   # safety: never loop forever on malformed input
            i2 = i + 1
        if st is not None:
            out.append(st)
        i = i2
    return out


# ---------------------------------------------------------------------------
# CFG
# ---------------------------------------------------------------------------

@dataclass
class Node:
    """One CFG node = one statement occurrence."""
    idx: int
    stmt: Stmt
    succ: List[int] = field(default_factory=list)
    #: guard context: list of (cond_tokens, branch_taken) for every
    #: enclosing if/while/for condition on the structured path to this
    #: node — branch_taken is True for the then/body side, False for
    #: the else side.  Used by taint sanitization and the S4 guard
    #: extraction.
    guards: List[Tuple[List[Token], bool]] = field(default_factory=list)
    #: for 'if' nodes: the first node of the then-branch (None when the
    #: then-body is empty) — lets branch-sensitive analyses tell the
    #: then-edge from the else/fall-through edges
    then_first: Optional[int] = None


@dataclass
class CFG:
    nodes: List[Node]
    entry: int
    exit: int

    def preds(self) -> List[List[int]]:
        p: List[List[int]] = [[] for _ in self.nodes]
        for nd in self.nodes:
            for s in nd.succ:
                p[s].append(nd.idx)
        return p

    def dominators(self) -> List[Set[int]]:
        """dom[i] = set of node indices dominating node i (classic
        iterative dataflow; CFGs here are tiny)."""
        n = len(self.nodes)
        preds = self.preds()
        dom: List[Set[int]] = [set(range(n)) for _ in range(n)]
        dom[self.entry] = {self.entry}
        changed = True
        order = list(range(n))
        while changed:
            changed = False
            for i in order:
                if i == self.entry:
                    continue
                ps = [dom[p] for p in preds[i]]
                new = set.intersection(*ps) if ps else set()
                new = new | {i}
                if new != dom[i]:
                    dom[i] = new
                    changed = True
        return dom


def build_cfg(stmts: List[Stmt]) -> CFG:
    """Lower a Stmt tree to a CFG.  Every statement (including the
    structured heads) becomes a node; ``exit`` is a synthetic node all
    returns and the final fall-through feed."""
    nodes: List[Node] = []

    def add(stmt: Stmt, guards: List[Tuple[List[Token], bool]]) -> int:
        nd = Node(idx=len(nodes), stmt=stmt, guards=list(guards))
        nodes.append(nd)
        return nd.idx

    exit_stmt = Stmt("exit", [], line=0)
    labels: Dict[str, int] = {}
    gotos: List[Tuple[int, str]] = []
    returns: List[int] = []

    def lower(stmts: List[Stmt], guards: List[Tuple[List[Token], bool]],
              brks: Optional[List[int]], cont: Optional[int]) -> Tuple[
                  Optional[int], List[int]]:
        """Returns (first_node, open_ends) — open_ends are node indices
        whose fall-through successor is the next statement.  ``brks``
        collects break nodes for the innermost loop/switch (they become
        open ends of that construct); ``cont`` is the innermost loop
        head."""
        first: Optional[int] = None
        open_ends: List[int] = []
        for st in stmts:
            if st.kind == "block":
                f, ends = lower(st.body, guards, brks, cont)
                if f is None:
                    continue
            elif st.kind == "if":
                head = add(st, guards)
                g_then = guards + [(st.toks, True)]
                g_else = guards + [(st.toks, False)]
                tf, tends = lower(st.body, g_then, brks, cont)
                ef, eends = lower(st.orelse, g_else, brks, cont)
                nodes[head].then_first = tf
                if tf is not None:
                    nodes[head].succ.append(tf)
                    ends = list(tends)
                else:
                    ends = [head]
                if st.orelse:
                    if ef is not None:
                        nodes[head].succ.append(ef)
                        ends += eends
                    else:
                        ends.append(head)
                else:
                    ends.append(head)
                f = head
            elif st.kind in ("while", "for", "do"):
                head = add(st, guards)
                my_brks: List[int] = []
                g_body = guards + ([(st.toks, True)] if st.toks else [])
                bf, bends = lower(st.body, g_body, my_brks, head)
                if bf is not None:
                    nodes[head].succ.append(bf)
                    for e in bends:
                        nodes[e].succ.append(head)
                # loop exit = falling out of the head, or any break
                ends = [head] + my_brks
                f = head
            elif st.kind == "switch":
                head = add(st, guards)
                my_brks = []
                before = len(nodes)
                bf, bends = lower(st.body, guards + [(st.toks, True)],
                                  my_brks, cont)
                # every 'case' label is a possible entry from the head
                for nd in nodes[before:]:
                    if nd.stmt.kind == "case" and \
                            nd.idx not in nodes[head].succ:
                        nodes[head].succ.append(nd.idx)
                if bf is not None and bf not in nodes[head].succ:
                    nodes[head].succ.append(bf)
                # switch exit: falling out of the body, any break, or
                # no matching case (head falls through)
                ends = list(bends) + my_brks + [head]
                f = head
            elif st.kind == "return":
                nd = add(st, guards)
                returns.append(nd)
                f, ends = nd, []
            elif st.kind == "break":
                nd = add(st, guards)
                if brks is not None:
                    brks.append(nd)
                    ends = []
                else:
                    ends = [nd]
                f = nd
            elif st.kind == "continue":
                nd = add(st, guards)
                if cont is not None:
                    nodes[nd].succ.append(cont)
                    ends = []
                else:
                    ends = [nd]
                f = nd
            elif st.kind == "goto":
                nd = add(st, guards)
                gotos.append((nd, st.label))
                f, ends = nd, []
            elif st.kind == "label":
                nd = add(st, guards)
                labels[st.label] = nd
                f, ends = nd, [nd]
            else:  # simple / case
                nd = add(st, guards)
                f, ends = nd, [nd]
            if first is None:
                first = f
            for e in open_ends:
                nodes[e].succ.append(f)
            open_ends = ends
        return first, open_ends

    f, ends = lower(stmts, [], None, None)
    exit_idx = add(exit_stmt, [])
    for e in ends:
        nodes[e].succ.append(exit_idx)
    for r in returns:
        nodes[r].succ.append(exit_idx)
    for nd, lbl in gotos:
        nodes[nd].succ.append(labels.get(lbl, exit_idx))
    # any node with no successor (e.g. break with nothing after the
    # loop) falls through to exit
    for nd in nodes:
        if nd.idx != exit_idx and not nd.succ:
            nd.succ.append(exit_idx)
    entry = f if f is not None else exit_idx
    return CFG(nodes=nodes, entry=entry, exit=exit_idx)


# ---------------------------------------------------------------------------
# whole-file model: functions, file-scope variables, call graph
# ---------------------------------------------------------------------------

@dataclass
class CFunc:
    name: str
    path: str
    line: int
    params: List[str]              # parameter NAMES (not types)
    param_types: List[str]         # canonical types, same order
    toks: List[Token]              # body tokens (braces stripped)
    stmts: List[Stmt]
    cfg: CFG
    calls: Set[str] = field(default_factory=set)
    indirect_slots: Set[str] = field(default_factory=set)


@dataclass
class FileVar:
    """A file-scope variable (static or extern-visible)."""
    name: str
    path: str
    line: int
    is_const: bool
    decl: str


@dataclass
class CModel:
    """Parsed model of a set of .c files."""
    funcs: Dict[str, CFunc] = field(default_factory=dict)
    file_vars: Dict[str, FileVar] = field(default_factory=dict)
    #: vtable-ish designated initializers: field name -> function names
    slot_impls: Dict[str, Set[str]] = field(default_factory=dict)
    raw_lines: Dict[str, List[str]] = field(default_factory=dict)


_FUNC_DEF_RE = re.compile(
    r"^(?P<head>[ \t]*(?:[A-Za-z_][\w ]*?[ \t*]+))"
    r"(?P<name>[A-Za-z_]\w*)[ \t]*\((?P<params>[^;{)]*)\)[ \t\n]*\{",
    re.M)

_FILEVAR_RE = re.compile(
    r"^(?P<decl>(?:static[ \t]+)?(?:const[ \t]+)?"
    r"(?:unsigned[ \t]+|signed[ \t]+)?"
    r"[A-Za-z_]\w*(?:[ \t]+[A-Za-z_]\w*)?[ \t*]+)"
    r"(?P<name>[A-Za-z_]\w*)(?P<arr>\[[^\]]*\])?[ \t]*(?:=[^;]*)?;",
    re.M)


def _param_names(params: str) -> Tuple[List[str], List[str]]:
    names: List[str] = []
    types: List[str] = []
    params = params.strip()
    if params in ("", "void"):
        return names, types
    for p in params.split(","):
        p = p.strip()
        if not p:
            continue
        m = re.search(r"([A-Za-z_]\w*)\s*(?:\[[^\]]*\])?$", p)
        names.append(m.group(1) if m else "")
        types.append(canon_ctype(p if m is None else p))
    return names, types


def parse_c_file(path: Path, relpath: str, model: CModel) -> None:
    """Parse one .c file's functions, file-scope variables, and
    designated struct initializers into ``model``."""
    try:
        raw = path.read_text()
    except OSError as e:
        raise CParseError(f"cannot read {relpath}: {e}")
    stripped = strip_comments(raw)
    model.raw_lines[relpath] = raw.splitlines()

    # --- function definitions (top level: brace depth 0) ---
    depth = 0
    i = 0
    n = len(stripped)
    spans: List[Tuple[int, int]] = []  # (start, end) of top-level bodies
    while i < n:
        c = stripped[i]
        if c == "{":
            if depth == 0:
                spans.append((i, -1))
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0 and spans:
                spans[-1] = (spans[-1][0], i)
        i += 1

    for m in _FUNC_DEF_RE.finditer(stripped):
        head = m.group("head").strip()
        if head.endswith(("else", "return", "do")) or \
                re.search(r"\b(if|for|while|switch)\b$", head):
            continue
        name = m.group("name")
        brace = stripped.index("{", m.end() - 1)
        span = next((s for s in spans if s[0] == brace), None)
        if span is None or span[1] < 0:
            continue
        body = stripped[span[0] + 1:span[1]]
        fline = line_of(stripped, m.start("name"))
        toks = tokenize(body, base_line=line_of(stripped, span[0] + 1))
        try:
            stmts = parse_statements(toks)
            cfg = build_cfg(stmts)
        except (CParseError, RecursionError) as e:
            raise CParseError(f"{relpath}:{fline}: cannot parse body of "
                              f"{name}: {e}")
        pnames, ptypes = _param_names(m.group("params"))
        fn = CFunc(name=name, path=relpath, line=fline, params=pnames,
                   param_types=ptypes, toks=toks, stmts=stmts, cfg=cfg)
        # direct calls: identifier followed by '(' that is not a
        # declaration keyword and not preceded by '.', '->' (field
        # calls are indirect)
        for k, t in enumerate(toks):
            if t[0] == "id" and t[1] not in _KEYWORDS and \
                    k + 1 < len(toks) and toks[k + 1][1] == "(":
                prev = toks[k - 1][1] if k else ""
                if prev in (".", "->"):
                    fn.indirect_slots.add(t[1])
                else:
                    fn.calls.add(t[1])
        model.funcs[name] = fn

    # --- file-scope variables (outside every top-level body) ---
    def at_top_level(off: int) -> bool:
        return all(not (s <= off <= e) for s, e in spans if e >= 0)

    for m in _FILEVAR_RE.finditer(stripped):
        if not at_top_level(m.start()):
            continue
        decl = m.group("decl").strip()
        first = decl.split()[0] if decl.split() else ""
        if first in ("typedef", "extern", "return", "goto", "else"):
            continue
        name = m.group("name")
        if name in model.funcs:
            continue
        # skip prototypes that the regex might half-match
        if "(" in m.group(0):
            continue
        model.file_vars[name] = FileVar(
            name=name, path=relpath, line=line_of(stripped, m.start()),
            is_const="const" in decl.split(), decl=decl)

    # --- designated initializers: .slot = func ---
    for m in re.finditer(r"\.\s*(\w+)\s*=\s*([A-Za-z_]\w*)", stripped):
        model.slot_impls.setdefault(m.group(1), set()).add(m.group(2))


def parse_c_files(root: Path, relpaths: Sequence[str]) -> CModel:
    model = CModel()
    for rel in relpaths:
        parse_c_file(root / rel, rel, model)
    # resolve indirect slot calls into the call graph
    for fn in model.funcs.values():
        for slot in fn.indirect_slots:
            for impl in model.slot_impls.get(slot, ()):
                if impl in model.funcs:
                    fn.calls.add(impl)
    return model


def reachable_from(model: CModel, roots: Sequence[str]) -> Set[str]:
    """Transitive closure of the call graph from ``roots``."""
    seen: Set[str] = set()
    work = [r for r in roots if r in model.funcs]
    while work:
        f = work.pop()
        if f in seen:
            continue
        seen.add(f)
        for callee in model.funcs[f].calls:
            if callee in model.funcs and callee not in seen:
                work.append(callee)
    return seen
