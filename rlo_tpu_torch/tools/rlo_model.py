"""rlo-model — exhaustive explicit-state model checker for the
membership / healing / IAR protocol, with cross-engine automaton
extraction (DESIGN.md §20).

The port's copy of ``rlo_tpu/tools/rlo_model.py``, over the port's
``engine.py`` and ``native/rlo_engine.c``.

Two fronts, one tool:

**Front 1 — extraction (rules A1/A2).**  The joiner/member role
automaton is lifted statically from BOTH engines: every call site of
the demote/promote mechanisms (``_become_joiner`` / ``_adopt_view`` in
``engine.py``, ``become_joiner`` / ``adopt_view`` in ``rlo_engine.c``)
is attributed to its enclosing handler, the handler is mapped to a
protocol *trigger* (join / welcome / msync / failure / restart), and
the two engines' edge sets are compared (A1).  Alongside the edges,
three semantic *guard facts* are extracted from each engine — the
stale-MSYNC_RSP guard, the joiner-liveness grace stamp, and the
batched-admission count class — and compared too: the abstract model
below is **parameterized by these facts**, so deleting a guard in the
tree under test changes the model's semantics and the corresponding
invariant (M5 / M4 / A1) fires with a concrete counterexample
schedule.  Each call site carries a read-only ``rlo-model: edge``
anchor comment; rlo-model audits its own anchors (they are *not* in
runner.ANCHOR_PREFIXES, so rlo-sentinel's S0 ignores them).

**Front 2 — exhaustive exploration (rules M1–M5).**  A small abstract
model of the membership protocol (n=3 ranks, bounded fault budgets)
is explored breadth-first over ALL event interleavings — deliver /
drop / duplicate per in-flight message, kill / restart / partition /
heal / suspicion — with canonical-tuple state hashing for dedup and a
schedule-length bound.  Breadth-first order means the first violating
schedule found is minimal.  Invariants:

  M1  epoch monotonicity       — no rank's adopted epoch ever
                                 decreases within one incarnation
                                 (the engines max-merge on adoption;
                                 the m1 knob models replacing the max
                                 with a bare assignment)
  M2  admission agreement      — no two co-viewed members hold
                                 conflicting admission certificates
                                 (same admitted member + admission
                                 epoch, different incarnation); epoch
                                 numbers may collide across a healed
                                 split-brain, which wholesale MSYNC
                                 adoption reconciles
  M3  exactly-once delivery    — no IAR decision is delivered twice
                                 to the same rank incarnation
  M4  no-wedge                 — from every reachable state some
                                 fault-free suffix reaches a converged
                                 view.  Checked two ways: reverse BFS
                                 over the fault-free sub-graph (bound-
                                 truncated frontier states count as
                                 escapes, so every report is a PROVEN
                                 wedge), plus a deep probe that closes
                                 the fault-free closure of the
                                 highest-epoch states — the epoch cap
                                 prunes the readmission-churn climb
                                 pessimistically, because convergence
                                 that needs unbounded epoch growth IS
                                 the livelock M4 exists to catch
  M5  stale-MSYNC safety       — acting on a STALE MSYNC_RSP never
                                 demotes the fleet's last member (the
                                 class the engines' stale guard
                                 governs; a non-stale demote is the
                                 legitimate healing path)

On violation the minimal event schedule is printed together with a
seeded ``Scenario`` replay recipe (transport/sim.py convention, same
shape fuzz counterexamples print).

Tractability reductions (all behavior-preserving, DESIGN.md §20):
directed fault targets per config, at most one reconciliation message
in flight per rank pair, retry-class generator events (suspicion /
probe / contact / announce / membership tick) deferred while more
than MAX_INFLIGHT messages are in flight, concurrent suspicion folded
into one detection transition, and no-op-delivery duplicates skipped.
The healing config is additionally state-budgeted (bounded, not
exhaustive) — sound because every M4 report needs a closed closure.

A third, optional mode drives the REAL engines through
``transport.sim.SimWorld`` using its snapshot / force_step hooks,
branching over deliver/drop/dup of the first membership frames of a
kill-rejoin run and shadow-checking M1/M3/M5 against live engine
state.  It runs only when ``--root`` is this very checkout (the
engines are imported, not read), and is skipped for copied trees.

CLI mirrors rlo-lint/rlo-sentinel/rlo-prover: ``--root``, ``--rules``,
``--json``, ``-q``; exit 0 clean / 1 findings / 2 tool error.  Extra
knobs: ``--config`` (kill-rejoin, partition, sync-crossfire),
``--mutate`` (checker-side semantic mutations m1-sync-downgrade,
m2-skewed-decision, m3-no-dedup used by the mutation fixtures),
``--max-states``, ``--no-sim``.
"""

from __future__ import annotations

import argparse
import ast
import sys
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import (Dict, FrozenSet, Iterable, List, Optional, Sequence,
                    Set, Tuple)

from rlo_tpu_torch.tools import csrc
from rlo_tpu_torch.tools.runner import (AnchorRegistry, Finding, ToolError,
                                        emit, find_anchor)

RULE_IDS = ("M1", "M2", "M3", "M4", "M5", "A1", "A2")

ENGINE_PY = "rlo_tpu_torch/engine.py"
ENGINE_C = "rlo_tpu_torch/native/rlo_engine.c"

#: rlo-model's own anchor spelling.  Deliberately NOT registered in
#: runner.ANCHOR_PREFIXES: the S0 stale-anchor audit only covers
#: anchors consumed by lint/sentinel/prover rules; rlo-model audits
#: its own (rule A2) so the two audits never double-report.
ANCHOR = "rlo-model: edge"

#: handler -> protocol trigger, Python engine.  ``__init__`` is the
#: reconstructed-process restart path (Scenario restart builds a fresh
#: ProgressEngine with incarnation > 0).
PY_TRIGGERS = {
    "_on_join": "join",
    "_on_welcome": "welcome",
    "_on_failure": "failure",
    "_msync_adopt": "msync",
    "rejoin": "restart",
    "__init__": "restart",
}

#: handler -> protocol trigger, C engine.  ``rlo_engine_rejoin`` is a
#: thin wrapper over ``rlo_engine_set_incarnation``; only the latter
#: holds the transition site.
C_TRIGGERS = {
    "on_join": "join",
    "on_welcome": "welcome",
    "on_failure": "failure",
    "msync_adopt": "msync",
    "rlo_engine_set_incarnation": "restart",
}

#: the transition mechanisms themselves — call sites inside these are
#: the mechanism's own plumbing, not automaton edges.
PY_MECHANISMS = {"_become_joiner", "_adopt_view"}
C_MECHANISMS = {"become_joiner", "adopt_view"}

#: the automaton alphabet both engines must induce (and the explored
#: model must cover — rule A2).
EXPECTED_EDGES = frozenset({
    ("join", "joiner"), ("failure", "joiner"), ("restart", "joiner"),
    ("msync", "joiner"), ("msync", "member"), ("welcome", "member"),
})

MUTATE_KNOBS = ("m1-sync-downgrade", "m2-skewed-decision", "m3-no-dedup")
CONFIG_NAMES = ("kill-rejoin", "partition", "sync-crossfire")

EPOCH_CAP = 10          # bounded exploration: epochs beyond this prune
MAX_DEPTH = 40          # interleaving (schedule length) bound
DEFAULT_MAX_STATES = 300_000
MAX_INFLIGHT = 4        # generator-event deferral threshold (see _succs)
M4_PROBE_CANDIDATES = 8 # deep-wedge probe: highest-epoch states tried
M4_PROBE_BUDGET = 8_000 # deep-wedge probe: per-candidate closure cap


class ModelError(ToolError):
    pass


# ---------------------------------------------------------------------------
# Front 1 · cross-engine automaton + guard-fact extraction
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Site:
    """One extracted transition call site."""
    file: str
    line: int
    trigger: str        # join / welcome / msync / failure / restart
    role: str           # role entered: joiner / member
    handler: str        # enclosing function name


@dataclass
class EngineFacts:
    """Everything rlo-model lifts from one engine: the role-automaton
    edge sites plus the three semantic guard facts the abstract model
    is parameterized by."""
    name: str                                   # "py" | "c"
    sites: List[Site] = field(default_factory=list)
    stray: List[Site] = field(default_factory=list)   # unmapped handlers
    stale_guard: bool = False       # MSYNC_RSP stale guard present
    stale_guard_line: int = 0
    grace: bool = False             # joiner-liveness grace stamp present
    grace_line: int = 0
    admit_count: str = "absent"     # "derived" | "literal:<n>" | "absent"
    admit_count_line: int = 0

    @property
    def edges(self) -> FrozenSet[Tuple[str, str]]:
        return frozenset((s.trigger, s.role) for s in self.sites)


def _py_facts(root: Path) -> EngineFacts:
    path = Path(root) / ENGINE_PY
    try:
        src = path.read_text()
    except OSError as e:
        raise ModelError(f"cannot read {ENGINE_PY}: {e}")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        raise ModelError(f"cannot parse {ENGINE_PY}: {e}")

    facts = EngineFacts("py")
    cls = next((n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef) and
                n.name == "ProgressEngine"), None)
    if cls is None:
        raise ModelError(f"{ENGINE_PY}: class ProgressEngine not found")

    for meth in (n for n in cls.body if isinstance(n, ast.FunctionDef)):
        if meth.name in PY_MECHANISMS:
            continue
        trigger = PY_TRIGGERS.get(meth.name)
        for node in ast.walk(meth):
            role = None
            line = 0
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                if node.func.attr == "_become_joiner":
                    role, line = "joiner", node.lineno
                elif node.func.attr == "_adopt_view":
                    role, line = "member", node.lineno
            elif isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Attribute) and
                    isinstance(t.value, ast.Name) and
                    t.value.id == "self" and
                    t.attr == "_awaiting_welcome"
                    for t in node.targets):
                # direct joiner-entry outside the mechanisms (the
                # reconstructed-process path in __init__)
                role, line = "joiner", node.lineno
            if role is None:
                continue
            site = Site(ENGINE_PY, line, trigger or "?", role, meth.name)
            (facts.sites if trigger else facts.stray).append(site)

    # guard fact: stale-MSYNC_RSP guard — inside _msync_adopt, an
    # ``if stale: return`` whose test is EXACTLY the name `stale`
    # (so `if stale and False:` reads as guard-deleted).
    adopt = next((n for n in cls.body if isinstance(n, ast.FunctionDef)
                  and n.name == "_msync_adopt"), None)
    if adopt is not None:
        for node in ast.walk(adopt):
            if isinstance(node, ast.If) and \
                    isinstance(node.test, ast.Name) and \
                    node.test.id == "stale" and \
                    any(isinstance(b, ast.Return) for b in node.body):
                facts.stale_guard = True
                facts.stale_guard_line = node.lineno
                break

    # guard fact: joiner-liveness grace — inside _execute_admission, an
    # assignment  self._hb_seen[...] = <clock() + grace-term>  whose
    # RHS is an additive expression (``= self.clock()`` alone means
    # the grace was deleted).
    execadm = next((n for n in cls.body if isinstance(n, ast.FunctionDef)
                    and n.name == "_execute_admission"), None)
    if execadm is not None:
        for node in ast.walk(execadm):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.targets[0], ast.Subscript) and \
                    isinstance(node.targets[0].value, ast.Attribute) and \
                    node.targets[0].value.attr == "_hb_seen":
                if isinstance(node.value, ast.BinOp) and \
                        isinstance(node.value.op, ast.Add):
                    facts.grace = True
                facts.grace_line = node.lineno
                break

    # guard fact: batched-admission count class — in _membership_tick,
    # the third operand of struct.pack("<ii", new_epoch, X): a Name /
    # len(...) call is "derived", an int literal is "literal:<n>".
    tick = next((n for n in cls.body if isinstance(n, ast.FunctionDef)
                 and n.name == "_membership_tick"), None)
    if tick is not None:
        for node in ast.walk(tick):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "pack" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    node.args[0].value == "<ii" and \
                    len(node.args) >= 3:
                cnt = node.args[2]
                if isinstance(cnt, ast.Constant) and \
                        isinstance(cnt.value, int):
                    facts.admit_count = f"literal:{cnt.value}"
                else:
                    facts.admit_count = "derived"
                facts.admit_count_line = node.lineno
                break
    return facts


def _tok_vals(toks: Sequence[csrc.Token]) -> List[str]:
    return [t[1] for t in toks]


def _find_subseq(vals: Sequence[str], pat: Sequence[str],
                 start: int = 0) -> int:
    """Index of the first occurrence of ``pat`` as a contiguous token
    subsequence, or -1."""
    n, m = len(vals), len(pat)
    for i in range(start, n - m + 1):
        if vals[i:i + m] == list(pat):
            return i
    return -1


def _c_facts(root: Path) -> EngineFacts:
    model = csrc.parse_c_files(Path(root), [ENGINE_C])
    facts = EngineFacts("c")

    for fname, func in sorted(model.funcs.items()):
        if func.path != ENGINE_C or fname in C_MECHANISMS:
            continue
        trigger = C_TRIGGERS.get(fname)
        vals = _tok_vals(func.toks)
        for i, v in enumerate(vals[:-1]):
            role = None
            if vals[i + 1] == "(" and (i == 0 or vals[i - 1] not in
                                       ("->", ".")):
                if v == "become_joiner":
                    role = "joiner"
                elif v == "adopt_view":
                    role = "member"
            if role is None:
                # direct joiner-entry outside the mechanisms would be
                # an  e->awaiting_welcome = ...  assignment
                if v == "awaiting_welcome" and vals[i + 1] == "=" and \
                        i >= 1 and vals[i - 1] == "->":
                    role = "joiner"
                else:
                    continue
            site = Site(ENGINE_C, func.toks[i][2], trigger or "?",
                        role, fname)
            (facts.sites if trigger else facts.stray).append(site)

    adopt = model.funcs.get("msync_adopt")
    if adopt is not None:
        vals = _tok_vals(adopt.toks)
        at = _find_subseq(vals, ["if", "(", "stale", ")", "return"])
        if at >= 0:
            facts.stale_guard = True
            facts.stale_guard_line = adopt.toks[at][2]

    execadm = model.funcs.get("execute_admission")
    if execadm is not None:
        vals = _tok_vals(execadm.toks)
        for i, v in enumerate(vals):
            if v == "hb_seen" and "=" in vals[i:i + 8]:
                stop = vals.index(";", i) if ";" in vals[i:] else len(vals)
                if "+" in vals[i:stop]:
                    facts.grace = True
                facts.grace_line = execadm.toks[i][2]
                break

    launch = model.funcs.get("launch_admission_round")
    if launch is not None:
        vals = _tok_vals(launch.toks)
        at = _find_subseq(vals, ["RLO_MEMBER_MAGIC_LEN", "+", "4", ","])
        if at >= 0 and at + 4 < len(vals):
            kind, cnt = launch.toks[at + 4][0], vals[at + 4]
            facts.admit_count = (f"literal:{cnt}" if kind == "num"
                                 else "derived")
            facts.admit_count_line = launch.toks[at + 4][2]
    return facts


def _audit_anchors(root: Path, facts: EngineFacts,
                   registry: Optional[AnchorRegistry]) -> List[Finding]:
    """Rule A2's anchor half: every extracted site must carry an
    ``rlo-model: edge <trigger>-><role>`` anchor (same line or up to 2
    above), and every rlo-model anchor in the file must belong to an
    extracted site — a stale anchor means the transition it documented
    was edited away."""
    out: List[Finding] = []
    relfile = ENGINE_PY if facts.name == "py" else ENGINE_C
    try:
        lines = (Path(root) / relfile).read_text().splitlines()
    except OSError as e:
        raise ModelError(f"cannot read {relfile}: {e}")
    consumed: Set[int] = set()
    for site in facts.sites + facts.stray:
        ln = find_anchor(lines, site.line, ANCHOR)
        if ln is None:
            out.append(Finding(
                "A2", relfile, site.line,
                f"unanchored transition site: {site.handler} enters role "
                f"{site.role!r} (trigger {site.trigger!r}) with no "
                f"'{ANCHOR} {site.trigger}->{site.role}' anchor comment"))
            continue
        consumed.add(ln)
        if registry is not None:
            registry.consume(relfile, ln)
        want = f"{ANCHOR} {site.trigger}->{site.role}"
        if want not in lines[ln - 1]:
            out.append(Finding(
                "A2", relfile, ln,
                f"anchor mismatch: site {site.handler}:{site.line} is "
                f"trigger {site.trigger!r} -> role {site.role!r} but the "
                f"anchor says {lines[ln - 1].split(ANCHOR, 1)[1].strip()!r}"))
    for i, text in enumerate(lines, start=1):
        if ANCHOR in text and i not in consumed:
            out.append(Finding(
                "A2", relfile, i,
                f"stale rlo-model anchor: no extracted transition site "
                f"consumed it — the transition it documented was edited "
                f"away (or extraction drifted)", severity="warning"))
    return out


def _rule_a1(py: EngineFacts, c: EngineFacts) -> List[Finding]:
    """Cross-engine parity: both engines must induce the same role
    automaton AND the same guard facts — the model's semantics are
    keyed on the conjunction, so divergence is a finding even before
    exploration runs."""
    out: List[Finding] = []
    for tr, role in sorted(py.edges - c.edges):
        site = next(s for s in py.sites if (s.trigger, s.role) == (tr, role))
        out.append(Finding(
            "A1", ENGINE_C, 1,
            f"automaton divergence: edge {tr}->{role} exists in engine.py "
            f"({site.handler}:{site.line}) but rlo_engine.c has no "
            f"equivalent transition"))
    for tr, role in sorted(c.edges - py.edges):
        site = next(s for s in c.sites if (s.trigger, s.role) == (tr, role))
        out.append(Finding(
            "A1", ENGINE_PY, 1,
            f"automaton divergence: edge {tr}->{role} exists in "
            f"rlo_engine.c ({site.handler}:{site.line}) but engine.py has "
            f"no equivalent transition"))
    pairs = (
        ("stale_guard", "stale-MSYNC_RSP guard",
         py.stale_guard, c.stale_guard,
         py.stale_guard_line, c.stale_guard_line),
        ("grace", "joiner-liveness grace stamp",
         py.grace, c.grace, py.grace_line, c.grace_line),
        ("admit_count", "batched-admission count class",
         py.admit_count, c.admit_count,
         py.admit_count_line, c.admit_count_line),
    )
    for _key, label, pv, cv, pl, cl in pairs:
        if pv != cv:
            out.append(Finding(
                "A1", ENGINE_PY if pl else ENGINE_C, pl or cl or 1,
                f"guard-fact divergence: {label} is {pv!r} in engine.py "
                f"but {cv!r} in rlo_engine.c — the engines implement "
                f"different admission/healing semantics"))
    return out


@dataclass
class Facts:
    """The conjunction of both engines' facts — what the abstract
    model actually runs with.  A guard counts as present only when
    BOTH engines have it, so a single-engine deletion both fires A1
    and weakens the model (making the matching M-rule fire with a
    schedule)."""
    py: EngineFacts
    c: EngineFacts

    @property
    def stale_guard(self) -> bool:
        return self.py.stale_guard and self.c.stale_guard

    @property
    def grace(self) -> bool:
        return self.py.grace and self.c.grace

    @property
    def batched(self) -> bool:
        return (self.py.admit_count == "derived" and
                self.c.admit_count == "derived")


# ---------------------------------------------------------------------------
# Front 2 · abstract protocol model (parameterized by extracted facts)
# ---------------------------------------------------------------------------
# A global state is the canonical tuple
#     (ranks, msgs, budgets, cut)
# ranks   — tuple indexed by rank id, each rank itself the tuple
#           (role, epoch, inc, wel, view, failed, adm, pet, delivered)
#           role      "member" | "joiner" | "dead"
#           wel       epoch of the last WELCOME adopted (-1 while joiner)
#           view      frozenset of member ranks
#           failed    sorted tuple of (rank, declared_epoch)
#           adm       executed admission sequence, (epoch, joiner, inc)*
#           pet       pending petitions, sorted (joiner, inc)*
#           delivered IAR decision ids picked up, in delivery order
# msgs    — frozenset of in-flight (kind, src, dst, payload) tuples.
#           Set semantics double as dedup: re-sending an identical frame
#           is a no-op, which keeps probe/announce retries finite; the
#           explicit `dup` event models duplicated delivery instead.
# budgets — (kills, restarts, drops, dups, partitions) remaining
# cut     — active partition as a frozenset (vs. the rest), or None
#
# Canonicalization: every component is a sorted/frozen immutable, so
# the state tuple IS its canonical form and Python's tuple hash is the
# dedup key.

R_ROLE, R_EPOCH, R_INC, R_WEL, R_VIEW, R_FAILED, R_ADM, R_PET, \
    R_DELIV = range(9)
B_KILL, B_RESTART, B_DROP, B_DUP, B_PART = range(5)

_RF = {"role": R_ROLE, "epoch": R_EPOCH, "inc": R_INC, "wel": R_WEL,
       "view": R_VIEW, "failed": R_FAILED, "adm": R_ADM, "pet": R_PET,
       "deliv": R_DELIV}


def _rank(role: str, epoch: int = 0, inc: int = 0, wel: int = 0,
          view: Iterable[int] = (), failed: Iterable = (),
          adm: Iterable = (), pet: Iterable = (),
          deliv: Iterable = ()) -> tuple:
    return (role, epoch, inc, wel, frozenset(view),
            tuple(sorted(failed)), tuple(adm), tuple(sorted(pet)),
            frozenset(deliv))


def _with(rk: tuple, **kw) -> tuple:
    lst = list(rk)
    for k, v in kw.items():
        lst[_RF[k]] = v
    return tuple(lst)


def _bud(bud: tuple, slot: int) -> tuple:
    lst = list(bud)
    lst[slot] -= 1
    return tuple(lst)


def _fmap(failed: tuple) -> Dict[int, int]:
    return dict(failed)


def _admit_epoch(adm: tuple, j: int) -> int:
    eps = [e for (e, jj, _i) in adm if jj == j]
    return max(eps) if eps else -1


def _admit_inc(adm: tuple, j: int) -> int:
    """Latest admitted incarnation for rank j (0 for founding members
    that were never re-admitted)."""
    recs = [(e, i) for (e, jj, i) in adm if jj == j]
    return max(recs)[1] if recs else 0


def _live_members(ranks: tuple) -> List[int]:
    return [i for i, rk in enumerate(ranks) if rk[R_ROLE] == "member"]


def _demote(ranks: tuple, i: int) -> Tuple[tuple, Set[tuple]]:
    """become_joiner at rank i: drop membership state, keep epoch and
    incarnation, and (re)start the join protocol by probing everyone."""
    rk = ranks[i]
    nr = _with(rk, role="joiner", wel=-1, view=frozenset(),
               failed=(), pet=())
    sent = {("JOINP", i, t, (rk[R_INC], rk[R_EPOCH]))
            for t in range(len(ranks)) if t != i}
    return tuple(nr if j == i else r for j, r in enumerate(ranks)), sent


def _mark_failed(ranks: tuple, i: int, target: int,
                 declared: int) -> Tuple[tuple, Set[tuple]]:
    """Rank i declares `target` failed at epoch `declared`: epoch bump,
    view drop, FAIL notices flooded to the surviving view."""
    rk = ranks[i]
    nview = rk[R_VIEW] - {target}
    nfailed = tuple(sorted(_fmap(rk[R_FAILED]).items() |
                           {(target, declared)}))
    npet = tuple(p for p in rk[R_PET] if p[0] != target)
    nr = _with(rk, epoch=rk[R_EPOCH] + 1, view=nview, failed=nfailed,
               pet=npet)
    sent = {("FAIL", i, m, (target, declared))
            for m in nview if m != i}
    return tuple(nr if j == i else r for j, r in enumerate(ranks)), sent


def _replace(ranks: tuple, i: int, nr: tuple) -> tuple:
    return tuple(nr if j == i else r for j, r in enumerate(ranks))


def _deliver(ranks: tuple, msg: tuple, facts: "Facts",
             mutate: Sequence[str]
             ) -> Tuple[tuple, Set[tuple], Optional[str], FrozenSet]:
    """Apply one message delivery.  Returns (ranks', sent, violation,
    observed-automaton-edges).  `violation` is "M5" when this very
    delivery demotes the fleet's last member off an MSYNC_RSP."""
    kind, src, dst, payload = msg
    rk = ranks[dst]
    role = rk[R_ROLE]
    none: Tuple[tuple, Set[tuple], Optional[str], FrozenSet] = \
        (ranks, set(), None, frozenset())
    if role == "dead":
        return none

    if kind == "DECIDE":
        (pid,) = payload
        if pid in rk[R_DELIV]:
            if "m3-no-dedup" not in mutate:
                return none  # pickup dedup: second delivery is inert
            return (ranks, set(),
                    ("M3", f"rank {dst} picked up decision {pid} twice "
                           f"in incarnation {rk[R_INC]}"), frozenset())
        nr = _with(rk, deliv=rk[R_DELIV] | {pid})
        return _replace(ranks, dst, nr), set(), None, frozenset()

    if role == "joiner":
        if kind == "WELCOME":
            epoch, view, inc, adm = payload
            if inc == rk[R_INC] and dst in view:
                nr = _with(rk, role="member",
                           epoch=max(rk[R_EPOCH], epoch), wel=epoch,
                           view=view, failed=(), adm=adm, pet=())
                return (_replace(ranks, dst, nr), set(), None,
                        frozenset({("welcome", "member")}))
            return none
        if kind == "SYNCRSP":
            epoch, view, failed, adm = payload
            # lost-welcome supersede: the sync response IS the welcome
            if dst in view and epoch > rk[R_EPOCH] and \
                    dst not in _fmap(failed):
                wel = _admit_epoch(adm, dst)
                nr = _with(rk, role="member",
                           epoch=max(rk[R_EPOCH], epoch),
                           wel=wel if wel >= 0 else epoch, view=view,
                           failed=failed, adm=adm, pet=())
                return (_replace(ranks, dst, nr), set(), None,
                        frozenset({("msync", "member")}))
            return none
        return none  # joiners ignore FAIL/JOINP/PROBE/ADMIT/SYNCREQ

    # --- member handlers -------------------------------------------------
    if kind == "FAIL":
        target, declared = payload
        if target == dst:
            if declared < rk[R_WEL]:
                return none  # stale self-notice (pre-readmission)
            nranks, sent = _demote(ranks, dst)
            return nranks, sent, None, frozenset({("failure", "joiner")})
        if declared < _admit_epoch(rk[R_ADM], target) or \
                target in _fmap(rk[R_FAILED]) or \
                target not in rk[R_VIEW]:
            return none  # stale or already-known notice
        nranks, sent = _mark_failed(ranks, dst, target, declared)
        return nranks, sent, None, frozenset()

    if kind == "JOINP":
        inc, _jepoch = payload
        j = src
        if j in rk[R_VIEW] and j not in _fmap(rk[R_FAILED]):
            if inc < _admit_inc(rk[R_ADM], j):
                return none  # stale probe from a replaced life
            if inc == _admit_inc(rk[R_ADM], j) and \
                    _admit_epoch(rk[R_ADM], j) > 0:
                # certified lost-welcome (an admission this member
                # can vouch for): the sync response IS the welcome
                rsp = ("SYNCRSP", dst, j, (rk[R_EPOCH], rk[R_VIEW],
                                           rk[R_FAILED], rk[R_ADM]))
                return ranks, {rsp}, None, frozenset()
            # an ALIVE in-view rank is petitioning against this view:
            # it reset itself and quarantines our traffic, so it is
            # effectively failed here — announce that AND queue the
            # petition (the engine's anti-wedge path: without it a
            # lone stale-view winner answers petitions with probes
            # forever and nobody ever admits anyone)
            nranks, sent = _mark_failed(ranks, dst, j, rk[R_EPOCH])
            nrk = nranks[dst]
            pet = {p for p in nrk[R_PET] if p[0] != j} | {(j, inc)}
            nrk = _with(nrk, pet=tuple(sorted(pet)))
            return _replace(nranks, dst, nrk), sent, None, frozenset()
        pet = dict(rk[R_PET])
        if pet.get(j, -1) >= inc:
            return none
        pet[j] = inc
        nr = _with(rk, pet=tuple(sorted(pet.items())))
        return _replace(ranks, dst, nr), set(), None, frozenset()

    if kind == "PROBE":
        epoch, minv, view, _inc = payload
        theirs = (epoch, -minv)
        mine = (rk[R_EPOCH], -min(rk[R_VIEW] | {dst}))
        mine_wins = mine > theirs or (mine == theirs and dst < src)
        if mine_wins:
            fm = _fmap(rk[R_FAILED])
            if src in fm:
                return (ranks, {("FAIL", dst, src, (src, fm[src]))},
                        None, frozenset())
            back = ("PROBE", dst, src, (rk[R_EPOCH],
                                        min(rk[R_VIEW] | {dst}),
                                        rk[R_VIEW], rk[R_INC]))
            return ranks, {back}, None, frozenset()
        if dst in view:
            return ranks, {("SYNCREQ", dst, src, ())}, None, frozenset()
        nranks, sent = _demote(ranks, dst)
        return nranks, sent, None, frozenset({("join", "joiner")})

    if kind == "ADMIT":
        new_epoch, batch = payload
        nrk = rk
        changed = False
        for (j, inc) in batch:
            if new_epoch <= _admit_epoch(nrk[R_ADM], j):
                continue  # idempotence: this admission already executed
            changed = True
            nrk = _with(
                nrk,
                adm=nrk[R_ADM] + ((new_epoch, j, inc),),
                view=nrk[R_VIEW] | {j},
                failed=tuple(p for p in nrk[R_FAILED] if p[0] != j),
                pet=tuple(p for p in nrk[R_PET] if p[0] != j))
        if not changed:
            return none
        nrk = _with(nrk, epoch=max(nrk[R_EPOCH], new_epoch))
        return _replace(ranks, dst, nrk), set(), None, frozenset()

    if kind == "SYNCREQ":
        rsp = ("SYNCRSP", dst, src, (rk[R_EPOCH], rk[R_VIEW],
                                     rk[R_FAILED], rk[R_ADM]))
        return ranks, {rsp}, None, frozenset()

    if kind == "SYNCRSP":
        epoch, view, failed, adm = payload
        stale = epoch <= rk[R_EPOCH]
        if dst not in view:
            # the responder's view does not hold me at all: if it
            # wins, only a full rejoin gets me back in
            if not stale:
                nranks, sent = _demote(ranks, dst)
                return (nranks, sent, None,
                        frozenset({("msync", "joiner")}))
            return none
        nr, obs = rk, frozenset()
        if not stale or "m1-sync-downgrade" in mutate:
            # laggard catch-up: adopt the strictly-newer view
            # wholesale (epoch max-merged — the m1 knob models the
            # tree REPLACING the max with a bare assignment)
            ne = (epoch if "m1-sync-downgrade" in mutate
                  else max(rk[R_EPOCH], epoch))
            nr = _with(rk, epoch=ne, view=view, failed=failed,
                       adm=adm)
            obs = frozenset({("msync", "member")})
        if src in _fmap(nr[R_FAILED]):
            # the responder is in MY failed set: the two views cannot
            # converge by sync alone — full rejoin (status quo ante),
            # UNLESS the response is stale, where the guard drops it
            if stale:
                if facts.stale_guard:
                    return none  # the stale-MSYNC_RSP guard (M5)
                viol = None
                if _live_members(ranks) == [dst]:
                    viol = ("M5", "acting on a stale MSYNC_RSP "
                                  "demoted the fleet's last member "
                                  "(empty fleet)")
                nranks, sent = _demote(ranks, dst)
                return (nranks, sent, viol,
                        frozenset({("msync", "joiner")}))
            nranks, sent = _demote(_replace(ranks, dst, nr), dst)
            return (nranks, sent, None,
                    obs | frozenset({("msync", "joiner")}))
        return _replace(ranks, dst, nr), set(), None, obs

    if kind == "WELCOME":
        return none  # already a member; duplicate welcome is inert
    raise ModelError(f"unmodeled message kind {kind!r}")


def _succs(state: tuple, facts: "Facts", mutate: Sequence[str],
           cfg: "Config") -> List[
               Tuple[str, bool, tuple, FrozenSet, Optional[tuple]]]:
    """All successor transitions of `state`:
    (label, is_fault, state', observed-edges, violation)."""
    ranks, msgs, bud, cut = state
    n = len(ranks)
    out = []

    def crosses(a: int, b: int) -> bool:
        return cut is not None and ((a in cut) != (b in cut))

    # retry-class generator events (suspect / probe / contact /
    # announce) are deferred while the network is saturated: they are
    # all idempotent retries the engines pace with timers, so letting
    # in-flight traffic drain first loses no behaviors — the event
    # re-enables as soon as a delivery frees a slot — and it caps the
    # in-flight set the interleaving fan-out is exponential in.
    unsaturated = len(msgs) < MAX_INFLIGHT

    for m in sorted(msgs):
        kind, src, dst, _payload = m
        base = f"{kind} {src}->{dst}"
        if not crosses(src, dst):
            nranks, sent, viol, obs = _deliver(ranks, m, facts, mutate)
            out.append((f"deliver {base}", False,
                        (nranks, (msgs - {m}) | frozenset(sent), bud,
                         cut), obs, viol))
            if bud[B_DUP] > 0 and kind in cfg.dup_kinds and \
                    (nranks != ranks or sent or viol):
                # (a no-op delivery dup'd again is a strict waste of
                # the adversary's budget — skip the fork)
                out.append((f"dup {base}", True,
                            (nranks, msgs | frozenset(sent),
                             _bud(bud, B_DUP), cut), obs, viol))
        if bud[B_DROP] > 0 and kind in cfg.drop_kinds:
            out.append((f"drop {base}", True,
                        (ranks, msgs - {m}, _bud(bud, B_DROP), cut),
                        frozenset(), None))

    for i, rk in enumerate(ranks):
        role = rk[R_ROLE]
        if role != "dead" and bud[B_KILL] > 0 and \
                i in cfg.kill_targets:
            out.append((f"kill {i}", True,
                        (_replace(ranks, i, _with(rk, role="dead")),
                         msgs, _bud(bud, B_KILL), cut),
                        frozenset(), None))
        if role == "dead" and bud[B_RESTART] > 0 and \
                i in cfg.restart_targets:
            nr = _rank("joiner", 0, inc=rk[R_INC] + 1, wel=-1)
            sent = {("JOINP", i, t, (rk[R_INC] + 1, 0))
                    for t in range(n) if t != i}
            out.append((f"restart {i}", False,
                        (_replace(ranks, i, nr), msgs | frozenset(sent),
                         _bud(bud, B_RESTART), cut),
                        frozenset({("restart", "joiner")}), None))
        if role == "joiner" and unsaturated:
            sent = {("JOINP", i, t, (rk[R_INC], rk[R_EPOCH]))
                    for t in range(n) if t != i} - msgs
            if sent:
                out.append((f"probe {i}", False,
                            (ranks, msgs | frozenset(sent), bud, cut),
                            frozenset(), None))
        if role != "member":
            continue
        fm = _fmap(rk[R_FAILED])
        # failure detection: only dead or partitioned-away peers
        # can be suspected — ANY accepted frame (JOIN probes
        # included) proves its sender alive in the engine, so an
        # actively petitioning joiner is never timed out.  All
        # concurrently-eligible peers are folded into ONE detection
        # transition: they timed out together, and the orderings a
        # peer-at-a-time sweep would add are subsumed by delivery
        # interleavings of the resulting FAIL floods.
        if unsaturated:
            suspects = [t for t in range(n)
                        if t != i and t in rk[R_VIEW] and t not in fm
                        and (ranks[t][R_ROLE] == "dead"
                             or crosses(i, t))]
            if suspects:
                nranks, sent = ranks, set()
                for t in suspects:
                    nranks, st = _mark_failed(
                        nranks, i, t, nranks[i][R_EPOCH])
                    sent |= st
                out.append((f"suspect {i}!{suspects}", False,
                            (nranks, msgs | frozenset(sent), bud,
                             cut), frozenset(), None))
        for t in range(n):
            if t == i:
                continue
            trk = ranks[t]
            # at most one reconciliation message (PROBE/FAIL) in
            # flight per unordered pair: a second concurrent attempt
            # only multiplies interleavings of identical outcomes
            busy = any(k in ("PROBE", "FAIL") and {a, b} == {i, t}
                       for (k, a, b, _p) in msgs)
            # reconciliation probe: members with divergent views
            if trk[R_ROLE] == "member" and not crosses(i, t) and \
                    not busy and unsaturated and \
                    (rk[R_EPOCH], rk[R_VIEW]) != \
                    (trk[R_EPOCH], trk[R_VIEW]):
                pm = ("PROBE", i, t, (rk[R_EPOCH],
                                      min(rk[R_VIEW] | {i}),
                                      rk[R_VIEW], rk[R_INC]))
                out.append((f"contact {i}-{t}", False,
                            (ranks, msgs | {pm}, bud, cut),
                            frozenset(), None))
            # heartbeat bounce: "you were declared failed"
            if trk[R_ROLE] == "member" and t in fm and \
                    not crosses(i, t) and not busy and unsaturated:
                am = ("FAIL", i, t, (t, fm[t]))
                out.append((f"announce {i}->{t}", False,
                            (ranks, msgs | {am}, bud, cut),
                            frozenset(), None))
        # designated admitter: lowest rank of its own view.  The
        # membership tick is timer-paced like the other generator
        # events, so it defers under saturation too — a revoked-
        # admission churn loop must drain its own flood before it
        # can spin again (this is what keeps the graceless-livelock
        # subgraph small enough to CLOSE, which the M4 proof needs).
        if rk[R_PET] and min(rk[R_VIEW] | {i}) == i and unsaturated:
            out.append(_admit_event(ranks, i, msgs, bud, cut, facts,
                                    mutate))

    if cut is None and bud[B_PART] > 0:
        for c in (frozenset(c) for c in cfg.cuts):
            out.append((f"partition {set(c)}", True,
                        (ranks, msgs, _bud(bud, B_PART), c),
                        frozenset(), None))
    elif cut is not None:
        out.append(("heal", False, (ranks, msgs, bud, None),
                    frozenset(), None))
    return out


def _admit_event(ranks: tuple, i: int, msgs: frozenset, bud: tuple,
                 cut, facts: "Facts", mutate: Sequence[str]
                 ) -> Tuple[str, bool, tuple, FrozenSet, Optional[str]]:
    """The designated admitter runs a membership tick: one batched
    admission round covering every pending petition (v2 batching)."""
    rk = ranks[i]
    new_epoch = rk[R_EPOCH] + 1
    batch = tuple(sorted(rk[R_PET]))
    records = tuple((new_epoch, j, inc) for j, inc in batch)
    old_members = rk[R_VIEW] - {j for j, _ in batch}
    nview = rk[R_VIEW] | {j for j, _ in batch} | {i}
    nrk = _with(rk, epoch=new_epoch, view=nview,
                adm=rk[R_ADM] + records,
                failed=tuple(p for p in rk[R_FAILED]
                             if p[0] not in dict(batch)),
                pet=())
    nranks = _replace(ranks, i, nrk)
    sent_batch = batch
    if "m2-skewed-decision" in mutate:
        # checker mutation: the admitter records one incarnation but
        # broadcasts another — members execute a divergent admission
        sent_batch = tuple((j, inc + 1) for j, inc in batch)
    sent: Set[tuple] = set()
    for j, _inc in batch:
        jrk = ranks[j]
        sent.add(("WELCOME", i, j, (new_epoch, nview, jrk[R_INC],
                                    nrk[R_ADM])))
    for m in old_members:
        if m != i:
            sent.add(("ADMIT", i, m, (new_epoch, sent_batch)))
    if not facts.grace:
        # Grace deleted: the admitter's liveness stamp for the joiner
        # predates the welcome round-trip, so the failure detector is
        # guaranteed to fire before the joiner's first heartbeat can
        # land.  Model that deterministically: the admission is
        # immediately revoked (this is what turns the deletion into a
        # reachable M4 wedge rather than a lucky race).
        for j, _inc in batch:
            nranks, resent = _mark_failed(nranks, i, j, new_epoch)
            sent |= resent
    return (f"admit {i}", False,
            (nranks, msgs | frozenset(sent), bud, cut),
            frozenset(), None)


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Config:
    """One explored configuration: an initial global state plus fault
    budgets.  `seed` keys the printed Scenario replay recipe."""
    name: str
    seed: int
    ranks: tuple
    msgs: FrozenSet[tuple]
    budgets: Tuple[int, int, int, int, int]
    note: str
    #: which ranks the kill / restart budgets may target, and which
    #: single-side partition cuts are explored.  Directing the faults
    #: (instead of letting the adversary pick any of n symmetric
    #: victims) keeps the exhaustive interleaving space tractable
    #: without losing behaviors: the untargeted choices are
    #: role-symmetric images of the targeted ones.
    kill_targets: Tuple[int, ...] = ()
    restart_targets: Tuple[int, ...] = ()
    cuts: Tuple[Tuple[int, ...], ...] = ()
    #: ranks already partitioned away in the initial state (the cut
    #: is live at t=0; `heal` is an explorable event from the root).
    start_cut: Tuple[int, ...] = ()
    #: epoch ceiling for bounded exploration (successors beyond it
    #: are pruned, and — deliberately — do NOT count as M4 escapes:
    #: convergence that needs unbounded epoch growth IS the livelock
    #: class M4 exists to catch).  Per config because the clean-tree
    #: epoch ceiling differs: kill-rejoin peaks at 2, healing configs
    #: at 5-6; the cap needs headroom above the clean ceiling and to
    #: sit close enough that a churn loop (+2 epochs per revoked
    #: admission cycle) closes within the state budget.
    epoch_cap: int = EPOCH_CAP
    #: per-config state budget (None = the global/CLI cap).  The
    #: healing config is deliberately bounded: its breadth is far
    #: beyond an exhaustive sweep, and the optimistic-frontier M4
    #: semantics keep every finding from a truncated run sound.
    max_states: Optional[int] = None
    #: message kinds the drop / dup budgets may target.  Dup is
    #: restricted to kinds whose second delivery is not handler-
    #: idempotent by construction (JOINP/PROBE/FAIL/SYNCREQ re-
    #: delivery is a no-op modulo already-branched orderings).
    drop_kinds: Tuple[str, ...] = ("DECIDE", "FAIL", "JOINP", "PROBE", "ADMIT", "SYNCREQ", "SYNCRSP", "WELCOME")
    dup_kinds: Tuple[str, ...] = ("DECIDE", "FAIL", "JOINP", "PROBE", "ADMIT", "SYNCREQ", "SYNCRSP", "WELCOME")
    #: invariants meaningful for this config.  Liveness (M4) is only
    #: asserted from protocol-reachable starts: a synthesized
    #: adversarial start over-approximates reachability, and the
    #: engine itself documents that a fleet whose every member is
    #: demoted has no admitter left (the memberless wedge).
    check: Tuple[str, ...] = ("M1", "M2", "M3", "M4", "M5")


def _configs() -> Dict[str, Config]:
    full = frozenset({0, 1, 2})
    members = lambda deliv=(): _rank("member", 0, view=full, deliv=deliv)
    return {
        "kill-rejoin": Config(
            "kill-rejoin", 41,
            ranks=(members(deliv=(1,)), members(), members()),
            msgs=frozenset({("DECIDE", 0, 2, (1,))}),
            budgets=(1, 1, 1, 1, 0),
            kill_targets=(1,), restart_targets=(1,),
            drop_kinds=("WELCOME", "DECIDE"), dup_kinds=("DECIDE",),
            epoch_cap=6,
            note="n=3, one kill + one rejoin of rank 1, 1 drop + "
                 "1 dup, one IAR decision in flight (the check.sh "
                 "gate config)"),
        "partition": Config(
            "partition", 42,
            # the exploration starts AT the healed boundary: both
            # sides have fully suspected across the cut (kill-rejoin
            # already explores detection interleavings exhaustively);
            # what this config owns is every healing interleaving.
            ranks=(
                _rank("member", 2, view={0}, failed=((1, 0), (2, 1))),
                _rank("member", 1, view={1, 2}, failed=((0, 0),)),
                _rank("member", 1, view={1, 2}, failed=((0, 0),)),
            ),
            msgs=frozenset(),
            budgets=(0, 0, 0, 0, 0),
            start_cut=(0,),
            max_states=30_000,
            note="n=3, rank 0 partitioned away, suspicion complete on "
                 "both sides, heal pending — exercises split-brain "
                 "healing (join/failure demotes)"),
        "sync-crossfire": Config(
            "sync-crossfire", 43,
            ranks=(
                _rank("member", 3, view={0}, failed=((1, 2),)),
                _rank("member", 2, view={1}, failed=((0, 1),)),
                _rank("dead", 0, wel=-1),
            ),
            msgs=frozenset({
                # crossed failure-scoped sync responses, mid-churn
                ("SYNCRSP", 1, 0, (2, frozenset({1}), ((0, 1),), ())),
                ("SYNCRSP", 0, 1, (3, frozenset({0}), ((1, 2),), ())),
                # a pre-suspicion response still in flight (stale path)
                ("SYNCRSP", 1, 0, (2, frozenset({0, 1}), (), ())),
            }),
            budgets=(0, 0, 0, 0, 0),
            check=("M1", "M2", "M3", "M5"),
            note="synthesized asymmetric mid-churn start (shape taken "
                 "from the PR-16 fuzz corpus): two members with crossed "
                 "MSYNC_RSPs that each declare the other failed — the "
                 "M5 stale-guard battleground"),
    }


# ---------------------------------------------------------------------------
# Exhaustive exploration + invariant checks
# ---------------------------------------------------------------------------

def _m2_violation(ranks: tuple) -> Optional[str]:
    """Admission agreement: two members must never hold CONFLICTING
    admission certificates — same (admitted member, admission epoch)
    but different incarnations.  Formulated over certificates rather
    than per-epoch batches because epoch numbers can collide across a
    healed split-brain (each component mints its own sequence; the
    histories reconcile by wholesale MSYNC adoption).  Scoped to
    members sharing (epoch, view): those are the ones the batched-v2
    broadcast promises agreement among."""
    groups: List[Tuple[int, tuple, Dict[tuple, int]]] = []
    for i, rk in enumerate(ranks):
        if rk[R_ROLE] != "member":
            continue
        certs = {(j, e): inc for (e, j, inc) in rk[R_ADM]}
        groups.append((i, (rk[R_EPOCH], rk[R_VIEW]), certs))
    for x in range(len(groups)):
        for y in range(x + 1, len(groups)):
            a, ka, ga = groups[x]
            b, kb, gb = groups[y]
            if ka != kb:
                continue
            for (j, e) in sorted(ga.keys() & gb.keys()):
                if ga[(j, e)] != gb[(j, e)]:
                    return (f"ranks {a} and {b} executed divergent "
                            f"epoch-{e} admissions of rank {j}: "
                            f"incarnation {ga[(j, e)]} vs "
                            f"{gb[(j, e)]}")
    return None


def _converged(state: tuple) -> bool:
    ranks = state[0]
    live = [i for i, rk in enumerate(ranks) if rk[R_ROLE] != "dead"]
    if not live or any(ranks[i][R_ROLE] != "member" for i in live):
        return False
    want = frozenset(live)
    ref = (ranks[live[0]][R_EPOCH], ranks[live[0]][R_VIEW])
    return all((ranks[i][R_EPOCH], ranks[i][R_VIEW]) == ref and
               ranks[i][R_VIEW] == want for i in live)


def _schedule(parents: Dict, state: tuple) -> List[str]:
    out: List[str] = []
    while parents[state] is not None:
        state, label = parents[state]
        out.append(label)
    return out[::-1]


def _recipe(cfg: Config, schedule: List[str]) -> str:
    """Render the fault skeleton of an abstract schedule as a seeded
    Scenario replay recipe (transport/sim.py convention).  Message-
    level deliver/drop/dup choices are the adversarial part the seed +
    loss knobs approximate; the abstract schedule above is exact."""
    script: List[tuple] = []
    t, drop_p, dup_p = 1.0, 0.0, 0.0
    if cfg.start_cut:
        cut = sorted(cfg.start_cut)
        rest = sorted(set(range(3)) - set(cut))
        script.append((1.0, "partition", [cut, rest]))
        t = 4.0  # past the failure timeout: suspicion completes
    for ev in schedule:
        w = ev.split()
        if w[0] in ("kill", "restart"):
            script.append((round(t, 1), w[0], int(w[1])))
            t += 1.5
        elif w[0] == "partition":
            cut = sorted(int(x) for x in
                         ev[ev.index("{") + 1:ev.index("}")].split(","))
            rest = sorted(set(range(3)) - set(cut))
            script.append((round(t, 1), "partition", [cut, rest]))
            t += 1.5
        elif w[0] == "heal":
            script.append((round(t, 1), "heal"))
            t += 1.5
        elif w[0] == "drop":
            drop_p = 0.05
        elif w[0] == "dup":
            dup_p = 0.05
    return (f"Scenario(world_size=3, seed={cfg.seed}, duration=30.0, "
            f"script={script!r}, drop_p={drop_p}, dup_p={dup_p}).run()")


@dataclass
class Exploration:
    """Result of exhaustively exploring one configuration."""
    config: Config
    states: int = 0
    expanded: int = 0
    truncated: bool = False
    observed: Set[Tuple[str, str]] = field(default_factory=set)
    #: rule -> (schedule, detail)
    violations: Dict[str, Tuple[List[str], str]] = field(
        default_factory=dict)


def _det(x):
    """Hash-order-independent total sort key for model values: sets
    render as sorted tuples, None as the empty tuple.  Candidate
    selection and tie-breaking must NOT depend on set iteration order
    (str hashes are per-process randomized), or findings flake across
    runs."""
    if isinstance(x, (frozenset, set)):
        return tuple(sorted(_det(e) for e in x))
    if isinstance(x, tuple):
        return tuple(_det(e) for e in x)
    return () if x is None else x


def _explore(cfg: Config, facts: Facts, mutate: Sequence[str],
             rules: Sequence[str], max_states: int) -> Exploration:
    rules = tuple(r for r in rules if r in cfg.check)
    if cfg.max_states is not None:
        max_states = min(max_states, cfg.max_states)
    res = Exploration(cfg)
    root = (cfg.ranks, cfg.msgs, cfg.budgets,
            frozenset(cfg.start_cut) or None)
    parents: Dict[tuple, Optional[Tuple[tuple, str]]] = {root: None}
    depth = {root: 0}
    expanded: Set[tuple] = set()
    ff_edges: Dict[tuple, List[tuple]] = {}
    q = deque([root])

    def record(rule: str, sched: List[str], detail: str) -> None:
        if rule in rules and rule not in res.violations:
            res.violations[rule] = (sched, detail)

    if (msg := _m2_violation(root[0])):
        record("M2", [], msg)

    while q:
        if len(parents) >= max_states:
            res.truncated = True
            break
        s = q.popleft()
        if depth[s] >= MAX_DEPTH:
            res.truncated = True
            continue
        expanded.add(s)
        ffs: List[tuple] = []
        for (label, fault, ns, obs, viol) in _succs(s, facts, mutate,
                                                    cfg):
            if any(rk[R_EPOCH] > cfg.epoch_cap for rk in ns[0]):
                res.truncated = True
                continue
            res.observed |= obs
            new = ns not in parents
            if new:
                parents[ns] = (s, label)
                depth[ns] = depth[s] + 1
            here = lambda: _schedule(parents, s) + [label]
            bad = False
            for i, (old, nrk) in enumerate(zip(s[0], ns[0])):
                if old[R_INC] == nrk[R_INC] and \
                        nrk[R_EPOCH] < old[R_EPOCH]:
                    record("M1", here(),
                           f"rank {i} epoch went {old[R_EPOCH]} -> "
                           f"{nrk[R_EPOCH]} within incarnation "
                           f"{old[R_INC]}")
                    bad = True
            if viol is not None:
                record(viol[0], here(), viol[1])
                bad = True
            if new and not bad and (msg := _m2_violation(ns[0])):
                record("M2", here(), msg)
                bad = True
            if bad:
                continue  # violating states are not expanded further
            if not fault:
                ffs.append(ns)
            if new:
                q.append(ns)
        ff_edges[s] = ffs

    res.states = len(parents)
    res.expanded = len(expanded)

    if "M4" in rules and not res.violations:
        # A state is only reported wedged when its ENTIRE fault-free
        # closure was explored and contains no converged view: states
        # cut off by the depth / max-states frontier count as escapes
        # (optimistic — the bound is a search artifact, never evidence
        # of a wedge).  Epoch-cap-pruned successors are deliberately
        # NOT escapes: needing unbounded epoch growth to converge IS
        # the livelock class M4 exists to catch.
        conv = {st for st in parents if _converged(st)}
        unknown = {st for st in parents if st not in expanded}
        rev: Dict[tuple, List[tuple]] = {}
        for s, ffs in ff_edges.items():
            for ns in ffs:
                rev.setdefault(ns, []).append(s)
        can_reach = conv | unknown
        stack = list(can_reach)
        while stack:
            st = stack.pop()
            for p in rev.get(st, ()):
                if p not in can_reach:
                    can_reach.add(p)
                    stack.append(p)
        wedged = [s for s in expanded if s not in can_reach]
        if wedged:
            worst = min(wedged, key=lambda s: (depth[s], _det(s)))
            live = [f"{i}:{rk[R_ROLE]}(e{rk[R_EPOCH]})"
                    for i, rk in enumerate(worst[0])]
            record("M4", _schedule(parents, worst),
                   f"wedged state: no fault-free suffix reaches a "
                   f"converged view from [{', '.join(live)}] "
                   f"({len(wedged)} of {len(expanded)} expanded states "
                   f"wedged)")
        elif res.truncated:
            # The breadth-first frontier is optimistic, so a livelock
            # that lives DEEP (an epoch-climbing churn loop) hides
            # behind it.  Targeted probe: among states that reached
            # the cap's doorstep (max epoch >= cap-1), compute
            # fault-free closures directly — ordered by MINIMUM rank
            # epoch descending, because a closure's size is set by the
            # laggard's remaining climb headroom: when every rank is
            # near the cap the closure is small and CLOSES, and a
            # closed closure with no converged view is a proven wedge
            # regardless of the main-search truncation.
            cands = sorted(
                (s for s in expanded
                 if max(rk[R_EPOCH] for rk in s[0]) >= cfg.epoch_cap - 1),
                key=lambda s: (-min(rk[R_EPOCH] for rk in s[0]),
                               -depth[s], _det(s)))[:M4_PROBE_CANDIDATES]
            for cand in cands:
                closure = {cand}
                probe_q = deque([cand])
                closed, has_conv = True, _converged(cand)
                while probe_q:
                    if len(closure) > M4_PROBE_BUDGET:
                        closed = False  # unknown: never report
                        break
                    st = probe_q.popleft()
                    for (_l, fault, ns, _o, viol) in _succs(
                            st, facts, mutate, cfg):
                        if fault or viol is not None:
                            continue
                        if any(rk[R_EPOCH] > cfg.epoch_cap
                               for rk in ns[0]):
                            continue  # pessimistic: not an escape
                        if ns not in closure:
                            closure.add(ns)
                            probe_q.append(ns)
                            if _converged(ns):
                                has_conv = True
                if closed and not has_conv:
                    live = [f"{i}:{rk[R_ROLE]}(e{rk[R_EPOCH]})"
                            for i, rk in enumerate(cand[0])]
                    record(
                        "M4", _schedule(parents, cand),
                        f"wedged state: the fault-free closure "
                        f"({len(closure)} states) from "
                        f"[{', '.join(live)}] contains no converged "
                        f"view — every escape needs epoch growth "
                        f"beyond the cap ({cfg.epoch_cap}), the "
                        f"readmission-churn livelock class")
                    break
    return res


# ---------------------------------------------------------------------------
# Sim-backed mode: the REAL engines under forced interleavings
# ---------------------------------------------------------------------------

#: wall-clock budget for the sim-backed mode.  Exceeding it silently
#: stops BRANCHING (never fabricates findings) so the check.sh step
#: stays inside its hard timeout on slow machines.
SIM_WALL_BUDGET = 3.0
SIM_SEED = 7
SIM_BRANCH_DEPTH = 3
SIM_FANOUT = 3           # channel heads considered per branch point
SIM_DRAIN_STEPS = 1500   # post-branch fault-free drive bound


def _sim_explore() -> List[Finding]:
    """Drive the real ProgressEngine fleet through transport.sim's
    snapshot / force_step hooks: a kill-rejoin run whose first
    membership frames are branched over {deliver, drop, dup}, with
    shadow checks of M1 (engine epoch monotone per incarnation), M3
    (no duplicate pickups per incarnation) and a convergence drain
    (M4's sim-side shadow) at every leaf.  Only runs against this very
    checkout — the engines are imported, not read from --root."""
    import logging
    import time

    from rlo_tpu_torch.engine import EngineManager, ProgressEngine
    from rlo_tpu_torch.transport.sim import SimWorld
    from rlo_tpu_torch.wire import Tag

    # forced drops/kills make the engines log expected failure
    # detections; this is a checker, not an incident
    logging.getLogger("rlo_tpu_torch.engine").setLevel(logging.ERROR)

    t0 = time.monotonic()
    out: List[Finding] = []
    engine_kw = dict(failure_timeout=1.2, heartbeat_interval=0.4)

    world = SimWorld(3, seed=SIM_SEED, min_delay=0.01, max_delay=0.01)
    mgr = EngineManager()
    engines = [ProgressEngine(world.transport(r), manager=mgr,
                              clock=world.clock, **engine_kw)
               for r in range(3)]
    incarnation = [0, 0, 0]
    delivered: Dict[Tuple[int, int], List] = {}
    epoch_hi: Dict[Tuple[int, int], int] = {}
    recipe = (f"Scenario(world_size=3, seed={SIM_SEED}, duration=30.0, "
              f"script=[(2.0, 'kill', 1), (5.0, 'restart', 1)], "
              f"drop_p=0.0, dup_p=0.0, failure_timeout=1.2, "
              f"heartbeat_interval=0.4).run()")

    def shadow(path: str) -> bool:
        """Pump pickups + invariant shadows; True on new finding."""
        bad = False
        for r in range(3):
            if r in world.dead:
                continue
            e = engines[r]
            key = (r, incarnation[r])
            hi = epoch_hi.get(key, e.epoch)
            if e.epoch < hi:
                out.append(Finding(
                    "M1", ENGINE_PY, 1,
                    f"[sim kill-rejoin] rank {r} engine epoch went "
                    f"{hi} -> {e.epoch} within incarnation "
                    f"{incarnation[r]}; forced schedule: {path}; "
                    f"replay: {recipe}"))
                bad = True
            epoch_hi[key] = max(hi, e.epoch)
            got = delivered.setdefault(key, [])
            while (m := e.pickup_next()) is not None:
                if m.type != int(Tag.BCAST):
                    continue
                rec = (m.origin, bytes(m.data))
                if rec in got:
                    out.append(Finding(
                        "M3", ENGINE_PY, 1,
                        f"[sim kill-rejoin] rank {r} picked up "
                        f"broadcast {rec[1]!r} twice in incarnation "
                        f"{incarnation[r]}; forced schedule: {path}; "
                        f"replay: {recipe}"))
                    bad = True
                got.append(rec)
        return bad

    def drive(steps: int, path: str, until=None) -> bool:
        for _ in range(steps):
            world.step()
            mgr.progress_all()
            if shadow(path):
                return False
            if until is not None and until():
                return True
        return until is None

    def converged() -> bool:
        live = [r for r in range(3) if r not in world.dead]
        return all(sorted(engines[r]._alive) == sorted(live) and
                   not engines[r]._awaiting_welcome for r in live)

    # -- phase 1: bootstrap to a converged 3-rank fleet -------------------
    if not drive(800, "<warmup>", until=converged):
        if out:
            return out
        out.append(Finding(
            "M4", ENGINE_PY, 1,
            f"[sim kill-rejoin] fleet never bootstrapped to a "
            f"converged view in 800 sim steps; replay: {recipe}"))
        return out
    engines[0].bcast(b"rlo-model-m3-probe")
    drive(20, "<bcast>")

    # -- phase 2: kill rank 1, let the survivors detect it ----------------
    world.kill_rank(1)
    engines[1].cleanup()
    if not drive(600, "<detect>", until=lambda: all(
            1 not in engines[r]._alive for r in (0, 2))):
        if out:
            return out
        out.append(Finding(
            "M4", ENGINE_PY, 1,
            f"[sim kill-rejoin] survivors never detected the kill of "
            f"rank 1 in 600 sim steps; replay: {recipe}"))
        return out

    # -- phase 3: restart rank 1, branch over its rejoin frames -----------
    world.restart_rank(1)
    incarnation[1] = 1
    engines[1] = ProgressEngine(world.transport(1), manager=mgr,
                                clock=world.clock, incarnation=1,
                                **engine_kw)
    drive(5, "<rejoin>")

    def branch(depth: int, path: str) -> None:
        nonlocal world, mgr, engines, delivered, epoch_hi
        if out or time.monotonic() - t0 > SIM_WALL_BUDGET:
            return
        if depth == 0 or not world.pending_frames():
            drive(SIM_DRAIN_STEPS, path or "<none>", until=converged)
            if not converged() and not out:
                views = {r: sorted(engines[r]._alive)
                         for r in range(3) if r not in world.dead}
                out.append(Finding(
                    "M4", ENGINE_PY, 1,
                    f"[sim kill-rejoin] no convergence after the "
                    f"forced schedule [{path}] plus a "
                    f"{SIM_DRAIN_STEPS}-step fault-free drain "
                    f"(views: {views}); replay: {recipe}"))
            return
        heads = world.channel_heads()[:SIM_FANOUT]
        saved = (world, mgr, engines)
        # shadow state belongs to the timeline: restore per child
        saved_shadow = ({k: list(v) for k, v in delivered.items()},
                        dict(epoch_hi))
        for item in heads:
            for action in ("deliver", "drop", "dup"):
                if out or time.monotonic() - t0 > SIM_WALL_BUDGET:
                    break
                world, (mgr, engines) = \
                    saved[0].snapshot((saved[1], saved[2]))
                delivered = {k: list(v)
                             for k, v in saved_shadow[0].items()}
                epoch_hi = dict(saved_shadow[1])
                # re-locate the head in the CLONED queue (same key)
                t, ctr = item[0], item[1]
                citem = next(i for i in world.pending_frames()
                             if i[0] == t and i[1] == ctr)
                src, dst, tag = citem[2], citem[3], citem[4]
                world.force_step(citem, action)
                mgr.progress_all()
                shadow(path)
                branch(depth - 1,
                       f"{path} {action} {src}->{dst}/t{tag}".strip())
        world, mgr, engines = saved
        delivered = {k: list(v) for k, v in saved_shadow[0].items()}
        epoch_hi = dict(saved_shadow[1])

    branch(SIM_BRANCH_DEPTH, "")
    return out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _finding_anchor(rule: str, facts: Facts) -> Tuple[str, int]:
    """Anchor M-findings at the engine construct they implicate."""
    if rule == "M5":
        return ENGINE_PY, facts.py.stale_guard_line or 1
    if rule == "M4":
        return ENGINE_PY, facts.py.grace_line or 1
    if rule == "M2":
        return ENGINE_PY, facts.py.admit_count_line or 1
    return ENGINE_PY, 1


def run_model(root: Path, rules: Optional[Sequence[str]] = None,
              registry: Optional[AnchorRegistry] = None,
              mutate: Sequence[str] = (),
              configs: Optional[Sequence[str]] = None,
              max_states: int = DEFAULT_MAX_STATES,
              sim: bool = True) -> List[Finding]:
    """Run the selected rule families (default: all) against the tree
    at ``root``; returns findings sorted by file/line.  ``mutate``
    applies checker-side semantic mutations (test fixtures only);
    ``configs`` restricts the explored configurations; ``sim`` gates
    the real-engine mode (auto-skipped unless ``root`` is this very
    checkout)."""
    root = Path(root)
    rules = tuple(r.upper() for r in (rules or RULE_IDS))
    for r in rules:
        if r not in RULE_IDS:
            raise ModelError(f"unknown rule {r!r} (have "
                             f"{', '.join(RULE_IDS)})")
    for k in mutate:
        if k not in MUTATE_KNOBS:
            raise ModelError(f"unknown mutation knob {k!r} (have "
                             f"{', '.join(MUTATE_KNOBS)})")
    cfg_names = tuple(configs or CONFIG_NAMES)
    for c in cfg_names:
        if c not in CONFIG_NAMES:
            raise ModelError(f"unknown config {c!r} (have "
                             f"{', '.join(CONFIG_NAMES)})")

    py = _py_facts(root)
    c = _c_facts(root)
    facts = Facts(py, c)
    out: List[Finding] = []

    if "A2" in rules:
        for s in py.stray + c.stray:
            out.append(Finding(
                "A2", s.file, s.line,
                f"unmodeled transition: {s.handler} enters role "
                f"{s.role!r} but the checker's trigger map has no "
                f"entry for this handler — extraction drifted from "
                f"the code; teach rlo_model the new transition before "
                f"shipping it"))
        out.extend(_audit_anchors(root, py, registry))
        out.extend(_audit_anchors(root, c, registry))
        for tr, role in sorted((py.edges | c.edges) - EXPECTED_EDGES):
            out.append(Finding(
                "A2", ENGINE_PY, 1,
                f"unmodeled automaton edge {tr}->{role}: extracted "
                f"from the engines but absent from the checker's "
                f"alphabet — model drift; extend EXPECTED_EDGES and "
                f"the explorer"))
    if "A1" in rules:
        out.extend(_rule_a1(py, c))

    mrules = tuple(r for r in rules if r.startswith("M"))
    observed: Set[Tuple[str, str]] = set()
    explorations: List[Exploration] = []
    all_cfgs = _configs()
    if mrules:
        for name in cfg_names:
            res = _explore(all_cfgs[name], facts, mutate, mrules,
                           max_states)
            explorations.append(res)
            observed |= res.observed
            for rule in sorted(res.violations):
                sched, detail = res.violations[rule]
                file, line = _finding_anchor(rule, facts)
                out.append(Finding(
                    rule, file, line,
                    f"[{res.config.name}] invariant {rule} violated: "
                    f"{detail}; minimal schedule "
                    f"({len(sched)} events): "
                    f"{' -> '.join(sched) if sched else '<initial>'}; "
                    f"replay: {_recipe(res.config, sched)}"))

    # A2's coverage half: with the full config suite explored clean,
    # every extracted edge must have been observed (else dead code) —
    # suppressed when violations pruned the exploration or the config
    # set was restricted, where partial coverage is expected.
    if "A2" in rules and mrules and set(cfg_names) == set(CONFIG_NAMES) \
            and not any(e.violations for e in explorations):
        sites = {(s.trigger, s.role): s for s in c.sites}
        sites.update({(s.trigger, s.role): s for s in py.sites})
        for tr, role in sorted(
                ((py.edges | c.edges) & EXPECTED_EDGES) - observed):
            s = sites[(tr, role)]
            out.append(Finding(
                "A2", s.file, s.line,
                f"dead transition: edge {tr}->{role} "
                f"({s.handler}:{s.line}) is never reached in the "
                f"exhaustively explored configurations — dead code or "
                f"a config gap", severity="warning"))

    own_root = Path(__file__).resolve().parents[2]
    if sim and not mutate and mrules and root.resolve() == own_root:
        out.extend(f for f in _sim_explore() if f.rule in rules)

    out.sort(key=lambda f: (f.file, f.line, f.rule))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rlo_tpu_torch.tools.rlo_model",
        description="Exhaustive explicit-state model checker for the "
                    "membership/healing/IAR protocol with cross-engine "
                    "automaton extraction (docs/DESIGN.md §20).")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule families (default: all), "
                         "e.g. --rules M4,M5,A1")
    ap.add_argument("--config", default=None,
                    help="comma-separated configurations (default: all), "
                         f"from: {', '.join(CONFIG_NAMES)}")
    ap.add_argument("--mutate", default=None,
                    help="comma-separated checker-side mutation knobs "
                         "(test fixtures only): "
                         f"{', '.join(MUTATE_KNOBS)}")
    ap.add_argument("--max-states", type=int, default=DEFAULT_MAX_STATES,
                    help="state-count bound per configuration")
    ap.add_argument("--no-sim", action="store_true",
                    help="skip the real-engine sim-backed mode")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)
    split = lambda s: [x.strip() for x in s.split(",") if x.strip()]
    rules = ([r.upper() for r in split(args.rules)]
             if args.rules else None)
    try:
        findings = run_model(
            args.root, rules,
            mutate=tuple(split(args.mutate)) if args.mutate else (),
            configs=tuple(split(args.config)) if args.config else None,
            max_states=args.max_states, sim=not args.no_sim)
    except ToolError as e:
        print(f"rlo-model: error: {e}", file=sys.stderr)
        return 2
    return emit(findings, prog="rlo-model",
                ran=",".join(rules or RULE_IDS), root=args.root,
                as_json=args.json, quiet=args.quiet)


if __name__ == "__main__":
    sys.exit(main())
