"""Mutation parity of the port's static analyzers (rlo_tpu_torch/tools)
with the JAX package's: each mutation of tests/test_{lint,sentinel,
model,prover}.py is applied at the counterpart site of a copy of each
package, and the two tools' sets of (rule, message) must be equal once
the package name is taken out of the port's messages — and not empty,
but where the JAX test asserts silence. This file runs the rlo-lint and
rlo-prover cases; tests/test_torch_tools_parity_engines.py the
rlo-sentinel and rlo-model ones, on the same table.

A copy holds only the files the analyzers read (their path constants),
never a build product or the whole package.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]
ANALYZERS = ("runner", "csrc", "rlo_lint", "rlo_sentinel", "rlo_prover",
             "rlo_model")


def _read_files(pkg: str):
    """Every source file the package's analyzers name."""
    out = set()
    for mod in ANALYZERS:
        text = (REPO_ROOT / pkg / "tools" / f"{mod}.py").read_text()
        out.update(re.findall(rf'"({pkg}/[\w/]+\.(?:py|c|h|cu))"', text))
    return sorted(p for p in out if (REPO_ROOT / p).is_file())


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    out = {}
    for pkg in ("rlo_tpu", "rlo_tpu_torch"):
        base = tmp_path_factory.mktemp(f"base_{pkg}")
        for rel in _read_files(pkg):
            (base / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(REPO_ROOT / rel, base / rel)
        out[pkg] = base
    return out


@pytest.fixture()
def trees(bases, tmp_path):
    out = {}
    for pkg, base in bases.items():
        shutil.copytree(base, tmp_path / pkg)
        out[pkg] = tmp_path / pkg
    return out


def mutate(root: Path, rel: str, old: str, new: str) -> int:
    path = root / rel
    text = path.read_text()
    assert text.count(old) == 1, \
        f"fixture drift: {old!r} occurs {text.count(old)}x in {rel}"
    line = text[:text.index(old)].count("\n") + 1
    path.write_text(text.replace(old, new))
    return line


def append(root: Path, rel: str, text: str) -> None:
    path = root / rel
    path.write_text(path.read_text() + text)


def _tool(pkg: str, name: str):
    import importlib
    return importlib.import_module(f"{pkg}.tools.{name}")


def run(pkg: str, tool: str, root: Path, **kw):
    mod = _tool(pkg, tool)
    fn = {"rlo_lint": "run_lint", "rlo_sentinel": "run_sentinel",
          "rlo_prover": "run_prover", "rlo_model": "run_model"}[tool]
    return getattr(mod, fn)(root, **kw)


def _key(f):
    msg = f.msg.replace("rlo_tpu_torch", "rlo_tpu")
    return f.rule, msg



def _m(rel, old, new, port_old=None, port_new=None):
    """One edit at the counterpart site of both trees; ``rel`` is
    relative to the package."""
    return (rel, old, new, port_old if port_old is not None else old,
            port_new if port_new is not None else new)


def _a(rel, text):
    return (rel, None, text, None, text)


_RING_OLD = ("            kc = lax.ppermute(kc, axis, perm)\n"
             "            vc = lax.ppermute(vc, axis, perm)")
_RING_PORT = ("            kc = ppermute(kc, axis, perm)\n"
              "            vc = ppermute(vc, axis, perm)")

_FABRIC_GUARD = (
    "        if len(data) <= len(FABRIC_MAGIC):\n"
    "            # a magic-only (or truncated) frame: the caller's\n"
    "            # startswith(FABRIC_MAGIC) proves nothing about the kind\n"
    "            # byte existing — without this guard a 5-byte payload\n"
    "            # raises IndexError inside every rank's pump\n"
    "            # (rlo-sentinel S2, round 15)\n"
    "            self.metrics.counter(\"fabric.unknown_records\").inc()\n"
    "            return\n")

#: (id, tool, run kwargs, edits)
PARITY = [
    ("r1_wire_offset", "rlo_lint", {"rules": ["R1"]},
     [_m("wire.py", "SEQ_OFFSET = 12", "SEQ_OFFSET = 13")]),
    ("r1_tag_value", "rlo_lint", {"rules": ["R1"]},
     [_m("wire.py", "HEARTBEAT = 11", "HEARTBEAT = 42")]),
    ("r1_deleted_error_constant", "rlo_lint", {"rules": ["R1"]},
     [_m("native/bindings.py", "ERR_STALL = -15\n", "")]),
    ("r1_fanout", "rlo_lint", {"rules": ["R1"]},
     [_m("native/bindings.py", "FANOUT_FLAT = 1", "FANOUT_FLAT = 2")]),
    ("r1_span_ctx_size", "rlo_lint", {"rules": ["R1"]},
     [_m("wire.py", "SPAN_CTX_SIZE = 23", "SPAN_CTX_SIZE = 24")]),
    ("r1_span_magic", "rlo_lint", {"rules": ["R1"]},
     [_m("wire.py", 'SPAN_MAGIC = b"RLOS', 'SPAN_MAGIC = b"RLOX')]),
    ("r1_span_event_id", "rlo_lint", {"rules": ["R1"]},
     [_m("utils/tracing.py", "SPAN = 15", "SPAN = 99")]),
    ("r2_counter_key", "rlo_lint", {"rules": ["R2"]},
     [_m("utils/metrics.py", '"epoch", "epoch_quarantined", "rejoins",',
         '"epoch", "epoch_quarantined",')]),
    ("r2_phase_key", "rlo_lint", {"rules": ["R2"]},
     [_m("utils/metrics.py",
         '"frame_encode", "frame_decode", "send", "arq_scan", '
         '"tag_dispatch",',
         '"frame_encode", "frame_decode", "send", "tag_dispatch",')]),
    ("r2_phobs_key", "rlo_lint", {"rules": ["R2"]},
     [_m("engine.py", 'self._phobs("arq_scan", t0)',
         'self._phobs("arq_scanz", t0)')]),
    ("r2_heal_counter", "rlo_lint", {"rules": ["R2"]},
     [_m("utils/metrics.py",
         '"epoch_syncs", "reflood_skipped", "batched_admits",',
         '"epoch_syncs", "batched_admits",')]),
    ("r2_telem_key", "rlo_lint", {"rules": ["R2"]},
     [_m("wire.py",
         '"q_wait", "pickup_backlog", "pages_in_use", "pages_free",',
         '"q_wait", "pickup_backlog", "pages_in_use",')]),
    ("r2_coll_key", "rlo_lint", {"rules": ["R2"]},
     [_m("wire.py", '"coll_steps", "coll_bytes",', '"coll_steps",')]),
    ("r2_remedy_key", "rlo_lint", {"rules": ["R2"]},
     [_m("wire.py", '"remedies_proposed", "remedies_executed",',
         '"remedies_proposed",')]),
    ("r2_telem_header", "rlo_lint", {"rules": ["R2"]},
     [_m("wire.py", "TELEM_HEADER_SIZE = 26", "TELEM_HEADER_SIZE = 27")]),
    ("r3_missing_binding", "rlo_lint", {"rules": ["R3"]},
     [_m("native/bindings.py",
         '    sig("rlo_engine_set_fanout", C.c_int, [p, C.c_int])\n', "")]),
    ("r3_missing_batched_binding", "rlo_lint", {"rules": ["R3"]},
     [_m("native/bindings.py",
         '    sig("rlo_engine_progress_n", C.c_int64,'
         '  # rlo-sentinel: gil-released\n'
         '        [p, C.c_int64, C.c_uint64])\n', "")]),
    ("r3_64bit_truncation", "rlo_lint", {"rules": ["R3"]},
     [_m("native/bindings.py", 'sig("rlo_now_usec", C.c_uint64, [])',
         'sig("rlo_now_usec", C.c_int, [])')]),
    ("r4_dispatch_hole", "rlo_lint", {"rules": ["R4"]},
     [_m("engine.py", "elif tag == Tag.ABORT:", "elif tag == Tag.BARRIER:")]),
    ("r4_deleted_membership_handler", "rlo_lint", {"rules": ["R4"]},
     [_m("engine.py", "                elif tag == Tag.JOIN_WELCOME:\n"
         "                    self._on_welcome(msg)\n", "")]),
    ("r4_fabric_record_hole", "rlo_lint", {"rules": ["R4"]},
     [_m("serving/fabric.py", "elif kind == Rec.LOAD:", "elif False:")]),
    ("r4_remedy_record_hole", "rlo_lint", {"rules": ["R4"]},
     [_m("serving/fabric.py", "elif kind == Rec.QUARANTINE:",
         "elif False:")]),
    ("r4_msync_subkind_hole", "rlo_lint", {"rules": ["R4"]},
     [_m("engine.py", "elif kind == MSYNC_AD:", "elif False:"),
      _m("native/rlo_engine.c", "} else if (kind == RLO_MSYNC_WANT) {",
         "} else if (0) {")]),
] + [
    (f"r5_{rel.split('/')[-1][:-3]}_{what}", "rlo_lint", {"rules": ["R5"]},
     [_a(rel, f"\nimport {mod}\n_T0 = {mod}.{what}()\n")])
    for rel, mod, what in (("serving/fabric.py", "time", "time"),
                           ("serving/pages.py", "time", "time"),
                           ("workloads/traces.py", "time", "time"),
                           ("workloads/weather.py", "random", "random"),
                           ("observe/telemetry.py", "time", "time"),
                           ("transport/sim.py", "time", "time"))
] + [
    ("r5_anchor_suppresses", "rlo_lint", {"rules": ["R5"]},
     [_a("transport/sim.py",
         "\nimport time\n_T0 = time.time()  # rlo-lint: allow-wallclock\n")]),
    ("s0_stale_anchor", "rlo_sentinel", {"rules": ["S0"]},
     [_a("engine.py", "\n# rlo-lint: allow-wallclock\n_ZZ = 1\n")]),
    ("s0_detached_transfers", "rlo_sentinel", {},
     [_m("native/rlo_engine.c",
         "/* rlo-sentinel: transfers(rt) — the retransmit queue owns it */",
         "/* rlo-sentinel: transfers(zzz) — renamed param, stale fact */")]),
    ("s1_global_write", "rlo_sentinel", {"rules": ["S1"]},
     [_m("native/rlo_engine.c",
         "int64_t rlo_engine_progress_budget(rlo_engine *e, "
         "int64_t max_frames)\n{\n    int64_t polled = 0;",
         "static int64_t dbg_turns;\n"
         "int64_t rlo_engine_progress_budget(rlo_engine *e, "
         "int64_t max_frames)\n{\n    int64_t polled = 0;\n"
         "    dbg_turns++;")]),
    ("s1_guarded_by_suppresses", "rlo_sentinel", {"rules": ["S0", "S1"]},
     [_m("native/rlo_engine.c",
         "int64_t rlo_engine_progress_budget(rlo_engine *e, "
         "int64_t max_frames)\n{\n    int64_t polled = 0;",
         "/* rlo-sentinel: guarded-by(dbg_mu) */\n"
         "static int64_t dbg_turns;\n"
         "int64_t rlo_engine_progress_budget(rlo_engine *e, "
         "int64_t max_frames)\n{\n    int64_t polled = 0;\n"
         "    dbg_turns++;")]),
    ("s2_unvalidated_shm_record", "rlo_sentinel", {"rules": ["S2"]},
     [_m("native/rlo_shm.c",
         "            if (rec.len < 0 ||\n"
         "                rec.len > cap - (int64_t)sizeof(shm_rec) ||\n"
         "                rec.size != rec_size(rec.len) ||\n"
         "                rec.src != src) {\n"
         "                atomic_store(&w->hdr->abort_flag, 1);\n"
         "                return RLO_ERR_PROTO;\n"
         "            }\n", "")]),
    ("s2_unguarded_fabric_index", "rlo_sentinel", {"rules": ["S2"]},
     [_m("serving/fabric.py", _FABRIC_GUARD, "",
         _FABRIC_GUARD.replace(", round 15", ""), "")]),
    ("s2_msync_count_py", "rlo_sentinel", {"rules": ["S2"]},
     [_m("engine.py", "        if n < 0 or len(p) < 9 + 12 * n:\n"
         "            return\n", "")]),
    ("s2_msync_count_c", "rlo_sentinel", {"rules": ["S2"]},
     [_m("native/rlo_engine.c",
         "    if (n < 0 || plen < 9 + 12 * (int64_t)n)\n"
         "        return;\n", "")]),
    ("s2_span_trailer", "rlo_sentinel", {"rules": ["S2"]},
     [_m("wire.py", "    if len(raw) - off < SPAN_CTX_SIZE or \\",
         "    if False or \\")]),
    ("s2_span_field_index", "rlo_sentinel", {"rules": ["S2"]},
     [_m("native/rlo_engine.c",
         "        if (rlo_span_decode(m->payload + m->len - "
         "RLO_SPAN_CTX_SIZE,\n"
         "                            RLO_SPAN_CTX_SIZE, &gw, &sq, "
         "&st, &fl,\n"
         "                            0) >= 0)\n"
         "            rlo_trace_emit(e->rank, RLO_EV_SPAN, st, -1, "
         "sq, gw);\n",
         "        rlo_span_decode(m->payload + m->len - "
         "RLO_SPAN_CTX_SIZE,\n"
         "                        RLO_SPAN_CTX_SIZE, &gw, &sq, &st, "
         "&fl, 0);\n"
         "        rlo_trace_emit(e->rank, RLO_EV_SPAN, "
         "span_kind[st], -1, sq, gw);\n")]),
    ("s3_pool_leak", "rlo_sentinel", {"rules": ["S3"]},
     [_m("native/rlo_engine.c",
         "            if (!stamped) {\n"
         "                rlo_pool_free(rt);\n"
         "                return RLO_ERR_NOMEM;\n"
         "            }",
         "            if (!stamped)\n"
         "                return RLO_ERR_NOMEM;")]),
    ("s4_done_to_idle_c", "rlo_sentinel", {"rules": ["S4"]},
     [_m("native/rlo_engine.c",
         "    p->pid = -1;\n    p->vote = 1;\n"
         "    p->state = RLO_INVALID;\n}",
         "    p->pid = -1;\n    p->vote = 1;\n"
         "    if (p->state == RLO_COMPLETED)\n"
         "        p->state = RLO_INVALID;\n"
         "    p->state = RLO_INVALID;\n}")]),
    ("s4_done_to_idle_py", "rlo_sentinel", {"rules": ["S4"]},
     [_m("engine.py",
         "        p = self.my_own_proposal\n"
         "        if p.state == ReqState.IN_PROGRESS and "
         "p.decision_pending:",
         "        p = self.my_own_proposal\n"
         "        if p.state == ReqState.COMPLETED:\n"
         "            p.state = ReqState.INVALID\n"
         "        if p.state == ReqState.IN_PROGRESS and "
         "p.decision_pending:")]),
    ("s4_cross_engine_divergence", "rlo_sentinel", {"rules": ["S4"]},
     [_m("engine.py",
         "                p.state = ReqState.COMPLETED\n"
         "                p.decision_pending = False",
         "                p.state = ReqState.IN_PROGRESS\n"
         "                p.decision_pending = False")]),
    ("m5_stale_rsp_guard", "rlo_model", {"configs": ["sync-crossfire"]},
     [_m("engine.py", "            if stale:",
         "            if stale and False:")]),
    ("m4_joiner_grace", "rlo_model",
     {"rules": ["M4"], "configs": ["kill-rejoin"], "max_states": 40_000},
     [_m("engine.py",
         "        self._hb_seen[joiner] = self.clock() + max(\n"
         "            2 * (self.failure_timeout or 0.0), "
         "10 * self.join_interval)",
         "        self._hb_seen[joiner] = self.clock()")]),
    ("a1_unbatched_admissions", "rlo_model", {"rules": ["A1"]},
     [_m("engine.py", '"<ii", new_epoch, len(batch))',
         '"<ii", new_epoch, 1)')]),
    ("m1_sync_downgrade_knob", "rlo_model",
     {"mutate": ("m1-sync-downgrade",), "configs": ["sync-crossfire"]},
     []),
    ("m2_skewed_decision_knob", "rlo_model",
     {"mutate": ("m2-skewed-decision",), "configs": ["kill-rejoin"]}, []),
    ("m3_no_dedup_knob", "rlo_model",
     {"mutate": ("m3-no-dedup",), "configs": ["kill-rejoin"]}, []),
    ("p1_dst_collision", "rlo_prover", {"rules": ["P1"]},
     [_m("topology.py", "(((r + origin) % world_size), "
         "((r + step + origin) % world_size))",
         "(((r + origin) % world_size), "
         "((step + origin) % world_size))")]),
    ("p2_dropped_contribution", "rlo_prover", {"rules": ["P2"]},
     [_m("topology.py",
         "        rounds.append(xor_perm(world_size, 1 << i))",
         "        rounds.append(xor_perm(world_size, 1 << i)[:-1])")]),
    ("p2_chunk_misalignment", "rlo_prover", {"rules": ["P2"]},
     [_m("topology.py", "    return (rank - step) % world_size",
         "    return (rank - step - 1) % world_size")]),
    ("p4_hardcoded_axis", "rlo_prover", {"rules": ["P4"]},
     [_m("ops/ring_attention.py", _RING_OLD,
         _RING_OLD.replace("(kc, axis", '(kc, "ring"'), _RING_PORT,
         _RING_PORT.replace("(kc, axis", '(kc, "ring"'))]),
    ("p4_axis_ok_suppresses", "rlo_sentinel", {"rules": ["S0"]},
     [_m("ops/ring_attention.py", _RING_OLD,
         "            # rlo-prover: axis-ok fixture-sanctioned\n" +
         _RING_OLD.replace("(kc, axis", '(kc, "ring"'), _RING_PORT,
         "            # rlo-prover: axis-ok fixture-sanctioned\n" +
         _RING_PORT.replace("(kc, axis", '(kc, "ring"'))]),
    ("p5_page_size", "rlo_prover", {"rules": ["P5"]},
     [_m("models/serve.py", "paged: bool = False, page_size: int = 128,",
         "paged: bool = False, page_size: int = 64,")]),
    ("s0_stale_prover_anchor", "rlo_sentinel", {"rules": ["S0"]},
     [_m("ops/ring_attention.py", "    ws = lax.axis_size(axis)\n",
         "    # rlo-prover: axis-ok suppresses nothing here\n"
         "    ws = lax.axis_size(axis)\n",
         "    ws, idx = axis.size, axis.index\n",
         "    # rlo-prover: axis-ok suppresses nothing here\n"
         "    ws, idx = axis.size, axis.index\n")]),
]

#: mutations after which the JAX tests assert silence, not a finding
_SILENT = {"r5_anchor_suppresses", "s1_guarded_by_suppresses",
           "p4_axis_ok_suppresses"}


def check_parity(trees, case) -> None:
    cid, tool, kw, edits = case
    got = {}
    for pkg, root in trees.items():
        for rel, old, new, port_old, port_new in edits:
            o, n = (old, new) if pkg == "rlo_tpu" else (port_old, port_new)
            if o is None:
                append(root, f"{pkg}/{rel}", n)
            else:
                mutate(root, f"{pkg}/{rel}", o, n)
        got[pkg] = {_key(f) for f in run(pkg, tool, root, **kw)}
    assert got["rlo_tpu_torch"] == got["rlo_tpu"]
    assert bool(got["rlo_tpu"]) == (cid not in _SILENT), got["rlo_tpu"]




LINT_PROVER = [c for c in PARITY if c[1] in ("rlo_lint", "rlo_prover")]


@pytest.mark.parametrize("case", LINT_PROVER,
                         ids=[c[0] for c in LINT_PROVER])
def test_mutation_parity(trees, case):
    check_parity(trees, case)
