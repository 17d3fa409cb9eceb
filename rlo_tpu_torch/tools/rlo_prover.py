"""rlo-prover — symbolic collective-schedule verifier + device-layer
geometry lint, for the port.

The port's counterpart of ``rlo_tpu/tools/rlo_prover.py``: the same
rule IDs, CLI, ``--json`` schema and exit codes, pointed at
``rlo_tpu_torch/``. rlo-lint (docs/DESIGN.md §9) pins host-side
surface parity and rlo-sentinel (§15) checks the host/C engines' flow
properties; both leave the DEVICE layer — the precomputed
``ppermute`` schedules in ``rlo_tpu_torch/topology.py`` and
``ops/device_collectives.py`` and the CUDA launch geometry in
``rlo_tpu_torch/kernels/csrc/`` — unanalyzed. rlo-prover closes that
gap: it proves, statically and without importing torch or touching a
device, that every committed schedule is a valid permutation program
that delivers/reduces correctly, and that every kernel launch in the
package is geometrically legal on an H100. Rule catalogue:

  P1 permutation validity — enumerate every committed schedule
     generator (binomial/skip-ring bcast for every origin; ring /
     recursive-doubling / halving-doubling allreduce; ring/halving
     reduce_scatter; ring/doubling all_gather) for all n <= 64 and
     prove each step's (src, dst) pairs form a valid partial
     permutation (no src appears twice — ``Axis.ppermute`` cannot
     multicast — no dst collisions, every rank in [0, n)).
  P2 delivery/reduction correctness — a symbolic token algebra over
     the same sweep: broadcast ends with every rank holding the
     origin's token; allreduce ends with every rank's contribution
     set equal to exactly-one-contribution-per-rank (bitmask union
     with overlap detection, so double-counts AND drops are caught);
     reduce_scatter/all_gather shard coverage is exact and in index
     order; chunk identities are tracked end to end so a send/recv
     index misalignment is flagged at the step it happens; and step
     counts are pinned against the documented bounds (binomial =
     ceil(log2 n) rounds, skip-ring <= 2*ceil(log2 n), ring = 2(n-1)
     chunk steps, recursive doubling = log2 n, halving-doubling =
     2 log2 n) so an accidentally-degraded schedule fails
     mechanically.
  P3 CUDA launch geometry — the counterpart of the Pallas rule. Every
     ``kernel<<<grid, threads, smem, stream>>>`` in
     ``kernels/csrc/{reduce,flash,decode}.cu`` is lifted from the
     token stream (``csrc.tokenize``) together with the declarations,
     ``if``/``if constexpr`` branches and ``cudaFuncSetAttribute``
     calls that reach it, and its grid, threads and dynamic shared
     memory are evaluated by a small evaluator of the C++ integer
     expressions the sources use (constants, ``constexpr`` functions,
     template structs' static members, casts, ``sizeof``) under the
     committed bindings of ``P3_PROBES`` (the main path's shapes, the
     counterparts of the JAX tool's probes and one hostile set).
     Checks: threads <= 1024 and a multiple of 32; dynamic shared
     memory <= 232,448 bytes (227 KB, H100's opt-in ceiling); a launch
     above 48 KB is preceded by a ``cudaFuncSetAttribute(...
     MaxDynamicSharedMemorySize ...)`` of the same kernel
     instantiation at no smaller size; grid.x < 2^31, grid.y and
     grid.z <= 65,535; every launch site is grounded by some probe.
     And, statically over the kernel bodies: every position, slot or
     page id that K6–K11 read from a device tensor (``BOUNDS_READS``)
     is compared with its bound from below and above before any value
     derived from it forms an address. A compare may drop the write or
     clamp it: the port drops what the reference clamps (ROADMAP's
     "Quirks of the reference"), and the rule asks for the compare,
     not for either policy.
  P4 axis discipline — an ``Axis`` handed to ``ppermute`` /
     ``all_reduce`` / ``all_gather`` / ``all_to_all`` (as a method
     receiver), or to the ``device_collectives`` and ``autodiff``
     wrappers, must flow from a parameter: never a literal group name
     and never a module-level ``Axis`` global. A module that itself
     builds the mesh (``parallel/mesh.py``, ``backend.py``) may use
     exactly the names it binds via ``LocalMesh``/``dist_mesh_axes``;
     ``# rlo-prover: axis-ok`` sanctions a deliberate exception.
  P5 host/device constant pinning — ``kernels/decode.py``'s
     ``BLOCK_K`` equals decode.cu's ``BK`` (128), ``SPLIT_K`` is a
     positive multiple of it (the entry's ``split_k % BK`` gate),
     ``MAX_BLOCK_T`` is 128; ``serving/pages.py`` ``NULL_PAGE == 0``
     agrees with ``models/paged.py``'s inactive-slot mask (page ->
     NULL_PAGE, offset -> ``ps``) and with the 0 that decode.cu's page
     clamps send an id below range to; the ``page_size`` default of
     128 (``models/serve.py``) keeps every cache dtype on decode.cu's
     16-byte vector gates. Pinned sites carry a
     ``rlo-prover: lane-pinned`` anchor (``#`` in Python, ``//`` in
     CUDA) consumed by this rule (the S0 stale-anchor audit covers
     the namespace).

Usage:
  python -m rlo_tpu_torch.tools.rlo_prover [--root DIR] [--rules P1,P3]
                                           [--json] [-q]

Exit codes: 0 clean, 1 findings, 2 bad invocation / unparseable
inputs. Soundness caveats: P3 proves geometry for the committed
bindings in ``P3_PROBES``, not for all shapes. A launch inside a chunk
loop (K2–K5 over heads, K6/K9 over row tiles, K8/K11 over (row, head)
blocks, at most 65,535 a launch) is checked at the loop's first
iteration, its largest chunk; the hostile set goes past 65,535 (heads
65,536 and 70,001, nb·H 65,536 and 70,001, K6 at 65,536 · 256 + 1
positions, whose entry widens the split). P1/P2
verify the schedule *generators*, not the executed program
(tests/test_torch_tools_static.py's oracle cross-check pins the
symbolic model to ``ops/device_collectives.py`` on a CPU
``LocalMesh``); the bounds check is flow-insensitive (a compare
anywhere before the first address counts).
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import itertools
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from rlo_tpu_torch.tools import csrc
from rlo_tpu_torch.tools.runner import (AnchorRegistry, Finding, ToolError,
                                        emit, find_anchor)

RULE_IDS = ("P1", "P2", "P3", "P4", "P5")

#: schedule sweep bound (every generator, every origin where relevant)
N_MAX = 64

TOPOLOGY_PY = "rlo_tpu_torch/topology.py"
REDUCE_CU = "rlo_tpu_torch/kernels/csrc/reduce.cu"
FLASH_CU = "rlo_tpu_torch/kernels/csrc/flash.cu"
DECODE_CU = "rlo_tpu_torch/kernels/csrc/decode.cu"
KERNEL_SOURCES = (REDUCE_CU, FLASH_CU, DECODE_CU)
#: per-rank modules whose collective axes must be parameters (the
#: counterparts of the JAX tool's P4_FILES)
P4_FILES = ("rlo_tpu_torch/ops/device_collectives.py",
            "rlo_tpu_torch/ops/ring_attention.py",
            "rlo_tpu_torch/ops/ulysses.py",
            "rlo_tpu_torch/models/transformer.py",
            "rlo_tpu_torch/models/moe.py",
            "rlo_tpu_torch/models/pipeline.py",
            "rlo_tpu_torch/models/generate.py",
            "rlo_tpu_torch/parallel/consensus.py",
            "rlo_tpu_torch/backend.py")
SERVE_PY = "rlo_tpu_torch/models/serve.py"
PAGED_PY = "rlo_tpu_torch/models/paged.py"
PAGES_PY = "rlo_tpu_torch/serving/pages.py"
DECODE_PY = "rlo_tpu_torch/kernels/decode.py"

#: the page/tile width every P5 site must agree on
LANE = 128
#: the 16-byte vector of decode.cu's cp.async and uint4 paths
VEC_BYTES = 16

AXIS_OK_ANCHOR = "rlo-prover: axis-ok"
LANE_PINNED_ANCHOR = "rlo-prover: lane-pinned"


class ProverError(ToolError):
    """Unrecoverable analyzer failure (missing input, unparseable
    source) — exit code 2, distinct from findings."""


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

@dataclass
class PyMod:
    path: str
    raw: str
    lines: List[str]
    tree: ast.Module


def _read(root: Path, rel: str) -> str:
    try:
        return (root / rel).read_text()
    except OSError as e:
        raise ProverError(f"cannot read {rel}: {e}")


def _parse_py(root: Path, rel: str) -> PyMod:
    raw = _read(root, rel)
    try:
        tree = ast.parse(raw, filename=rel)
    except SyntaxError as e:
        raise ProverError(f"cannot parse {rel}: {e}")
    return PyMod(path=rel, raw=raw, lines=raw.splitlines(), tree=tree)


_topo_seq = itertools.count()


def load_topology(root: Path):
    """Import ``<root>/rlo_tpu_torch/topology.py`` by path under a
    unique module name, so mutated fixture trees analyze THEIR
    schedules, not this checkout's. topology.py is stdlib-pure."""
    path = Path(root) / TOPOLOGY_PY
    if not path.exists():
        raise ProverError(f"{TOPOLOGY_PY} not found under {root}")
    name = f"_rlo_prover_topology_{next(_topo_seq)}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclass decorators resolve the module
    try:
        spec.loader.exec_module(mod)
    except Exception as e:
        raise ProverError(f"cannot load {TOPOLOGY_PY}: {e}")
    finally:
        sys.modules.pop(name, None)
    return mod


class ProverContext:
    def __init__(self, root: Path, registry: AnchorRegistry):
        self.root = root
        self.registry = registry
        self.py: Dict[str, PyMod] = {}
        self.cu: Dict[str, "CuFile"] = {}
        self._topo: object = None
        #: def-line cache for findings anchored at generator functions
        self.topo_lines: Dict[str, int] = {}

    @property
    def topo(self):
        """Loaded lazily: only P1/P2 execute topology.py. The
        source-only rules (P3–P5 — and through them the rlo-sentinel
        S0 consumption run) stay decoupled from its runtime behavior,
        so a topology.py that fails to import breaks the schedule
        rules, not every analyzer that shares the runner."""
        if self._topo is None:
            self._topo = load_topology(self.root)
        return self._topo

    def mod(self, rel: str) -> PyMod:
        if rel not in self.py:
            self.py[rel] = _parse_py(self.root, rel)
        return self.py[rel]

    def cuda(self, rel: str) -> "CuFile":
        if rel not in self.cu:
            self.cu[rel] = CuFile(rel, _read(self.root, rel))
        return self.cu[rel]

    def topo_line(self, fn_name: str) -> int:
        if not self.topo_lines:
            for node in self.mod(TOPOLOGY_PY).tree.body:
                if isinstance(node, ast.FunctionDef):
                    self.topo_lines[node.name] = node.lineno
        return self.topo_lines.get(fn_name, 1)


def build_context(root: Path,
                  registry: Optional[AnchorRegistry] = None
                  ) -> ProverContext:
    return ProverContext(
        Path(root).resolve(),
        registry if registry is not None else AnchorRegistry())


# ---------------------------------------------------------------------------
# P1 — permutation validity
# ---------------------------------------------------------------------------

def _check_perm(f: List[Finding], ctx: ProverContext, gen: str,
                pairs: Sequence[Tuple[int, int]], n: int,
                what: str) -> bool:
    """One ppermute step's (src, dst) pairs against the
    CollectivePermute contract.  Returns True when valid."""
    line = ctx.topo_line(gen)
    ok = True
    srcs: Set[int] = set()
    dsts: Set[int] = set()
    for src, dst in pairs:
        if not (0 <= src < n and 0 <= dst < n):
            f.append(Finding("P1", TOPOLOGY_PY, line,
                             f"{what}: edge ({src}, {dst}) out of rank "
                             f"range [0, {n})"))
            ok = False
        if src in srcs:
            f.append(Finding("P1", TOPOLOGY_PY, line,
                             f"{what}: src {src} appears twice — "
                             f"CollectivePermute cannot multicast"))
            ok = False
        if dst in dsts:
            f.append(Finding("P1", TOPOLOGY_PY, line,
                             f"{what}: dst {dst} collision — two "
                             f"sources deliver into one rank in a "
                             f"single permute"))
            ok = False
        srcs.add(src)
        dsts.add(dst)
    return ok


def _bcast_schedules(ctx: ProverContext):
    """(generator-name, n, origin, rounds) for both bcast families
    over the full sweep."""
    t = ctx.topo
    for n in range(2, N_MAX + 1):
        for origin in range(n):
            for gen in ("binomial_bcast_schedule",
                        "skip_ring_bcast_schedule"):
                try:
                    sched = getattr(t, gen)(n, origin)
                except Exception as e:
                    yield gen, n, origin, None, e
                    continue
                yield gen, n, origin, sched.rounds, None


def rule_p1(ctx: ProverContext) -> List[Finding]:
    f: List[Finding] = []
    t = ctx.topo
    seen_bad: Set[str] = set()  # one finding per (gen, defect) class
    per_gen: Dict[str, int] = {}

    def once(key: str, finding: Finding) -> None:
        gen_key = key.split("/", 1)[0]
        if key in seen_bad or per_gen.get(gen_key, 0) >= 10:
            return
        seen_bad.add(key)
        per_gen[gen_key] = per_gen.get(gen_key, 0) + 1
        f.append(finding)

    for gen, n, origin, rounds, err in _bcast_schedules(ctx):
        if err is not None:
            once(f"{gen}/raise", Finding(
                "P1", TOPOLOGY_PY, ctx.topo_line(gen),
                f"{gen}(n={n}, origin={origin}) raised: {err}"))
            continue
        sub: List[Finding] = []
        for i, rnd in enumerate(rounds):
            _check_perm(sub, ctx, gen, rnd, n,
                        f"{gen}(n={n}, origin={origin}) round {i}")
        for fnd in sub:
            once(f"{gen}/{fnd.msg.split(':')[-1][:40]}", fnd)

    def gen(name: str, fn, *args):
        """One generator call; a raise is a P1 finding (the schedule
        cannot be built), never a prover crash — mutated fixture
        trees are a supported input."""
        try:
            return fn(*args)
        except Exception as e:
            once(f"{name}/raise", Finding(
                "P1", TOPOLOGY_PY, ctx.topo_line(name),
                f"{name}{args} raised: {e}"))
            return None

    def checked(gname: str, pairs, n: int, what: str) -> bool:
        """_check_perm funneled through the per-generator once() cap
        (same flood control the bcast path uses)."""
        sub: List[Finding] = []
        ok = _check_perm(sub, ctx, gname, pairs, n, what)
        for fnd in sub:
            once(f"{gname}/{fnd.msg.split(':')[-1][:40]}", fnd)
        return ok

    for n in range(2, N_MAX + 1):
        for off in (1, -1):
            pairs = gen("ring_perm", t.ring_perm, n, off)
            if pairs is not None:
                checked("ring_perm", pairs, n,
                        f"ring_perm(n={n}, offset={off})")
        if gen("is_power_of_2", t.is_power_of_2, n):
            rounds = gen("recursive_doubling_rounds",
                         t.recursive_doubling_rounds, n)
            for i, rnd in enumerate(rounds or ()):
                checked("recursive_doubling_rounds", rnd, n,
                        f"recursive_doubling_rounds(n={n}) round {i}")
            dists = gen("halving_doubling_distances",
                        t.halving_doubling_distances, n)
            for dist in dists or ():
                pairs = gen("xor_perm", t.xor_perm, n, dist)
                if pairs is None:
                    continue
                if checked("xor_perm", pairs, n,
                           f"xor_perm(n={n}, dist={dist})"):
                    # the halving/doubling phases rely on the exchange
                    # being an involution: both directions in one call
                    m = dict(pairs)
                    for a, b in pairs:
                        if m.get(b) != a:
                            once(f"xor_perm/involution", Finding(
                                "P1", TOPOLOGY_PY,
                                ctx.topo_line("xor_perm"),
                                f"xor_perm(n={n}, dist={dist}) is not "
                                f"self-inverse: {a}->{b} but {b}->"
                                f"{m.get(b)}"))
                            break
    return f


# ---------------------------------------------------------------------------
# P2 — delivery / reduction correctness (symbolic token algebra)
# ---------------------------------------------------------------------------

def simulate_bcast(rounds: Sequence[Sequence[Tuple[int, int]]],
                   n: int) -> List[int]:
    """Token state after executing ``rounds`` with the exact per-round
    semantics of ``tpu_collectives.rootless_bcast``: every dst of a
    round unconditionally takes what its src held BEFORE the round.
    Rank r starts holding token r; broadcast is correct iff the final
    state is [origin] * n."""
    tok = list(range(n))
    for rnd in rounds:
        old = list(tok)
        for src, dst in rnd:
            tok[dst] = old[src]
    return tok


def simulate_ring_allreduce(n: int, topo) -> Tuple[
        List[List[int]], List[str]]:
    """Symbolic ring allreduce (reduce-scatter + all-gather) driven by
    the SAME schedule functions the implementation uses
    (``ring_perm``, ``ring_reduce_scatter_chunk``).  State is one
    contribution bitmask per (rank, chunk); merges detect overlap
    (double-count) mechanically.  Returns (final gathered masks per
    rank per chunk, defect strings)."""
    defects: List[str] = []
    full = (1 << n) - 1
    state = [[1 << r for _ in range(n)] for r in range(n)]
    perm = dict(topo.ring_perm(n, 1))  # src -> dst
    recv_from = {d: s for s, d in perm.items()}
    if sorted(recv_from) != list(range(n)):
        # P1 reports the malformed permutation itself; the token
        # algebra cannot run a ring where some rank receives nothing
        defects.append(
            f"ring_perm(n={n}) is not a complete permutation "
            f"(receivers {sorted(recv_from)}) — delivery simulation "
            f"aborted")
        return [], defects
    for s in range(n - 1):
        old = [row[:] for row in state]
        for r in range(n):
            src = recv_from[r]
            send_idx = topo.ring_reduce_scatter_chunk(n, src, s)
            recv_idx = (r - s - 1) % n
            if send_idx != recv_idx:
                defects.append(
                    f"ring RS step {s}: rank {src} sends chunk "
                    f"{send_idx} but rank {r} accumulates into chunk "
                    f"{recv_idx} — chunk misalignment")
                continue
            if old[src][send_idx] & old[r][recv_idx]:
                defects.append(
                    f"ring RS step {s}: merging chunk {recv_idx} at "
                    f"rank {r} double-counts contributions "
                    f"{old[src][send_idx] & old[r][recv_idx]:#x}")
            state[r][recv_idx] = old[r][recv_idx] | old[src][send_idx]
    for r in range(n):
        own = (r + 1) % n
        if state[r][own] != full:
            defects.append(
                f"ring RS: rank {r} owns chunk {own} with "
                f"contributions {state[r][own]:#x}, expected all "
                f"{n} ranks — dropped contribution")
    # all-gather: rank r carries (chunk_idx, mask), rotates n-1 steps
    out: List[List[Optional[int]]] = [[None] * n for _ in range(n)]
    carry = [((r + 1) % n, state[r][(r + 1) % n]) for r in range(n)]
    for r in range(n):
        out[r][carry[r][0]] = carry[r][1]
    for s in range(n - 1):
        old_c = list(carry)
        for r in range(n):
            idx, mask = old_c[recv_from[r]]
            arr_idx = (r - s) % n
            if idx != arr_idx:
                defects.append(
                    f"ring AG step {s}: rank {r} files arriving chunk "
                    f"{idx} under index {arr_idx}")
            out[r][idx] = mask
            carry[r] = (idx, mask)
    gathered = [[m if m is not None else 0 for m in row] for row in out]
    return gathered, defects


def simulate_rd_allreduce(n: int, topo) -> Tuple[List[int], List[str]]:
    """Recursive doubling: full-vector masks, one exchange per round."""
    defects: List[str] = []
    acc = [1 << r for r in range(n)]
    rounds = topo.recursive_doubling_rounds(n)
    if len(rounds) != n.bit_length() - 1:
        defects.append(
            f"recursive doubling at n={n}: {len(rounds)} rounds, "
            f"documented bound is log2(n) = {n.bit_length() - 1}")
    for i, rnd in enumerate(rounds):
        m = dict(rnd)
        old = list(acc)
        for r in range(n):
            if r not in m:
                defects.append(
                    f"recursive doubling round {i}: rank {r} has no "
                    f"partner — its contribution is dropped from the "
                    f"other subcube")
                continue
            p = m[r]
            if old[r] & old[p]:
                defects.append(
                    f"recursive doubling round {i}: ranks {r}<->{p} "
                    f"merge overlapping contribution sets — "
                    f"double-count")
            acc[r] = old[r] | old[p]
    return acc, defects


def simulate_halving_reduce_scatter(n: int, topo) -> Tuple[
        List[Tuple[int, int]], List[str]]:
    """Recursive-halving reduce-scatter: per rank a shrinking run of
    (global chunk, mask) rows.  Returns each rank's final (chunk,
    mask) and defect strings."""
    defects: List[str] = []
    rows = {r: [(c, 1 << r) for c in range(n)] for r in range(n)}
    dists = list(topo.halving_doubling_distances(n))
    if dists != [n >> k for k in range(1, n.bit_length())]:
        defects.append(
            f"halving_doubling_distances(n={n}) = {dists}, expected "
            f"{[n >> k for k in range(1, n.bit_length())]} — the "
            f"log2(n)-round bound is broken")
    for dist in dists:
        new = {}
        for r in range(n):
            p = r ^ dist
            cur, pcur = rows[r], rows[p]
            if len(cur) != 2 * dist:
                defects.append(
                    f"halving RS dist {dist}: rank {r} holds "
                    f"{len(cur)} rows, expected {2 * dist}")
                return [], defects
            upper = (r & dist) != 0
            keep = cur[dist:] if upper else cur[:dist]
            # partner sends the half of ITS range that my subtree owns
            psend = pcur[dist:] if upper else pcur[:dist]
            merged = []
            for (c1, m1), (c2, m2) in zip(keep, psend):
                if c1 != c2:
                    defects.append(
                        f"halving RS dist {dist}: rank {r} combines "
                        f"chunk {c1} with partner chunk {c2} — "
                        f"misaligned exchange")
                if m1 & m2:
                    defects.append(
                        f"halving RS dist {dist}: rank {r} chunk {c1} "
                        f"double-counts {m1 & m2:#x}")
                merged.append((c1, m1 | m2))
            new[r] = merged
        rows = new
    out = []
    for r in range(n):
        if len(rows[r]) != 1:
            defects.append(f"halving RS: rank {r} ends with "
                           f"{len(rows[r])} chunks, expected 1")
            out.append((-1, 0))
        else:
            out.append(rows[r][0])
    return out, defects


def simulate_doubling_all_gather(n: int, start: List[Tuple[int, int]],
                                 topo) -> Tuple[List[List[int]],
                                                List[str]]:
    """Recursive-doubling all-gather from per-rank (chunk, mask)."""
    defects: List[str] = []
    out: List[List[Optional[Tuple[int, int]]]] = \
        [[None] * n for _ in range(n)]
    for r, (c, m) in enumerate(start):
        if 0 <= c < n:
            out[r][c] = (c, m)
    for dist in reversed(list(topo.halving_doubling_distances(n))):
        snapshot = [list(row) for row in out]
        for r in range(n):
            p = r ^ dist
            # partner's assembled block of `dist` rows lands at my
            # block start XOR dist (== the partner's block start)
            p_start = (p // dist) * dist
            blk = snapshot[p][p_start:p_start + dist]
            dst = (r // dist) * dist ^ dist
            for i, cell in enumerate(blk):
                if cell is None:
                    defects.append(
                        f"doubling AG dist {dist}: rank {r} receives "
                        f"an unassembled slot from rank {p}")
                    continue
                out[r][dst + i] = cell
    final = []
    for r in range(n):
        row = []
        for c in range(n):
            cell = out[r][c]
            if cell is None:
                defects.append(
                    f"doubling AG: rank {r} slot {c} never filled")
                row.append(0)
            elif cell[0] != c:
                defects.append(
                    f"doubling AG: rank {r} slot {c} holds chunk "
                    f"{cell[0]} — out of index order")
                row.append(0)
            else:
                row.append(cell[1])
        final.append(row)
    return final, defects


def simulate_ring_all_gather(n: int, topo) -> Tuple[List[List[int]],
                                                    List[str]]:
    """Ring all-gather from rank r holding chunk r (tokens, not
    masks): n-1 forwarding steps on ring_perm(+1)."""
    defects: List[str] = []
    recv_from = {d: s for s, d in topo.ring_perm(n, 1)}
    if sorted(recv_from) != list(range(n)):
        defects.append(
            f"ring_perm(n={n}) is not a complete permutation — "
            f"all-gather simulation aborted (P1 has the root cause)")
        return [], defects
    out: List[List[Optional[int]]] = [[None] * n for _ in range(n)]
    carry = list(range(n))
    for r in range(n):
        out[r][r] = r
    for s in range(n - 1):
        old = list(carry)
        for r in range(n):
            got = old[recv_from[r]]
            arr = (r - s - 1) % n
            if got != arr:
                defects.append(
                    f"ring AG step {s}: rank {r} files chunk {got} "
                    f"under index {arr}")
            out[r][arr] = got
            carry[r] = got
    for r in range(n):
        for c in range(n):
            if out[r][c] != c:
                defects.append(f"ring AG: rank {r} slot {c} holds "
                               f"{out[r][c]}")
    return [[m if m is not None else -1 for m in row] for row in out], \
        defects


def rule_p2(ctx: ProverContext) -> List[Finding]:
    f: List[Finding] = []
    t = ctx.topo
    seen: Set[str] = set()
    per_gen: Dict[str, int] = {}

    def once(gen: str, n: int, msg: str) -> None:
        # dedup exact repeats AND cap per generator: a broken
        # generator fails at every (n, step, rank) — ten findings
        # localize it, fifty thousand bury it
        key = f"{gen}/{msg[:60]}"
        if key in seen or per_gen.get(gen, 0) >= 10:
            return
        seen.add(key)
        per_gen[gen] = per_gen.get(gen, 0) + 1
        f.append(Finding("P2", TOPOLOGY_PY, ctx.topo_line(gen),
                         f"{gen} at n={n}: {msg}"))

    # --- broadcast delivery + round pins ---
    bounds = {"binomial_bcast_schedule":
              lambda n: math.ceil(math.log2(n)),
              "skip_ring_bcast_schedule":
              lambda n: 2 * math.ceil(math.log2(n))}
    exact = {"binomial_bcast_schedule"}
    for gen, n, origin, rounds, err in _bcast_schedules(ctx):
        if err is not None:
            continue  # P1 already reported the raise
        tok = simulate_bcast(rounds, n)
        bad = [r for r in range(n) if tok[r] != origin]
        if bad:
            once(gen, n,
                 f"origin {origin}: ranks {bad[:6]} end holding "
                 f"tokens {[tok[r] for r in bad[:6]]}, not the "
                 f"origin's — broadcast does not deliver")
        bound = bounds[gen](n)
        if gen in exact and len(rounds) != bound:
            once(gen, n,
                 f"origin {origin}: {len(rounds)} rounds, pinned to "
                 f"exactly ceil(log2 n) = {bound}")
        elif len(rounds) > bound:
            once(gen, n,
                 f"origin {origin}: {len(rounds)} rounds exceeds the "
                 f"pinned bound {bound} — schedule degraded")

    def sim(gen: str, n: int, fn, *args):
        """One simulator run; a raise inside the schedule functions it
        drives is a P2 finding, never a prover crash (the bcast
        generators get the same treatment in _bcast_schedules)."""
        try:
            return fn(*args)
        except Exception as e:
            once(gen, n, f"simulation raised: {e}")
            return None

    # --- allreduce / reduce_scatter / all_gather token algebra ---
    full = lambda n: (1 << n) - 1  # noqa: E731
    for n in range(2, N_MAX + 1):
        res = sim("ring_reduce_scatter_chunk", n,
                  simulate_ring_allreduce, n, t)
        if res is not None:
            gathered, defects = res
            for d in defects:
                once("ring_reduce_scatter_chunk", n, d)
            if not defects:
                for r in range(n):
                    if any(m != full(n) for m in gathered[r]):
                        once("ring_reduce_scatter_chunk", n,
                             f"rank {r} gathered masks "
                             f"{[hex(m) for m in gathered[r]]} != all-"
                             f"ones — allreduce incomplete")
                        break
        # reduce_scatter 'ring': post-RS rotate puts chunk r on rank r
        # (structural consequence of the simulated ownership (r+1));
        # checked via the ownership the simulator derived above.
        res = sim("ring_perm", n, simulate_ring_all_gather, n, t)
        for d in (res[1] if res is not None else ()):
            once("ring_perm", n, d)
        if not sim("is_power_of_2", n, t.is_power_of_2, n):
            continue
        res = sim("recursive_doubling_rounds", n,
                  simulate_rd_allreduce, n, t)
        if res is not None:
            acc, defects = res
            for d in defects:
                once("recursive_doubling_rounds", n, d)
            if not defects and any(a != full(n) for a in acc):
                once("recursive_doubling_rounds", n,
                     f"final contribution sets "
                     f"{[hex(a) for a in acc[:4]]}... incomplete")
        res = sim("halving_doubling_distances", n,
                  simulate_halving_reduce_scatter, n, t)
        if res is not None:
            owned, defects = res
            for d in defects:
                once("halving_doubling_distances", n, d)
            if not defects:
                for r, (c, m) in enumerate(owned):
                    if c != r or m != full(n):
                        once("halving_doubling_distances", n,
                             f"rank {r} ends owning chunk {c} with "
                             f"mask {m:#x}, expected chunk {r} with "
                             f"every contribution")
                        break
                res = sim("halving_doubling_distances", n,
                          simulate_doubling_all_gather, n, owned, t)
                if res is not None:
                    final, ag_d = res
                    for d in ag_d:
                        once("halving_doubling_distances", n, d)
                    if not ag_d:
                        for r in range(n):
                            if any(m != full(n) for m in final[r]):
                                once("halving_doubling_distances", n,
                                     f"rank {r} reassembles "
                                     f"incomplete chunks after the "
                                     f"doubling AG")
                                break
    return f



# ---------------------------------------------------------------------------
# P3 — CUDA launch geometry (a small evaluator over the .cu token stream)
# ---------------------------------------------------------------------------
#
# A .cu file is read as tokens (``csrc.tokenize`` over the comment- and
# preprocessor-stripped text). Its namespace-scope ``constexpr``
# constants, ``using`` aliases, enums, template variables, functions
# and structs are indexed; each function body is parsed into a tree of
# statements (blocks, ``if``/``else``, loops, simple statements) far
# enough to know, at every launch, which declarations, branch
# conditions and ``cudaFuncSetAttribute`` calls reach it. Expressions
# are parsed by precedence climbing into tuples and evaluated on demand
# under a probe's bindings; anything outside the modelled fragment
# raises ``_EvalError`` and becomes a finding — an unprovable launch is
# a maintenance bug, not a pass.

#: H100 (compute capability 9.0) launch limits
MAX_THREADS = 1024
WARP = 32
MAX_DYN_SMEM = 227 * 1024     # the opt-in ceiling per block
DEFAULT_SMEM = 48 * 1024      # above it a launch needs the opt-in
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
#: streaming multiprocessors of an H100 SXM (reduce.cu's sm_count())
SM_COUNT = 132

_SET_ATTR = "cudaFuncSetAttribute"
_SMEM_ATTR = "cudaFuncAttributeMaxDynamicSharedMemorySize"


class _EvalError(Exception):
    pass


@dataclass(frozen=True)
class Ty:
    """A C++ type as a value (a template argument, a sizeof operand)."""
    name: str


#: sizes of the scalar types the sources name (canonical names)
_TYPE_SIZES = {"float": 4, "double": 8, "int": 4, "unsigned": 4,
               "bool": 1, "char": 1, "__nv_bfloat16": 2, "int8_t": 1,
               "uint8_t": 1, "int16_t": 2, "uint16_t": 2, "int32_t": 4,
               "uint32_t": 4, "int64_t": 8, "uint64_t": 8, "size_t": 8,
               "long": 8, "uintptr_t": 8, "cudaError_t": 4}
#: integer casts: (bits, signed)
_INT_CASTS = {"int": (32, True), "int32_t": (32, True),
              "unsigned": (32, False), "uint32_t": (32, False),
              "long": (64, True), "int64_t": (64, True),
              "size_t": (64, False), "uint64_t": (64, False),
              "uintptr_t": (64, False)}
_TYPE_WORDS = set(_TYPE_SIZES) | {"const", "signed", "short", "void"}
_INT_SUFFIX = {"u", "U", "l", "L", "ul", "UL", "lu", "LU", "ll", "LL",
               "ull", "ULL", "llu", "LLU"}

_BIN_PREC = {"||": 1, "&&": 2, "|": 3, "^": 4, "&": 5, "==": 6, "!=": 6,
             "<": 7, "<=": 7, ">": 7, ">=": 7, "<<": 8, ">>": 8,
             "+": 9, "-": 9, "*": 10, "/": 10, "%": 10}


def _strip_cpp(text: str) -> str:
    """Comments and preprocessor lines to spaces, newlines kept."""
    out = []
    for line in csrc.strip_comments(text).split("\n"):
        out.append(" " * len(line) if line.lstrip().startswith("#")
                   else line)
    return "\n".join(out)


def _text(toks) -> str:
    return "".join(t[1] for t in toks)


def _split_commas(toks) -> List[list]:
    """Split at commas outside (), [] and {}."""
    out, cur, depth = [], [], 0
    for t in toks:
        v = t[1]
        if v in "([{":
            depth += 1
        elif v in ")]}":
            depth -= 1
        if v == "," and depth == 0:
            out.append(cur)
            cur = []
        else:
            cur.append(t)
    if cur or out:
        out.append(cur)
    return out


class _Parser:
    """Precedence climbing over a token slice; ``templates`` names
    the identifiers whose ``<`` opens a template argument list."""

    def __init__(self, toks, templates: Set[str]):
        self.toks = list(toks)
        self.i = 0
        self.templates = templates

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.toks[j][1] if j < len(self.toks) else ""

    def take(self, want: Optional[str] = None) -> str:
        v = self.peek()
        if want is not None and v != want:
            raise _EvalError(f"expected {want!r}, got {v!r} in "
                             f"{_text(self.toks)!r}")
        self.i += 1
        return v

    def parse_all(self):
        node = self.expr()
        if self.i != len(self.toks):
            raise _EvalError(f"trailing tokens in {_text(self.toks)!r}")
        return node

    def expr(self, no_gt: bool = False):
        """A full expression; ``no_gt`` stops at a bare '>' (the end of
        a template argument list)."""
        cond = self.binary(1, no_gt)
        if self.peek() == "?":
            self.take()
            a = self.expr(no_gt)
            self.take(":")
            b = self.expr(no_gt)
            return ("tern", cond, a, b)
        return cond

    def binary(self, min_prec: int, no_gt: bool):
        lhs = self.unary(no_gt)
        while True:
            op = self.peek()
            prec = _BIN_PREC.get(op)
            if prec is None or prec < min_prec or \
                    (no_gt and op in (">", ">>", ">=")):
                return lhs
            self.take()
            rhs = self.binary(prec + 1, no_gt)
            lhs = ("bin", op, lhs, rhs)

    def _is_type_group(self) -> bool:
        """At '(': is the parenthesized group a type (a C cast)?"""
        j, words = self.i + 1, 0
        while j < len(self.toks) and self.toks[j][1] != ")":
            v = self.toks[j][1]
            if v not in _TYPE_WORDS and v != "*" and v not in ("bf16",):
                return False
            words += 1
            j += 1
        return words > 0

    def unary(self, no_gt: bool):
        v = self.peek()
        if v in ("-", "+", "!", "~"):
            self.take()
            return ("un", v, self.unary(no_gt))
        if v == "(":
            if self._is_type_group():
                self.take()
                words = []
                while self.peek() != ")":
                    words.append(self.take())
                self.take(")")
                return ("cast", _cast_name(words), self.unary(no_gt))
            self.take()
            node = self.expr()
            self.take(")")
            return self.postfix(node)
        if v == "sizeof":
            self.take()
            self.take("(")
            j = self.i
            depth = 0
            while True:
                t = self.toks[j][1]
                if t == "(":
                    depth += 1
                elif t == ")":
                    if depth == 0:
                        break
                    depth -= 1
                j += 1
            inner = self.toks[self.i:j]
            self.i = j + 1
            if all(t[1] in _TYPE_WORDS or t[1] == "*" for t in inner):
                return ("sizeof", ("type", _cast_name(
                    [t[1] for t in inner])))
            return ("sizeof", _Parser(inner, self.templates).parse_all())
        return self.postfix(self.primary(no_gt))

    def primary(self, no_gt: bool):
        kind, v, _line = self.toks[self.i] if self.i < len(self.toks) \
            else ("", "", 0)
        if kind == "num":
            self.take()
            while self.peek() in _INT_SUFFIX:
                self.take()
            lit = v.rstrip("uUlL")
            if lit.lower().startswith("0x"):
                return ("num", int(lit, 16))
            if any(c in lit for c in ".eE") or lit.endswith(("f", "F")):
                return ("num", float(lit.rstrip("fF")))
            return ("num", int(lit))
        if kind != "id":
            raise _EvalError(f"unexpected {v!r} in {_text(self.toks)!r}")
        self.take()
        if v == "std" and self.peek() == ":" and self.peek(1) == ":":
            self.take()
            self.take()
            name = self.take()
            if name != "is_same":
                raise _EvalError(f"std::{name} is not modelled")
            args = self.targs()
            self.take(":")
            self.take(":")
            self.take("value")
            return ("same", args[0], args[1])
        if v in ("static_cast", "reinterpret_cast") and self.peek() == "<":
            self.take()
            words = []
            while self.peek() != ">":
                words.append(self.take())
            self.take(">")
            self.take("(")
            node = self.expr()
            self.take(")")
            if v == "reinterpret_cast":
                raise _EvalError("reinterpret_cast is not modelled")
            return ("cast", _cast_name(words), node)
        if v in self.templates and self.peek() == "<":
            targs = self.targs()
            if self.peek() == "(":
                return ("call", v, targs, self.call_args())
            if self.peek() == ":" and self.peek(1) == ":":
                self.take()
                self.take()
                return ("smember", v, targs, self.take())
            return ("tvar", v, targs)
        if self.peek() == "(":
            return ("call", v, [], self.call_args())
        return ("name", v)

    def targs(self) -> list:
        self.take("<")
        out = []
        while self.peek() != ">":
            out.append(self.expr(no_gt=True))
            if self.peek() == ",":
                self.take()
        self.take(">")
        return out

    def call_args(self) -> list:
        self.take("(")
        out = []
        while self.peek() != ")":
            out.append(self.expr())
            if self.peek() == ",":
                self.take()
        self.take(")")
        return out

    def postfix(self, node):
        while self.peek() == "." and self.i + 1 < len(self.toks):
            self.take()
            node = ("member", node, self.take())
        return node


def _cast_name(words: Sequence[str]) -> str:
    ws = [w for w in words if w not in ("const", "signed")]
    if "*" in ws:
        return "pointer"
    if ws == ["long", "long"]:
        return "long"
    return " ".join(ws)


def _parse_expr(toks, templates: Set[str]):
    return _Parser(toks, templates).parse_all()


def _c_div(a: int, b: int) -> int:
    if b == 0:
        raise _EvalError("division by zero")
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _wrap(v: int, bits: int, signed: bool) -> int:
    v &= (1 << bits) - 1
    if signed and v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


# -- statements --------------------------------------------------------------

@dataclass
class CStmt:
    """kind: 'block' (body), 'if' (cond toks, then, else), 'loop'
    (body), 'simple' (toks, ending before its ';')."""
    kind: str
    toks: list = field(default_factory=list)
    body: list = field(default_factory=list)
    then: Optional["CStmt"] = None
    other: Optional["CStmt"] = None


def _parse_stmts(toks, lo: int, hi: int) -> List[CStmt]:
    out = []
    i = lo
    while i < hi:
        st, i = _parse_stmt(toks, i, hi)
        if st is not None:
            out.append(st)
    return out


def _parse_stmt(toks, i: int, hi: int):
    v = toks[i][1]
    if v == "{":
        j = csrc.match_paren(toks, i)
        return CStmt("block", body=_parse_stmts(toks, i + 1, j)), j + 1
    if v == ";":
        return None, i + 1
    if v == "if":
        j = i + 1
        if toks[j][1] == "constexpr":
            j += 1
        cl = csrc.match_paren(toks, j)
        then, k = _parse_stmt(toks, cl + 1, hi)
        other = None
        if k < hi and toks[k][1] == "else":
            other, k = _parse_stmt(toks, k + 1, hi)
        return CStmt("if", toks=toks[j + 1:cl], then=then,
                     other=other), k
    if v in ("for", "while", "switch"):
        cl = csrc.match_paren(toks, i + 1)
        body, k = _parse_stmt(toks, cl + 1, hi)
        return CStmt("loop", toks=toks[i + 2:cl],
                     body=[body] if body else []), k
    if v == "do":
        body, k = _parse_stmt(toks, i + 1, hi)
        while k < hi and toks[k][1] != ";":
            k += 1
        return CStmt("loop", body=[body] if body else []), k + 1
    # simple statement: to the ';' outside (), [] and {}
    depth, j = 0, i
    while j < hi:
        t = toks[j][1]
        if t in "([{":
            depth += 1
        elif t in ")]}":
            depth -= 1
        elif t == ";" and depth == 0:
            break
        j += 1
    return CStmt("simple", toks=toks[i:j]), j + 1


def _declarators(stmt_toks) -> List[Tuple[str, list, bool]]:
    """(name, value tokens, is_dim3) of each declarator or assignment
    in a simple statement: ``T a = x, b = y``, ``a.f = x``, ``dim3
    g(x, y)``, ``x += y`` (value ``x + y``)."""
    toks = list(stmt_toks)
    if not toks or toks[0][1] in ("using", "return", "typedef"):
        return []
    words = [t[1] for t in toks]
    if "dim3" in words[:3] and "=" not in words:
        start = words.index("dim3") + 1
        out = []
        for part in _split_commas(toks[start:]):
            if len(part) >= 3 and part[0][0] == "id" and \
                    part[1][1] == "(" and part[-1][1] == ")":
                out.append((part[0][1], part[2:-1], True))
        return out
    out = []
    for part in _declarator_parts(toks):
        depth = 0
        for k, t in enumerate(part):
            if t[1] in "([{":
                depth += 1
            elif t[1] in ")]}":
                depth -= 1
            elif t[1] == "=" and depth == 0:
                lhs, rhs = part[:k], part[k + 1:]
                op = None
                if lhs and lhs[-1][1] in ("+", "-", "*", "/", "%", "|",
                                          "&", "^"):
                    op, lhs = lhs[-1], lhs[:-1]
                if lhs and lhs[-1][1] == "]":       # an array store
                    lhs = lhs[:_open_of(lhs, len(lhs) - 1)]
                if not lhs or lhs[-1][0] != "id":
                    break
                name = lhs[-1][1]
                if len(lhs) >= 3 and lhs[-2][1] == "." and \
                        lhs[-3][0] == "id":
                    name = f"{lhs[-3][1]}.{name}"
                if op is not None:
                    rhs = [("id", name, op[2]), op, ("punct", "(", op[2])] \
                        + rhs + [("punct", ")", op[2])]
                out.append((name, rhs, False))
                break
    return out


def _open_of(toks, close: int) -> int:
    """Index of the opener matching the closer at ``close``."""
    depth = 0
    for k in range(close, -1, -1):
        if toks[k][1] in ")]}":
            depth += 1
        elif toks[k][1] in "([{":
            depth -= 1
            if depth == 0:
                return k
    raise _EvalError("unbalanced brackets")


def _declarator_parts(toks) -> List[list]:
    """A statement cut at the commas that start a new declarator
    (``, name =``): a template's own commas (``Plan<C, HD>``) stay."""
    out, cur, depth = [], [], 0
    for k, t in enumerate(toks):
        v = t[1]
        if v in "([{":
            depth += 1
        elif v in ")]}":
            depth -= 1
        if v == "," and depth == 0 and k + 2 < len(toks) and \
                toks[k + 1][0] == "id" and toks[k + 2][1] == "=":
            out.append(cur)
            cur = []
        else:
            cur.append(t)
    out.append(cur)
    return out


def _set_attr_calls(toks, helpers: Dict[str, Tuple[int, int]]):
    """(kernel text, value tokens, line) of every opt-in of dynamic
    shared memory in a token run: ``cudaFuncSetAttribute(K,
    cudaFuncAttributeMaxDynamicSharedMemorySize, V)`` or a call of a
    helper that makes that call with two of its parameters."""
    out = []
    for i, t in enumerate(toks):
        name = t[1]
        if t[0] != "id" or i + 1 >= len(toks) or toks[i + 1][1] != "(":
            continue
        if name != _SET_ATTR and name not in helpers:
            continue
        cl = csrc.match_paren(toks, i + 1)
        args = _split_commas(toks[i + 2:cl])
        if name == _SET_ATTR:
            if len(args) == 3 and _text(args[1]) == _SMEM_ATTR:
                out.append((_text(args[0]), args[2], t[2]))
        else:
            k, v = helpers[name]
            if len(args) > max(k, v):
                out.append((_text(args[k]), args[v], t[2]))
    return out


# -- the file model ----------------------------------------------------------

@dataclass
class CFn:
    name: str
    tparams: List[str]
    params: List[str]
    toks: list            # body tokens, braces excluded
    line: int
    _stmts: Optional[List[CStmt]] = None

    @property
    def stmts(self) -> List[CStmt]:
        if self._stmts is None:
            self._stmts = _parse_stmts(self.toks, 0, len(self.toks))
        return self._stmts


@dataclass
class CStruct:
    name: str
    tparams: List[str]
    members: Dict[str, list]   # static constexpr name -> value tokens


@dataclass
class LaunchSite:
    file: str
    fn: str
    line: int
    kernel: str               # the launched expression's text
    args: List[list]          # grid, threads[, smem[, stream]] tokens
    conds: List[Tuple[list, bool]]
    scope: Dict[str, tuple]   # name -> (value tokens, scope before, dim3)
    set_attrs: List[Tuple[str, list, dict, int]]


def _names_of_params(toks) -> List[str]:
    out = []
    for part in _split_commas(toks):
        ids = [t[1] for t in part if t[0] == "id"]
        if ids:
            out.append(ids[-1])
    return out


class CuFile:
    """Namespace-scope index of one .cu file plus its launch sites."""

    def __init__(self, path: str, raw: str):
        self.path = path
        self.raw = raw
        self.lines = raw.splitlines()
        self.toks = csrc.tokenize(_strip_cpp(raw))
        self.consts: Dict[str, list] = {}
        self.aliases: Dict[str, str] = {}
        self.tvars: Dict[str, Tuple[List[str], list]] = {}
        self.fns: Dict[str, CFn] = {}
        self.structs: Dict[str, CStruct] = {}
        self._index()
        self.templates = ({n for n, f in self.fns.items() if f.tparams} |
                          {n for n, s in self.structs.items()
                           if s.tparams} | set(self.tvars))
        self.helpers = self._smem_helpers()
        self._memo: Dict[str, object] = {}

    # ---- indexing ----------------------------------------------------------
    def _index(self) -> None:
        toks = self.toks
        i, start, n = 0, 0, len(toks)
        while i < n:
            v = toks[i][1]
            if v == ";":
                self._top_statement(toks[start:i])
                start = i + 1
            elif v == "{":
                head = toks[start:i]
                words = [t[1] for t in head]
                if words[:1] == ["namespace"] or \
                        words[:2] == ["extern", '"C"'] and len(words) == 2:
                    start = i + 1       # transparent scope
                    i += 1
                    continue
                j = csrc.match_paren(toks, i)
                self._top_block(head, i, j)
                i = j + 1
                # a struct/enum definition ends in '};'
                if i < n and toks[i][1] == ";":
                    i += 1
                start = i
                continue
            elif v == "}":
                start = i + 1           # the end of a transparent scope
            i += 1

    @staticmethod
    def _template_prefix(head) -> Tuple[List[str], list]:
        if head and head[0][1] == "template" and len(head) > 1 and \
                head[1][1] == "<":
            depth = 0
            for k in range(1, len(head)):
                if head[k][1] == "<":
                    depth += 1
                elif head[k][1] == ">":
                    depth -= 1
                    if depth == 0:
                        return _names_of_params(head[2:k]), head[k + 1:]
        return [], head

    def _top_statement(self, stmt) -> None:
        tparams, rest = self._template_prefix(stmt)
        words = [t[1] for t in rest]
        if words[:1] == ["using"] and len(words) >= 4 and words[2] == "=":
            self.aliases[words[1]] = " ".join(words[3:])
            return
        if "constexpr" in words and "=" in words and "(" not in \
                words[:words.index("=")]:
            eq = words.index("=")
            name = words[eq - 1]
            if tparams:
                self.tvars[name] = (tparams, rest[eq + 1:])
            else:
                self.consts[name] = rest[eq + 1:]

    def _top_block(self, head, lo: int, hi: int) -> None:
        tparams, rest = self._template_prefix(head)
        words = [t[1] for t in rest]
        body = self.toks[lo + 1:hi]
        if "enum" in words:
            val = 0
            for part in _split_commas(body):
                if not part:
                    continue
                if len(part) >= 3 and part[1][1] == "=":
                    val = self._eval(_parse_expr(part[2:], set()), {})
                self.consts[part[0][1]] = [("num", str(val), part[0][2])]
                val += 1
            return
        if words and words[0] in ("struct", "class") and "(" not in words:
            name = words[1]
            if name in self.structs:
                return           # a specialization: the primary wins
            members: Dict[str, list] = {}
            for st in _split_top(body):
                sw = [t[1] for t in st]
                if "static" in sw and "constexpr" in sw and "=" in sw:
                    eq = sw.index("=")
                    members[sw[eq - 1]] = st[eq + 1:]
            self.structs[name] = CStruct(name, tparams, members)
            return
        if rest and rest[-1][1] in (")", "const"):
            end = len(rest) - 1 if rest[-1][1] == ")" else len(rest) - 2
            # the parameter list: match back from its ')'
            depth = 0
            for k in range(end, -1, -1):
                if rest[k][1] == ")":
                    depth += 1
                elif rest[k][1] == "(":
                    depth -= 1
                    if depth == 0:
                        break
            if k >= 1 and rest[k - 1][0] == "id":
                name = rest[k - 1][1]
                self.fns.setdefault(name, CFn(
                    name, tparams, _names_of_params(rest[k + 1:end]),
                    body, rest[k - 1][2]))

    def _smem_helpers(self) -> Dict[str, Tuple[int, int]]:
        """Functions that opt a kernel parameter into a shared-memory
        size parameter: name -> (kernel arg index, size arg index)."""
        out: Dict[str, Tuple[int, int]] = {}
        for fn in self.fns.values():
            for kern, val, _line in _set_attr_calls(fn.toks, {}):
                names = [t[1] for t in val if t[0] == "id"]
                if kern in fn.params:
                    for nm in names:
                        if nm in fn.params:
                            out[fn.name] = (fn.params.index(kern),
                                            fn.params.index(nm))
        return out

    # ---- launch sites ------------------------------------------------------
    def launch_sites(self) -> List[LaunchSite]:
        out: List[LaunchSite] = []
        for fn in self.fns.values():
            if not any(a[1] == "<<" and b[1] == "<"
                       for a, b in zip(fn.toks, fn.toks[1:])):
                continue
            self._walk(fn, fn.stmts, [], {}, [], out)
        out.sort(key=lambda s: s.line)
        return out

    def _walk(self, fn: CFn, stmts, conds, scope, attrs, out) -> None:
        scope, attrs = dict(scope), list(attrs)
        for st in stmts:
            if st.kind == "block":
                self._walk(fn, st.body, conds, scope, attrs, out)
            elif st.kind == "if":
                for kern, val, line in _set_attr_calls(st.toks,
                                                       self.helpers):
                    attrs.append((kern, val, dict(scope), line))
                self._walk(fn, [st.then], conds + [(st.toks, True)],
                           scope, attrs, out)
                if st.other is not None:
                    self._walk(fn, [st.other],
                               conds + [(st.toks, False)], scope, attrs,
                               out)
            elif st.kind == "loop":
                # a for loop's induction variable is bound to its first
                # value: the launch checked is the loop's first (a chunk
                # loop's first chunk is its largest)
                inner = dict(scope)
                head = st.toks or []
                semi = next((k for k, t in enumerate(head)
                             if t[1] == ";"), None)
                if semi is not None:
                    for name, val, dim3 in _declarators(head[:semi]):
                        inner[name] = (val, dict(scope), dim3)
                self._walk(fn, st.body, conds, inner, attrs, out)
            else:
                toks = st.toks
                for kern, val, line in _set_attr_calls(toks, self.helpers):
                    attrs.append((kern, val, dict(scope), line))
                site = self._launch_of(fn, toks, conds, scope, attrs)
                if site is not None:
                    out.append(site)
                    continue
                for name, val, dim3 in _declarators(toks):
                    scope[name] = (val, dict(scope), dim3)

    def _launch_of(self, fn, toks, conds, scope, attrs):
        for k in range(len(toks) - 1):
            if toks[k][1] == "<<" and toks[k + 1][1] == "<":
                for m in range(k + 2, len(toks) - 1):
                    if toks[m][1] == ">>" and toks[m + 1][1] == ">":
                        return LaunchSite(
                            self.path, fn.name, toks[k][2],
                            _text(toks[:k]),
                            _split_commas(toks[k + 2:m]), list(conds),
                            dict(scope), list(attrs))
        return None

    # ---- evaluation --------------------------------------------------------
    def parse(self, toks):
        return _parse_expr(toks, self.templates)

    def canon(self, name: str) -> str:
        seen = 0
        while name in self.aliases and seen < 8:
            name, seen = self.aliases[name], seen + 1
        return name

    def lookup(self, name: str, env: dict):
        if name in env:
            v = env[name]
            if isinstance(v, _Lazy):
                v = env[name] = v.force(self)
            return v
        if name in self.consts:
            if name not in self._memo:
                self._memo[name] = self._eval(self.parse(self.consts[name]),
                                              {})
            return self._memo[name]
        canon = self.canon(name)
        if canon in _TYPE_SIZES:
            return Ty(canon)
        raise _EvalError(f"{name!r} is not bound")

    def _eval(self, node, env: dict):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "name":
            return self.lookup(node[1], env)
        if kind == "type":
            return Ty(self.canon(node[1]))
        if kind == "member":
            base = node[1]
            if base[0] == "name":
                key = f"{base[1]}.{node[2]}"
                if key in env:
                    return self.lookup(key, env)
            obj = self._eval(base, env)
            if not isinstance(obj, dict) or node[2] not in obj:
                raise _EvalError(f"no field {node[2]!r}")
            return obj[node[2]]
        if kind == "un":
            x = self._eval(node[2], env)
            return {"-": lambda: -x, "+": lambda: x,
                    "!": lambda: int(not x), "~": lambda: ~x}[node[1]]()
        if kind == "bin":
            return self._binop(node[1], node[2], node[3], env)
        if kind == "tern":
            return self._eval(node[2] if self._eval(node[1], env)
                              else node[3], env)
        if kind == "cast":
            x = self._eval(node[2], env)
            name = self.canon(node[1])
            if name in _INT_CASTS:
                bits, signed = _INT_CASTS[name]
                return _wrap(int(x), bits, signed)
            if name == "float":
                return float(x)
            raise _EvalError(f"cast to {node[1]!r} is not modelled")
        if kind == "sizeof":
            x = self._eval(node[1], env)
            if isinstance(x, Ty):
                return _TYPE_SIZES[x.name]
            raise _EvalError("sizeof of a value is not modelled")
        if kind == "same":
            a, b = self._eval(node[1], env), self._eval(node[2], env)
            return int(a == b)
        if kind == "tvar":
            tps, val = self.tvars[node[1]]
            return self._eval(self.parse(val),
                              self._bind(tps, node[2], env))
        if kind == "smember":
            st = self.structs.get(node[1])
            if st is None or node[3] not in st.members:
                raise _EvalError(f"{node[1]}::{node[3]} is not modelled")
            scope = self._bind(st.tparams, node[2], env)
            for m, val in st.members.items():
                scope.setdefault(m, _Lazy(self.parse(val), scope))
            return self.lookup(node[3], scope)
        if kind == "call":
            return self._call(node[1], node[2], node[3], env)
        raise _EvalError(f"cannot evaluate {kind}")

    def _bind(self, names, nodes, env) -> dict:
        if len(names) != len(nodes):
            raise _EvalError(f"{len(nodes)} arguments for {names}")
        return {n: self._eval(v, env) for n, v in zip(names, nodes)}

    def _binop(self, op, a_node, b_node, env):
        a = self._eval(a_node, env)
        if op == "&&":
            return int(bool(a) and bool(self._eval(b_node, env)))
        if op == "||":
            return int(bool(a) or bool(self._eval(b_node, env)))
        b = self._eval(b_node, env)
        if op == "/":
            if isinstance(a, int) and isinstance(b, int):
                return _c_div(a, b)
            return a / b
        if op == "%":
            return a - _c_div(a, b) * b
        return {"+": lambda: a + b, "-": lambda: a - b,
                "*": lambda: a * b, "<<": lambda: a << b,
                ">>": lambda: a >> b, "&": lambda: a & b,
                "|": lambda: a | b, "^": lambda: a ^ b,
                "<": lambda: int(a < b), "<=": lambda: int(a <= b),
                ">": lambda: int(a > b), ">=": lambda: int(a >= b),
                "==": lambda: int(a == b),
                "!=": lambda: int(a != b)}[op]()

    def _call(self, name, targs, args, env):
        if name == "dim3":
            dims = [int(self._eval(a, env)) for a in args]
            return tuple(dims + [1] * (3 - len(dims)))
        if name in _DEVICE_FACTS:
            return _DEVICE_FACTS[name]
        fn = self.fns.get(name)
        if fn is None:
            raise _EvalError(f"call of {name!r} is not modelled")
        local = self._bind(fn.tparams, targs, env) if fn.tparams else {}
        local.update(self._bind(fn.params, args, env))
        return self._run(fn.stmts, local)

    def _run(self, stmts, env):
        """Straight-line interpretation of a function body: declarations
        and assignments, ``if``, ``return``."""
        for st in stmts:
            if st.kind == "block":
                r = self._run(st.body, env)
                if r is not None:
                    return r
            elif st.kind == "if":
                branch = st.then if self._eval(self.parse(st.toks),
                                               env) else st.other
                if branch is not None:
                    r = self._run([branch], env)
                    if r is not None:
                        return r
            elif st.kind == "simple":
                if st.toks and st.toks[0][1] == "return":
                    return self._eval(self.parse(st.toks[1:]), env)
                for name, val, dim3 in _declarators(st.toks):
                    node = ("call", "dim3", [], [
                        self.parse(p) for p in _split_commas(val)]) \
                        if dim3 else self.parse(val)
                    env[name] = self._eval(node, env)
            else:
                raise _EvalError("loops are not modelled")
        return None

    def site_env(self, site: LaunchSite, binding: dict) -> dict:
        """The launch's scope, with the probe's bindings taking
        precedence (a binding pins what the source computes from a
        pointer or a type trait)."""
        env: dict = {}
        for name, (val, before, dim3) in site.scope.items():
            env[name] = _Lazy(val, before, dim3, binding)
        env.update(binding)
        return env


class _Lazy:
    """A declaration evaluated on first use, in the scope it saw."""

    def __init__(self, val, before, dim3: bool = False, binding=None):
        self.val, self.before, self.dim3 = val, before, dim3
        self.binding = binding

    def force(self, cu: CuFile):
        if isinstance(self.val, tuple):      # an already parsed node
            return cu._eval(self.val, self.before)
        env: dict = {}
        for name, (val, before, dim3) in self.before.items():
            env[name] = _Lazy(val, before, dim3, self.binding)
        env.update(self.binding or {})
        if self.dim3:
            return cu._call("dim3", [], [cu.parse(p) for p in
                                         _split_commas(self.val)], env)
        return cu._eval(cu.parse(self.val), env)


def _split_top(body) -> List[list]:
    """Statements of a struct body at its own level (nested braces,
    e.g. member functions, skipped)."""
    out, cur, depth = [], [], 0
    for t in body:
        if t[1] == "{":
            depth += 1
        elif t[1] == "}":
            depth -= 1
            if depth == 0:
                cur = []
            continue
        if depth:
            continue
        if t[1] == ";":
            out.append(cur)
            cur = []
        else:
            cur.append(t)
    return out


#: what a launch reads off the card rather than the source
_DEVICE_FACTS = {"sm_count": SM_COUNT}


# -- probe registry ----------------------------------------------------------

BF16, F32, I8 = Ty("__nv_bfloat16"), Ty("float"), Ty("int8_t")
U8, U16, U32 = Ty("uint8_t"), Ty("uint16_t"), Ty("uint32_t")


@dataclass
class Probe:
    """Bindings of one launching function; each must ground exactly one
    of its launch sites."""
    file: str
    func: str
    bindings: List[Dict[str, object]]


def _decode_args(b, nkv, R, L, ps=0, split_k=256):
    """K6/K9's DecodeArgs fields that shape a launch (L = mp * ps for
    a paged call), as ``rlo_decode_attend`` sets them: past 65,535
    splits the split widens by the smallest whole factor that fits."""
    nsplit = -(-L // split_k)
    if nsplit > MAX_GRID_YZ:
        split_k *= -(-nsplit // MAX_GRID_YZ)
        nsplit = -(-L // split_k)
    return dict(b=b, nkv=nkv, R=R, nsplit=nsplit, split_k=split_k, ps=ps)


def _rt(R: int) -> int:
    """decode.cu's dispatch_rt: the row tile a call of R rows takes."""
    return next((rt for rt in (1, 2, 4, 8, 16) if R <= rt), 32)


def _k6(C, HD, R, quant=0, paged=0, **a):
    return dict(C=C, HD=HD, RT=_rt(R), QUANT=quant,
                BF16DOT=int(C != F32), PAGED=paged,
                a=_decode_args(R=R, **a))


def _p3_probes() -> List[Probe]:
    """Committed bindings per launching function: the main path's
    shapes (PERF.md §4: the flagship's prefill and decode, the paged
    server, training's folded heads, the 256 MB ring), the
    counterparts of the JAX tool's P3_PROBES, and one hostile set
    (K1's int64 count; past CUDA's 65,535 on grid.y/z: K2–K5 at
    65,536 and 70,001 heads, K6 at 65,536 · 256 + 1 positions and
    2^21 + 1 row tiles' worth of rows, K8/K11 at 65,536 and 70,001
    (row, head) blocks; a one-token page)."""
    k1 = [dict(OP=0, DT=1, T=F32, n=n, aligned=1)
          for n in (67108864, 8388608, 524288, 1024)]
    k1 += [dict(OP=0, DT=2, T=BF16, n=1 << 25, aligned=1),
           dict(OP=1, DT=3, T=Ty("int32_t"), n=262144, aligned=0),
           dict(OP=0, DT=1, T=F32, n=(1 << 62) + 3, aligned=1),
           dict(OP=2, DT=1, T=F32, n=(1 << 62) + 3, aligned=0)]
    fwd = [dict(T=t, D=d, H=h, Lq=lq, Lk=lk)
           for t in (BF16, F32)
           for d, h, lq, lk in ((64, 512, 1024, 1024),
                                (64, 64, 1024, 1024),
                                (128, 8, 1024, 2048), (16, 4, 256, 256),
                                (128, 65536, 64, 64),
                                (16, 70001, 16, 16),
                                (32, 1, 1 << 24, 1 << 24))]
    bwd = [dict(fwd_b, which=w) for fwd_b in fwd for w in (3, 4, 5)]
    # K5's prepass (bf16), at the same shapes
    prep = [dict(D=b["D"], H=b["H"], Lq=b["Lq"]) for b in fwd
            if b["T"] == BF16]
    k6 = [
        # flagship decode T=1, dense bf16 / int8 (32 x 16 x 64 x 1088)
        _k6(BF16, 64, 1, b=32, nkv=16, L=1088),
        _k6(I8, 64, 1, quant=1, b=32, nkv=16, L=1088),
        # K9 over 289 pages of 128, and the GQA prefill chunk (T 128,
        # r 4) at 896 positions
        _k6(BF16, 64, 1, paged=1, b=32, nkv=16, L=289 * 128, ps=128),
        _k6(BF16, 64, 512, paged=1, b=4, nkv=4, L=7 * 128, ps=128),
        # the JAX probes: (2, 2, 8, 64) against (2, 4, 64, 1024) and a
        # (2, 3) table of 128-token pages; speculative T = 4
        _k6(BF16, 64, 4, b=2, nkv=4, L=1024),
        _k6(F32, 64, 4, b=2, nkv=4, L=1024),
        _k6(BF16, 64, 4, paged=1, b=2, nkv=4, L=3 * 128, ps=128),
        _k6(I8, 64, 2, quant=1, paged=1, b=2, nkv=4, L=2 * 128, ps=128),
        _k6(BF16, 16, 16, b=8, nkv=4, L=512),
        _k6(F32, 128, 32, b=1, nkv=8, L=4096),
        _k6(F32, 128, 32, paged=1, b=1, nkv=8, L=4096, ps=128),
        _k6(I8, 128, 8, quant=1, b=4, nkv=8, L=2048),
        # hostile: 65,536 * 256 + 1 positions (a widened split), a
        # one-token page, 65,536 query rows, 65,536 row tiles of 32,
        # 2^31 - 1 (batch, kv head) blocks
        _k6(BF16, 64, 1, b=1, nkv=1, L=65536 * 256 + 1),
        _k6(F32, 16, 65536 * 32, b=1, nkv=1, L=128),
        _k6(F32, 128, 32, paged=1, b=1, nkv=1, L=1024, ps=1),
        _k6(I8, 128, 65536, quant=1, paged=1, b=1, nkv=1, L=256,
            ps=16),
        _k6(BF16, 64, 1, b=(1 << 31) - 1, nkv=1, L=128),
    ]
    rows = [dict(E=e, a=dict(nb=nb, H=h, D=d), pairs=p)
            for e, nb, h, d, p in (
                (U16, 32, 16, 64, 2),     # K7 / K10 k/v pair, bf16
                (U8, 32, 16, 64, 2),      # int8 rows
                (U32, 32, 16, 1, 2),      # their f32 scales
                (U16, 4, 4, 64, 1),       # the JAX probes' (4, 4, 64)
                (U32, 4, 4, 128, 1),
                (U16, 1 << 20, 128, 128, 2))]   # hostile: 2^31 chunks
    blocks = [dict(E=e, a=dict(n_t_tiles=-(-t // 64), D=d, H=h), nb=nb,
                   pairs=p)
              for e, nb, h, d, t, p in (
                  (U16, 1, 16, 64, 64, 2),    # K8 (1, 16, 64, 64)
                  (U16, 1, 16, 64, 128, 2),   # K11 a page of 128
                  (U8, 1, 16, 64, 128, 2),
                  (U32, 1, 16, 1, 128, 2),
                  (U16, 4, 4, 64, 8, 1),      # the JAX (4, 4, 64, 8)
                  (U16, 4, 64, 16, 16, 1),
                  # hostile: past grid.y's 65,535 (row, head) blocks
                  (U16, 65536, 1, 128, 128, 2),
                  (U16, 1, 70001, 16, 16, 2))]
    return [
        Probe(REDUCE_CU, "launch", k1),
        Probe(FLASH_CU, "launch", fwd),
        Probe(FLASH_CU, "launch_bwd", bwd),
        Probe(FLASH_CU, "launch_dkv_prep", prep),
        Probe(DECODE_CU, "launch", k6),
        Probe(DECODE_CU, "launch_row_write", rows),
        Probe(DECODE_CU, "launch_block_write", blocks),
    ]


#: the committed probe registry — the maintained surface a new launch
#: site must join (the P3 coverage finding names it)
P3_PROBES = _p3_probes()


# -- geometry checks ---------------------------------------------------------

def _grounded(cu: CuFile, site: LaunchSite, binding: dict) -> bool:
    env = cu.site_env(site, binding)
    for toks, want in site.conds:
        if bool(cu._eval(cu.parse(toks), env)) != want:
            return False
    return True


def _check_launch(f: List[Finding], cu: CuFile, site: LaunchSite,
                  binding: dict, what: str) -> None:
    env = cu.site_env(site, binding)
    where = f"{site.kernel} ({what})"
    try:
        grid = cu._eval(cu.parse(site.args[0]), env)
        threads = cu._eval(cu.parse(site.args[1]), env)
        smem = cu._eval(cu.parse(site.args[2]), env) \
            if len(site.args) > 2 else 0
    except (_EvalError, csrc.CParseError) as e:
        f.append(Finding("P3", site.file, site.line,
                         f"{where}: launch geometry does not evaluate "
                         f"under the committed bindings: {e}"))
        return
    grid = grid if isinstance(grid, tuple) else (int(grid), 1, 1)
    if isinstance(threads, tuple):
        threads = threads[0] * threads[1] * threads[2]
    if threads > MAX_THREADS or threads % WARP or threads < 1:
        f.append(Finding("P3", site.file, site.line,
                         f"{where}: {threads} threads a block — a block "
                         f"takes at most {MAX_THREADS} threads, in whole "
                         f"warps of {WARP}"))
    if smem > MAX_DYN_SMEM:
        f.append(Finding("P3", site.file, site.line,
                         f"{where}: {smem} bytes of dynamic shared memory "
                         f"exceed the H100's {MAX_DYN_SMEM}-byte opt-in "
                         f"ceiling"))
    if smem > DEFAULT_SMEM:
        opted = []
        for kern, val, before, _line in site.set_attrs:
            if kern != site.kernel:
                continue
            try:
                opted.append(_Lazy(val, before, False, binding).force(cu))
            except (_EvalError, csrc.CParseError):
                opted.append(None)
        if not any(v is not None and v >= smem for v in opted):
            f.append(Finding(
                "P3", site.file, site.line,
                f"{where}: {smem} bytes of dynamic shared memory (over "
                f"{DEFAULT_SMEM}) without a preceding {_SET_ATTR}("
                f"{site.kernel}, {_SMEM_ATTR}, >= {smem}) — the launch "
                f"fails"))
    x, y, z = grid
    if not (1 <= x <= MAX_GRID_X) or not (1 <= y <= MAX_GRID_YZ) or \
            not (1 <= z <= MAX_GRID_YZ):
        f.append(Finding("P3", site.file, site.line,
                         f"{where}: grid ({x}, {y}, {z}) outside the "
                         f"launch limits (x in [1, 2^31), y and z in "
                         f"[1, {MAX_GRID_YZ}])"))


def rule_p3(ctx: ProverContext) -> List[Finding]:
    f: List[Finding] = []
    sites: Dict[str, List[LaunchSite]] = {}
    for rel in KERNEL_SOURCES:
        sites[rel] = ctx.cuda(rel).launch_sites()
    grounded: Set[Tuple[str, int]] = set()
    for probe in P3_PROBES:
        cu = ctx.cuda(probe.file)
        fn = cu.fns.get(probe.func)
        if fn is None:
            f.append(Finding("P3", probe.file, 1,
                             f"probed launch function {probe.func} not "
                             f"found"))
            continue
        mine = [s for s in sites[probe.file] if s.fn == probe.func]
        for bi, binding in enumerate(probe.bindings):
            hit = []
            for site in mine:
                try:
                    if _grounded(cu, site, binding):
                        hit.append(site)
                except (_EvalError, csrc.CParseError) as e:
                    f.append(Finding(
                        "P3", site.file, site.line,
                        f"{probe.func} binding {bi}: a branch to "
                        f"{site.kernel} does not evaluate: {e}"))
            if len(hit) != 1:
                f.append(Finding(
                    "P3", probe.file, fn.line,
                    f"{probe.func} binding {bi}: grounded {len(hit)} "
                    f"launch sites, expected 1 — the launcher no longer "
                    f"evaluates under the committed shapes"))
            for site in hit:
                grounded.add((site.file, site.line))
                _check_launch(f, cu, site, binding,
                              f"{probe.func} binding {bi}")
    for rel, ss in sites.items():
        for site in ss:
            if (site.file, site.line) not in grounded:
                f.append(Finding(
                    "P3", rel, site.line,
                    f"launch of {site.kernel} in {site.fn} is grounded "
                    f"by no P3 probe — add a binding to P3_PROBES"))
    f.extend(_bounds_discipline(ctx))
    return f


# -- the device-index bounds discipline (K6–K11) -----------------------------

#: (source, kernel body, args field read on the device, its upper bound)
#: — every position, slot or page id a decode kernel reads from a device
#: tensor. A read of another ``const int*`` field of a kernel's argument
#: struct must join this table or ``BOUNDS_EXEMPT``.
BOUNDS_READS = (
    (DECODE_CU, "decode_body", "pos", "L"),
    (DECODE_CU, "decode_body", "table", "a.P"),
    (DECODE_CU, "write_row_kernel", "off", "a.ps"),
    (DECODE_CU, "write_row_kernel", "page", "a.P"),
    (DECODE_CU, "write_block_kernel", "col0", "a.Lc"),
    (DECODE_CU, "write_block_kernel", "row", "a.nrow"),
)
#: device reads that are not addresses, and why
BOUNDS_EXEMPT = {
    ("write_block_kernel", "n_valid"):
        "a token count: it only lowers hi, and lo >= hi writes nothing",
}

_CMP = ("<", "<=", ">", ">=")
_OPERAND_STOP = {",", "?", ":", "&&", "||", "=", ";", "return", "{", "}"}
_SINK_CALLS = {"cp_async16", "__ldg", "__ldcg", "atomicAdd",
               "reinterpret_cast"}


def _pieces(toks) -> List[list]:
    """The body cut at every ';', '{' and '}': statement fragments in
    source order (lambda bodies and loop headers included)."""
    out, cur = [], []
    for t in toks:
        if t[1] in (";", "{", "}"):
            if cur:
                out.append(cur)
            cur = []
        else:
            cur.append(t)
    if cur:
        out.append(cur)
    return out


def _operand(piece, k: int, step: int) -> list:
    out, depth, j = [], 0, k + step
    while 0 <= j < len(piece):
        v = piece[j][1]
        if v in ("(", "["):
            depth += 1 if step > 0 else -1
        elif v in (")", "]"):
            depth -= 1 if step > 0 else -1
        if depth < 0 or (depth == 0 and v in _OPERAND_STOP):
            break
        out.append(piece[j])
        j += step
    return out if step > 0 else out[::-1]


def _var_ids(toks) -> List[Tuple[int, str]]:
    """(index, name) of identifiers that are variables, not members."""
    return [(i, t[1]) for i, t in enumerate(toks)
            if t[0] == "id" and (i == 0 or toks[i - 1][1] != ".")]


def _mentions(toks, names: Set[str]) -> bool:
    return any(n in names for _i, n in _var_ids(toks))


def _negated(toks, names: Set[str]) -> bool:
    for i, n in _var_ids(toks):
        if n in names and i > 0 and toks[i - 1][1] == "-" and \
                (i == 1 or toks[i - 2][1] in _BIN_PREC or
                 toks[i - 2][1] in ("(", "?", ":")):
            return True
    return False


def _is_load(piece, field_name: str) -> bool:
    for i in range(len(piece) - 3):
        if piece[i][1] == "a" and piece[i + 1][1] == "." and \
                piece[i + 2][1] == field_name and \
                (piece[i + 3][1] == "[" or
                 (i >= 2 and piece[i - 1][1] == "(" and
                  piece[i - 2][1] == "__ldg")):
            return True
    return False


def _is_sink(piece, derived: Set[str]) -> bool:
    depth = 0
    for i, t in enumerate(piece):
        if t[1] == "[":
            depth += 1
        elif t[1] == "]":
            depth -= 1
        elif depth > 0 and t[0] == "id" and t[1] in derived and \
                piece[i - 1][1] != ".":
            return True
    for i, t in enumerate(piece):
        if t[0] == "id" and t[1] in _SINK_CALLS and i + 1 < len(piece):
            j = i + 1
            if piece[j][1] == "<":        # reinterpret_cast<T*>(...)
                while j < len(piece) and piece[j][1] != ">":
                    j += 1
                j += 1
            if j < len(piece) and piece[j][1] == "(":
                try:
                    cl = csrc.match_paren(piece, j)
                except csrc.CParseError:
                    cl = len(piece) - 1
                if _mentions(piece[j + 1:cl], derived):
                    return True
    for name, val, _dim3 in _declarators(piece):
        eq = next(k for k, t in enumerate(piece) if t[1] == "=")
        if "*" in [t[1] for t in piece[:eq]] and _mentions(val, derived):
            return True
    return False


def _int_ptr_fields(cu: CuFile) -> Dict[str, Set[str]]:
    """Argument struct -> its ``const int*`` / ``int*`` fields."""
    out: Dict[str, Set[str]] = {}
    toks = cu.toks
    for i in range(len(toks) - 2):
        if toks[i][1] == "struct" and toks[i + 2][1] == "{":
            cl = csrc.match_paren(toks, i + 2)
            names = set()
            for st in _split_top(toks[i + 3:cl]):
                w = [t[1] for t in st]
                if "int" in w and "*" in w and w.index("*") == \
                        w.index("int") + 1:
                    for part in _split_commas(st[w.index("*") + 1:]):
                        ids = [t[1] for t in part if t[0] == "id"]
                        if ids:
                            names.add(ids[0])
            out[toks[i + 1][1]] = names
    return out


def _bounds_discipline(ctx: ProverContext) -> List[Finding]:
    f: List[Finding] = []
    cu = ctx.cuda(DECODE_CU)
    fields = set().union(*_int_ptr_fields(cu).values())
    table = {(fn, fld) for _src, fn, fld, _b in BOUNDS_READS}
    for fn_name in sorted({fn for _s, fn, _f, _b in BOUNDS_READS}):
        fn = cu.fns.get(fn_name)
        if fn is None:
            f.append(Finding("P3", DECODE_CU, 1,
                             f"kernel body {fn_name} not found"))
            continue
        pieces = _pieces(fn.toks)
        for piece in pieces:
            for fld in fields:
                if _is_load(piece, fld) and (fn_name, fld) not in table \
                        and (fn_name, fld) not in BOUNDS_EXEMPT:
                    f.append(Finding(
                        "P3", DECODE_CU, piece[0][2],
                        f"{fn_name} reads a.{fld} from the device and "
                        f"no BOUNDS_READS entry bounds it"))
    for src, fn_name, fld, bound in BOUNDS_READS:
        fn = cu.fns.get(fn_name)
        if fn is None:
            continue
        pieces = _pieces(fn.toks)
        load = next((k for k, p in enumerate(pieces)
                     if _is_load(p, fld)), None)
        if load is None:
            f.append(Finding("P3", src, fn.line,
                             f"{fn_name} no longer reads a.{fld}: its "
                             f"BOUNDS_READS entry is stale"))
            continue
        line = pieces[load][0][2]
        derived = {name for name, _v, _d in _declarators(pieces[load])}
        bound_toks = [t[1] for t in csrc.tokenize(bound)]
        lower = upper = sink = None
        for k in range(load + 1, len(pieces)):
            piece = pieces[k]
            for name, val, _d in _declarators(piece):
                if _mentions(val, derived):
                    derived.add(name.split(".")[0])
            for i, t in enumerate(piece):
                if t[1] not in _CMP:
                    continue
                left = _operand(piece, i, -1)
                right = _operand(piece, i, +1)
                both = left + right
                if not _mentions(both, derived):
                    continue
                words = [x[1] for x in both]
                has_bound = any(words[j:j + len(bound_toks)] == bound_toks
                                for j in range(len(words)))
                if has_bound and upper is None:
                    upper = k
                zero = [x[1] for x in left] == ["0"] or \
                    [x[1] for x in right] == ["0"]
                if lower is None and (zero or _negated(left, derived) or
                                      _negated(right, derived)):
                    lower = k
            if sink is None and _is_sink(piece, derived):
                sink = k
        for side, at in (("below (0)", lower), (f"above ({bound})",
                                                upper)):
            if at is None:
                f.append(Finding(
                    "P3", src, line,
                    f"{fn_name}: a.{fld} read from the device is never "
                    f"compared with its bound from {side} — a hostile "
                    f"value forms an out-of-range address"))
            elif sink is not None and at > sink:
                f.append(Finding(
                    "P3", src, line,
                    f"{fn_name}: a.{fld} read from the device is "
                    f"compared with its bound from {side} only at line "
                    f"{pieces[at][0][2]}, after it forms an address at "
                    f"line {pieces[sink][0][2]}"))
    return f


# ---------------------------------------------------------------------------
# P4 — axis discipline
# ---------------------------------------------------------------------------

#: Axis methods: a collective is the axis it is called on
_AXIS_METHODS = {"ppermute", "all_reduce", "all_gather", "all_to_all",
                 "barrier"}
#: wrapper functions (``device_collectives``, ``autodiff``) -> the
#: (positional index, keyword names) of their axis arguments
_DC_AXIS = {
    "allreduce": ((1,), ("axis",)),
    "reduce_scatter": ((1,), ("axis",)),
    "all_gather": ((1,), ("axis",)),
    "all_to_all": ((1,), ("axis",)),
    "rootless_bcast": ((2,), ("axis",)),
    "consensus": ((1,), ("axis",)),
    "barrier": ((0,), ("axis",)),
    "hierarchical_allreduce": ((1, 2), ("ici_axis", "dcn_axis")),
    "ppermute": ((1,), ("axis",)),
    "psum_invariant": ((1,), ("axis",)),
    "pvary": ((1,), ("axis",)),
}
_DC_MODULE_NAMES = {"dc", "device_collectives", "autodiff"}
_DC_MODULES = ("device_collectives", "autodiff")
#: the calls through which a module binds axis names into a mesh
_MESH_BUILDERS = ("LocalMesh", "dist_mesh_axes")


def _wrapper_names(tree: ast.Module) -> Dict[str, str]:
    """Local name -> wrapper of every collective a module imported from
    device_collectives/autodiff, at any depth (the models import them
    inside functions)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.rsplit(".", 1)[-1] in _DC_MODULES:
            out.update((a.asname or a.name, a.name) for a in node.names
                       if a.name in _DC_AXIS)
    return out


def _axis_exprs(call: ast.Call, wrappers: Dict[str, str]
                ) -> List[ast.AST]:
    """Axis expressions of one collective call, or []."""
    fn = call.func
    out: List[ast.AST] = []
    name = None
    if isinstance(fn, ast.Attribute):
        if isinstance(fn.value, ast.Name) and \
                fn.value.id in _DC_MODULE_NAMES and fn.attr in _DC_AXIS:
            name = fn.attr
        elif fn.attr in _AXIS_METHODS and not (
                isinstance(fn.value, ast.Name) and
                fn.value.id in _DC_MODULE_NAMES):
            return [fn.value]
    elif isinstance(fn, ast.Name) and fn.id in wrappers:
        name = wrappers[fn.id]
    if name is None:
        return []
    poss, kws = _DC_AXIS[name]
    for pos in poss:
        if len(call.args) > pos:
            out.append(call.args[pos])
    out.extend(kw.value for kw in call.keywords if kw.arg in kws)
    return out


def _declared_mesh_literals(tree: ast.Module) -> Set[str]:
    """Axis-name string literals a module itself binds into a mesh via
    ``LocalMesh`` / ``dist_mesh_axes`` — the only literals that module
    may consume as axis names."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name in _MESH_BUILDERS:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Constant) and \
                            isinstance(sub.value, str):
                        out.add(sub.value)
    return out


def _module_globals(tree: ast.Module) -> Set[str]:
    """Names a module binds at its top level (an Axis kept there is a
    global every caller shares)."""
    out: Set[str] = set()
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, (ast.AnnAssign,
                                               ast.AugAssign)) else [])
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name):
                    out.add(sub.id)
    return out


def _local_names(fn: ast.AST) -> Set[str]:
    """Parameters and names bound inside one function or lambda."""
    out: Set[str] = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        out.add(a.arg)
    for a in (args.vararg, args.kwarg):
        if a is not None:
            out.add(a.arg)
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Name) and \
                    isinstance(sub.ctx, ast.Store):
                out.add(sub.id)
    return out


def _enclosing_locals(tree: ast.Module) -> Dict[int, Set[str]]:
    """id(call) -> the names local to the functions enclosing it."""
    out: Dict[int, Set[str]] = {}

    def visit(node, scope: Set[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            scope = scope | _local_names(node)
        if isinstance(node, ast.Call):
            out[id(node)] = scope
        for child in ast.iter_child_nodes(node):
            visit(child, scope)

    visit(tree, set())
    return out


def rule_p4(ctx: ProverContext) -> List[Finding]:
    f: List[Finding] = []
    for rel in P4_FILES:
        if not (ctx.root / rel).exists():
            continue
        mod = ctx.mod(rel)
        declared = _declared_mesh_literals(mod.tree)
        wrappers = _wrapper_names(mod.tree)
        globs = _module_globals(mod.tree)
        scopes = _enclosing_locals(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            for expr in _axis_exprs(node, wrappers):
                for sub in ast.walk(expr):
                    literal = isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, str)
                    glob = isinstance(sub, ast.Name) and \
                        sub.id in globs and \
                        sub.id not in scopes.get(id(node), set())
                    if not (literal or glob) or \
                            (literal and sub.value in declared):
                        continue
                    at = find_anchor(mod.lines, node.lineno,
                                     AXIS_OK_ANCHOR)
                    if at is not None:
                        ctx.registry.consume(mod.path, at)
                        continue
                    if literal:
                        f.append(Finding(
                            "P4", rel, node.lineno,
                            f"hard-coded axis name {sub.value!r} in a "
                            f"collective call — axis names must flow "
                            f"from a parameter bound at the "
                            f"parallel/mesh.py wrapper (or match a mesh "
                            f"literal this module itself binds); a "
                            f"drifted string compiles the collective "
                            f"onto the wrong axis. '# {AXIS_OK_ANCHOR} "
                            f"<why>' sanctions a deliberate literal"))
                    else:
                        f.append(Finding(
                            "P4", rel, node.lineno,
                            f"collective on the module-level global "
                            f"{sub.id!r} — an Axis must flow from a "
                            f"parameter of the per-rank function; a "
                            f"global is one rank's axis shared by every "
                            f"caller. '# {AXIS_OK_ANCHOR} <why>' "
                            f"sanctions a deliberate exception"))
    return f


# ---------------------------------------------------------------------------
# P5 — host/device constant pinning
# ---------------------------------------------------------------------------

def _pin(ctx: ProverContext, f: List[Finding], path: str,
         lines: Sequence[str], line: int, what: str, got: object,
         want: object, anchored: bool = False) -> None:
    if got != want:
        f.append(Finding(
            "P5", path, line,
            f"{what} = {got!r} drifts from the pinned lane/page "
            f"contract ({want!r}) — the host and device sides of the "
            f"paged cache no longer agree"))
    if anchored:
        at = find_anchor(lines, line, LANE_PINNED_ANCHOR)
        if at is None:
            f.append(Finding(
                "P5", path, line,
                f"pinned constant site {what} lacks a "
                f"'{'//' if path.endswith('.cu') else '#'} "
                f"{LANE_PINNED_ANCHOR}' anchor comment"))
        else:
            ctx.registry.consume(path, at)


def _find_funcdef(tree: ast.AST, name: str,
                  cls: Optional[str] = None) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if cls is not None and isinstance(node, ast.ClassDef) and \
                node.name == cls:
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and \
                        sub.name == name:
                    return sub
        elif cls is None and isinstance(node, ast.FunctionDef) and \
                node.name == name:
            return node
    return None


def _py_const(mod: PyMod, name: str) -> Tuple[Optional[int], object]:
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == name and \
                isinstance(node.value, ast.Constant):
            return node.lineno, node.value.value
    return None, None


def _is_zero(node: ast.AST, zeros: Set[str]) -> bool:
    """A literal 0, a name bound to a zeros tensor, or NULL_PAGE."""
    if isinstance(node, ast.Constant):
        return node.value == 0
    return isinstance(node, ast.Name) and \
        (node.id in zeros or node.id == "NULL_PAGE")


def rule_p5(ctx: ProverContext) -> List[Finding]:
    f: List[Finding] = []
    dec = ctx.mod(DECODE_PY)
    cu = ctx.cuda(DECODE_CU)

    # kernels/decode.py's tile constants against decode.cu's
    consts = {}
    for name in ("BLOCK_K", "SPLIT_K", "MAX_BLOCK_T"):
        line, val = _py_const(dec, name)
        if line is None:
            f.append(Finding("P5", DECODE_PY, 1, f"{name} not defined"))
        consts[name] = (line, val)
    bk_line = next((t[2] for i, t in enumerate(cu.toks[:-2])
                    if t[1] == "BK" and cu.toks[i + 1][1] == "=" and
                    i > 0 and cu.toks[i - 1][1] == "int"), None)
    try:
        bk = cu.lookup("BK", {})
    except (_EvalError, csrc.CParseError):
        bk = None
    if bk_line is None or bk is None:
        f.append(Finding("P5", DECODE_CU, 1,
                         "decode.cu's cache tile BK not defined"))
    else:
        _pin(ctx, f, DECODE_CU, cu.lines, bk_line,
             "kernels/csrc/decode.cu BK", bk, LANE, anchored=True)
    line, val = consts["BLOCK_K"]
    if line is not None:
        _pin(ctx, f, DECODE_PY, dec.lines, line,
             "kernels/decode.py BLOCK_K", val, bk if bk else LANE,
             anchored=True)
    line, val = consts["SPLIT_K"]
    if line is not None:
        rem = val % bk if isinstance(val, int) and val > 0 and bk \
            else val
        _pin(ctx, f, DECODE_PY, dec.lines, line,
             "kernels/decode.py SPLIT_K % BK", rem, 0, anchored=True)
    line, val = consts["MAX_BLOCK_T"]
    if line is not None:
        _pin(ctx, f, DECODE_PY, dec.lines, line,
             "kernels/decode.py MAX_BLOCK_T", val, LANE, anchored=True)
    entry = cu.fns.get("rlo_decode_attend")
    gate = entry is not None and "split_k%BK" in _text(entry.toks)
    if not gate:
        f.append(Finding(
            "P5", DECODE_CU, entry.line if entry else 1,
            "rlo_decode_attend no longer refuses a split_k that is not "
            "a multiple of BK — a split would cut a cache tile"))

    # models/serve.py: the default page_size
    serve = ctx.mod(SERVE_PY)
    init = _find_funcdef(serve.tree, "__init__", cls="DecodeServer")
    page_default = None
    if init is not None:
        args = init.args
        pairs = list(zip(
            [a.arg for a in
             args.args[len(args.args) - len(args.defaults or []):]],
            args.defaults or []))
        pairs += [(kw.arg, d) for kw, d in
                  zip(args.kwonlyargs, args.kw_defaults)
                  if d is not None]
        for name, d in pairs:
            if name == "page_size" and isinstance(d, ast.Constant):
                _pin(ctx, f, SERVE_PY, serve.lines, d.lineno,
                     "models/serve.py DecodeServer page_size default",
                     d.value, LANE, anchored=True)
                page_default = (d.lineno, d.value)
    if page_default is None:
        f.append(Finding(
            "P5", SERVE_PY, 1,
            "DecodeServer.__init__ page_size default not found — the "
            "page-size pin has no anchor point"))

    # decode.cu's 16-byte vector gate: every cache element size at the
    # default page size must take it
    mods = []
    et = entry.toks if entry is not None else []
    for i in range(1, len(et) - 1):
        if et[i][1] == "%" and et[i - 1][1] == ")" and \
                et[i + 1][0] == "num" and \
                "esize" in [t[1] for t in et[_open_of(et, i - 1):i]]:
            mods.append((int(et[i + 1][1]), et[i + 1][2]))
    if not mods:
        f.append(Finding("P5", DECODE_CU, entry.line if entry else 1,
                         "rlo_decode_attend's 16-byte vector gate "
                         "(run * esize) % 16 not found"))
    for m, ln in mods[:1]:
        _pin(ctx, f, DECODE_CU, cu.lines, ln,
             "kernels/csrc/decode.cu vector gate modulus", m, VEC_BYTES,
             anchored=True)
    if page_default is not None and isinstance(page_default[1], int):
        for esize in (1, 2, 4):
            if (page_default[1] * esize) % VEC_BYTES:
                f.append(Finding(
                    "P5", SERVE_PY, page_default[0],
                    f"the default page of {page_default[1]} tokens is "
                    f"{page_default[1] * esize} bytes a row at "
                    f"{esize}-byte elements: off decode.cu's 16-byte "
                    f"vector path"))
                break

    # serving/pages.py: NULL_PAGE — the host side of the sentinel
    pages = ctx.mod(PAGES_PY)
    np_line, np_val = _py_const(pages, "NULL_PAGE")
    if np_line is None:
        f.append(Finding("P5", PAGES_PY, 1, "NULL_PAGE not defined"))
    else:
        _pin(ctx, f, PAGES_PY, pages.lines, np_line,
             "serving/pages.py NULL_PAGE", np_val, 0, anchored=True)

    # decode.cu's page clamps: an id below range lands on the null page
    for fn_name, var in (("decode_body", "page"),
                         ("write_row_kernel", "pg"),
                         ("write_block_kernel", "row")):
        fn = cu.fns.get(fn_name)
        toks = fn.toks if fn is not None else []
        hit = None
        for i in range(len(toks) - 4):
            if toks[i][1] == var and toks[i + 1][1] == "<" and \
                    toks[i + 2][1] == "0" and toks[i + 3][1] == "?":
                hit = (i, toks[i + 4])
                break
        if hit is None:
            f.append(Finding(
                "P5", DECODE_CU, fn.line if fn else 1,
                f"{fn_name}: the clamp '{var} < 0 ? NULL_PAGE : ...' of a "
                f"device page id is gone"))
            continue
        tgt = hit[1]
        got = int(tgt[1]) if tgt[0] == "num" else tgt[1]
        _pin(ctx, f, DECODE_CU, cu.lines, tgt[2],
             f"kernels/csrc/decode.cu {fn_name} null-page clamp", got,
             0 if np_val is None else np_val, anchored=True)

    # models/paged.py: the pool layout and the inactive-slot sentinels
    paged = ctx.mod(PAGED_PY)
    ipp = _find_funcdef(paged.tree, "init_page_pool")
    if ipp is not None:
        ok_shape = False
        for node in ast.walk(ipp):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id == "shape" and \
                    isinstance(node.value, ast.Tuple) and \
                    node.value.elts:
                last = node.value.elts[-1]
                ok_shape = isinstance(last, ast.Name) and \
                    last.id == "page_size"
        if not ok_shape:
            f.append(Finding(
                "P5", PAGED_PY, ipp.lineno,
                "init_page_pool pool shape no longer ends in "
                "page_size — pages must stay the minor axis the decode "
                "kernels index"))
    step = _find_funcdef(paged.tree, "paged_decode_step")
    found_page = found_off = found_mask = False
    if step is not None:
        zeros = set()
        for node in ast.walk(step):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    isinstance(node.value.func, ast.Attribute) and \
                    node.value.func.attr == "zeros" and \
                    node.value.args and \
                    isinstance(node.value.args[0], ast.Tuple) and \
                    not node.value.args[0].elts:
                zeros.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            if isinstance(node, ast.Compare) and \
                    isinstance(node.ops[0], ast.NotEq) and \
                    isinstance(node.left, ast.Name) and \
                    node.left.id == "page" and \
                    isinstance(node.comparators[0], ast.Name) and \
                    node.comparators[0].id == "NULL_PAGE":
                found_mask = True
        for node in ast.walk(step):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "where" and len(node.args) == 3:
                a1, a2 = node.args[1], node.args[2]
                if isinstance(a1, ast.Name) and a1.id == "page":
                    found_page = True
                    if not _is_zero(a2, zeros):
                        f.append(Finding(
                            "P5", PAGED_PY, node.lineno,
                            "inactive slots must map to the NULL page "
                            "(0, serving/pages.NULL_PAGE); this "
                            "torch.where routes them elsewhere"))
                if isinstance(a1, ast.Call) and \
                        isinstance(a1.func, ast.Attribute) and \
                        a1.func.attr == "remainder":
                    found_off = True
                    fill = a2.args[1] if isinstance(a2, ast.Call) and \
                        len(a2.args) > 1 else a2
                    if not (isinstance(fill, ast.Name) and
                            fill.id == "ps"):
                        f.append(Finding(
                            "P5", PAGED_PY, node.lineno,
                            "the paged write DROP sentinel must be "
                            "the page size ('ps') — any other "
                            "offset lands a masked write on a real "
                            "lane"))
    if step is not None and not (found_page and found_off and
                                 found_mask):
        f.append(Finding(
            "P5", PAGED_PY, step.lineno,
            "paged_decode_step no longer masks inactive slots via "
            "page != NULL_PAGE and the page->NULL / off->page_size "
            "sentinels"))
    return f


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

_RULES = {"P1": rule_p1, "P2": rule_p2, "P3": rule_p3, "P4": rule_p4,
          "P5": rule_p5}

#: the rule families that consume suppression anchors — what the
#: rlo-sentinel S0 audit runs for its consumption footprint.  A new
#: prover rule that learns an anchor spelling must join this tuple or
#: its anchors will be flagged stale.
ANCHOR_RULES = ("P4", "P5")


def audit_files(root: Path) -> List[str]:
    """Files whose ``rlo-prover:`` anchors fall under the rlo-sentinel
    S0 stale-anchor audit (the files the prover reads)."""
    rels = [TOPOLOGY_PY, SERVE_PY, PAGED_PY, PAGES_PY, DECODE_PY] + \
        list(KERNEL_SOURCES) + list(P4_FILES)
    seen: List[str] = []
    for rel in rels:
        if rel not in seen and (Path(root) / rel).exists():
            seen.append(rel)
    return seen


def run_prover(root: Path, rules: Optional[Sequence[str]] = None,
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
            raise ProverError(f"unknown rule {rid!r} (have "
                              f"{', '.join(RULE_IDS)})")
        out.extend(_RULES[rid](ctx))
    out.sort(key=lambda x: (x.file, x.line, x.rule))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rlo_tpu_torch.tools.rlo_prover",
        description="Symbolic collective-schedule verifier + "
                    "device-layer geometry lint (rule catalogue: "
                    "docs/DESIGN.md §16; the port's P3-P5 in this "
                    "module's docstring).")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule families (default: all), "
                         "e.g. --rules P1,P3")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)
    rules = ([r.strip().upper() for r in args.rules.split(",") if
              r.strip()] if args.rules else None)
    try:
        findings = run_prover(args.root, rules)
    except ToolError as e:
        print(f"rlo-prover: error: {e}", file=sys.stderr)
        return 2
    return emit(findings, prog="rlo-prover",
                ran=",".join(rules or RULE_IDS), root=args.root,
                as_json=args.json, quiet=args.quiet)


if __name__ == "__main__":
    sys.exit(main())
