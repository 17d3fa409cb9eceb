"""The port's static analyzers (rlo_tpu_torch/tools: rlo-lint,
rlo-sentinel, rlo-prover, rlo-model and their runner) on the port's own
tree.

  1. Both runners report 0 findings on their own package, and so does
     each analyzer on a copy that holds only the files it reads.
  2. Every check the port's prover has of its own (P3's geometry and
     bounds checks on the CUDA sources, P4 on the Axis idiom, each P5
     pin) is fired by a mutation of the port's tree; the CLI keeps the
     JAX tool's exit codes and --json schema.
  3. P1/P2's schedules step alike in both topologies for n <= 64, and
     the symbolic model agrees with ops/device_collectives.py on a CPU
     LocalMesh (the counterpart of test_prover.py's oracle).

The JAX tools' mutation fixtures run on both packages in
tests/test_torch_tools_parity*.py.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import rlo_tpu.topology as jax_topology
import rlo_tpu_torch.topology as port_topology
from tests.test_torch_tools_parity import (  # noqa: F401 (fixtures)
    REPO_ROOT, _read_files, _tool, bases, mutate, run, trees)


# ---------------------------------------------------------------------------
# 1. clean trees
# ---------------------------------------------------------------------------

def test_jax_runner_is_clean():
    """The JAX package's merged static report on its own tree (the
    port's runs through its CLI below): all four analyzers, 0
    findings."""
    results = _tool("rlo_tpu", "runner").run_static(REPO_ROOT)
    assert [t for t, _dt, _f in results] == [
        "rlo-lint", "rlo-sentinel", "rlo-prover", "rlo-model"]
    found = [str(f) for _t, _dt, fs in results for f in fs]
    assert found == [], "\n".join(found)


def test_copies_analyze_clean(trees):
    """The copies hold every file the analyzers need: no ToolError and
    no finding on either (rlo-model's sim mode skips copies)."""
    for pkg, root in trees.items():
        for tool in ("rlo_lint", "rlo_prover"):
            assert run(pkg, tool, root) == [], (pkg, tool)
    assert not any("_build" in p or "__pycache__" in p
                   for p in _read_files("rlo_tpu_torch"))


def test_runner_cli_json_names_the_four_analyzers():
    proc = subprocess.run(
        [sys.executable, "-m", "rlo_tpu_torch.tools.runner", "--json"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert [t["tool"] for t in doc["tools"]] == [
        "rlo-lint", "rlo-sentinel", "rlo-prover", "rlo-model"]
    assert doc["findings"] == [] and \
        all(t["findings"] == 0 for t in doc["tools"])


# ---------------------------------------------------------------------------
# 3. the port's own checks, each fired
# ---------------------------------------------------------------------------

_K = "rlo_tpu_torch/kernels"
_DEC = f"{_K}/csrc/decode.cu"

#: (id, rule, edits on the port's tree, text every hit must hold)
PORT_ONLY = [
    ("p3_threads_not_warps", "P3",
     [(f"{_K}/csrc/flash.cu", "constexpr int kMmaThreads = 128;",
       "constexpr int kMmaThreads = 100;")], "100 threads a block"),
    ("p3_threads_over_1024", "P3",
     [(f"{_K}/csrc/flash.cu", "constexpr int kK5Threads = 384;",
       "constexpr int kK5Threads = 2048;")], "2048 threads a block"),
    ("p3_smem_ceiling", "P3",
     [(f"{_K}/csrc/flash.cu",
       "  return sizeof(bf16) * (size_t)(BQ + 4 * BK) * (D + 8);",
       "  return sizeof(bf16) * (size_t)(BQ + 4 * BK) * (D + 8) * 4;")],
     "exceed the H100's 232448-byte"),
    ("p3_missing_opt_in", "P3",
     [(f"{_K}/csrc/flash.cu",
       "    if ((e = set_smem(flash_fwd_mma_kernel<D>, smem))) return e;\n",
       "")], "without a preceding cudaFuncSetAttribute"),
    ("p3_opt_in_for_another_kernel", "P3",
     [(_DEC, "  cudaError_t e = cudaFuncSetAttribute(\n      kern,",
       "  cudaError_t e = cudaFuncSetAttribute(\n      decode_kernel<C, HD,"
       " RT, QUANT, BF16DOT>,")], "without a preceding"),
    ("p3_grid_y", "P3",
     [(_DEC, "dim3 grid(a.b * a.nkv, nrc, a.nsplit);",
       "dim3 grid(nrc, a.b * a.nkv, a.nsplit);")], "outside the launch"),
    ("p3_grid_x_uncapped", "P3",
     [(f"{_K}/csrc/reduce.cu", "  if (blocks > cap) blocks = cap;\n", "")],
     "outside the launch"),
    ("p3_unprobed_launcher", "P3",
     [(_DEC, "int launch_row_write(RowWrite& a",
       "int launch_rows(RowWrite& a"),
      (_DEC, "return launch_row_write<", "return launch_rows<"),
      (_DEC, "return launch_row_write<", "return launch_rows<"),
      (_DEC, "return launch_row_write<", "return launch_rows<")],
     "grounded by no P3 probe"),
    ("p3_pos_lower_bound", "P3",
     [(_DEC, "  const int live_end = live > 0 ? (int)live : 0;",
       "  const int live_end = (int)live;")],
     "a.pos read from the device is never compared with its bound "
     "from below"),
    ("p3_pos_upper_bound", "P3",
     [(_DEC, "  const long long live = last + 1 < (long long)L ? last + 1 "
       ": L;", "  const long long live = last + 1;")],
     "a.pos read from the device is never compared with its bound "
     "from above"),
    ("p3_page_table_clamp", "P3",
     [(_DEC, "      pg_s[i] = page < 0 ? 0 : (page >= a.P ? a.P - 1 : "
       "page);", "      pg_s[i] = page;")], "a.table read from the device"),
    ("p3_slot_lower_bound", "P3",
     [(_DEC, "  if (o < 0 || o >= a.ps) return;",
       "  if (o >= a.ps) return;")], "a.off read from the device is never"),
    ("p3_compare_after_address", "P3",
     [(_DEC, "  if (o < 0 || o >= a.ps) return;\n", ""),
      (_DEC, "           (((long long)pg * a.H + h) * a.D + d0) * a.ps + o;\n",
       "           (((long long)pg * a.H + h) * a.D + d0) * a.ps + o;\n"
       "  if (o < 0 || o >= a.ps) return;\n")],
     "after it forms an address"),
    ("p3_col0_lower_bound", "P3",
     [(_DEC, "  long long lo = t0 > -c0 ? t0 : -c0;",
       "  long long lo = t0;")], "a.col0 read from the device"),
    ("p3_row_clamp", "P3",
     [(_DEC, "  row = row < 0 ? 0 : (row >= a.nrow ? a.nrow - 1 : row);\n",
       "")], "a.row read from the device"),
    ("p4_literal_wrapper_axis", "P4",
     [("rlo_tpu_torch/ops/ulysses.py",
       "    out = all_to_all(chunks, axis, algorithm=algorithm)",
       '    out = all_to_all(chunks, "sp", algorithm=algorithm)')],
     "hard-coded axis name 'sp'"),
    ("p4_literal_receiver", "P4",
     [("rlo_tpu_torch/models/pipeline.py",
       "        recv = pp_axis.ppermute(send, plan.chain)",
       '        recv = axes["pp"].ppermute(send, plan.chain)')],
     "hard-coded axis name 'pp'"),
    ("p4_module_global", "P4",
     [("rlo_tpu_torch/ops/ulysses.py",
       "    out = all_to_all(chunks, axis, algorithm=algorithm)",
       "    out = all_to_all(chunks, _SP, algorithm=algorithm)"),
      ("rlo_tpu_torch/ops/ulysses.py", "\n\ndef ",
       "\n\n_SP = None\n\n\ndef ")],
     "module-level global '_SP'"),
    ("p4_dc_module_global", "P4",
     [("rlo_tpu_torch/models/transformer.py",
       'loss = dc.allreduce(loss, dp_axis, algorithm="psum")',
       'loss = dc.allreduce(loss, DP_AXIS, algorithm="psum")'),
      ("rlo_tpu_torch/models/transformer.py", "\n\ndef ",
       "\n\nDP_AXIS = None\n\n\ndef ")], "module-level global 'DP_AXIS'"),
    ("p5_block_k", "P5",
     [(f"{_K}/decode.py", "BLOCK_K = 128  #", "BLOCK_K = 64  #")],
     "kernels/decode.py BLOCK_K = 64"),
    ("p5_bk", "P5",
     [(_DEC, "constexpr int BK = 128;", "constexpr int BK = 64;")],
     "decode.cu BK = 64"),
    ("p5_split_k", "P5",
     [(f"{_K}/decode.py", "SPLIT_K = 256  #", "SPLIT_K = 320  #")],
     "SPLIT_K % BK = 64"),
    ("p5_split_gate", "P5",
     [(_DEC, "p.split_k <= 0 ||\n      p.split_k % BK ||",
       "p.split_k <= 0 ||")], "multiple of BK"),
    ("p5_max_block_t", "P5",
     [(f"{_K}/decode.py", "MAX_BLOCK_T = 128  #", "MAX_BLOCK_T = 256  #")],
     "MAX_BLOCK_T = 256"),
    ("p5_vector_gate", "P5",
     [(_DEC, "(run * esize) % 16 == 0", "(run * esize) % 8 == 0")],
     "vector gate modulus = 8"),
    ("p5_page_size_off_the_vector_path", "P5",
     [("rlo_tpu_torch/models/serve.py",
       "paged: bool = False, page_size: int = 128,",
       "paged: bool = False, page_size: int = 72,")],
     "off decode.cu's 16-byte vector path"),
    ("p5_null_page", "P5",
     [("rlo_tpu_torch/serving/pages.py", "NULL_PAGE = 0  #",
       "NULL_PAGE = 1  #")], "null-page clamp = 0"),
    ("p5_clamp_target", "P5",
     [(_DEC, "  pg = pg < 0 ? 0 :", "  pg = pg < 0 ? 1 :")],
     "write_row_kernel null-page clamp = 1"),
    ("p5_inactive_page", "P5",
     [("rlo_tpu_torch/models/paged.py",
       "    page = torch.where(ok, page, zero)",
       "    page = torch.where(ok, page, page_i)")],
     "must map to the NULL page"),
    ("p5_drop_sentinel", "P5",
     [("rlo_tpu_torch/models/paged.py",
       "torch.full((), ps, dtype=torch.int32, device=dev))",
       "torch.full((), 0, dtype=torch.int32, device=dev))")],
     "DROP sentinel"),
    ("p5_null_mask", "P5",
     [("rlo_tpu_torch/models/paged.py", " & (page != NULL_PAGE)", "")],
     "no longer masks inactive slots"),
    ("p5_missing_anchor", "P5",
     [(f"{_K}/decode.py",
       "BLOCK_K = 128  # rlo-prover: lane-pinned (decode.cu's BK)",
       "BLOCK_K = 128")], "lacks a '# rlo-prover: lane-pinned'"),
]


@pytest.mark.parametrize("case", PORT_ONLY, ids=[c[0] for c in PORT_ONLY])
def test_port_check_fires(trees, case):
    cid, rule, edits, want = case
    root = trees["rlo_tpu_torch"]
    for rel, old, new in edits:
        path = root / rel
        text = path.read_text()
        assert old in text, f"fixture drift: {old!r} not in {rel}"
        path.write_text(text.replace(old, new, 1))
    hits = [f for f in run("rlo_tpu_torch", "rlo_prover", root,
                           rules=[rule])]
    assert any(want in f.msg for f in hits), hits


def test_p4_mesh_builder_may_use_its_own_names(trees):
    """backend.py binds 'x' into its LocalMesh: it may hand axes['x']
    to a collective; another literal may not."""
    root = trees["rlo_tpu_torch"]
    rel = "rlo_tpu_torch/backend.py"
    mutate(root, rel, "lambda v, ax: dc.consensus(v, ax)",
           'lambda v, ax: dc.consensus(v, axes["x"])')
    assert run("rlo_tpu_torch", "rlo_prover", root, rules=["P4"]) == []
    mutate(root, rel, 'dc.consensus(v, axes["x"])',
           'dc.consensus(v, axes["y"])')
    hits = run("rlo_tpu_torch", "rlo_prover", root, rules=["P4"])
    assert [h.rule for h in hits] == ["P4"] and "'y'" in hits[0].msg


def test_p3_grounds_every_launch_site():
    """The 14 launches of K1-K11 and K5's prepass are each grounded by
    some probe, and a main-path binding evaluates to the geometry the
    card runs."""
    from rlo_tpu_torch.tools import rlo_prover as p
    ctx = p.build_context(REPO_ROOT)
    sites = {rel: ctx.cuda(rel).launch_sites() for rel in p.KERNEL_SOURCES}
    assert [len(sites[r]) for r in p.KERNEL_SOURCES] == [2, 9, 3]
    cu = ctx.cuda(p.FLASH_CU)
    site = next(s for s in sites[p.FLASH_CU]
                if s.kernel == "flash_fwd_mma_kernel<D>")
    b = dict(T=p.BF16, D=64, H=512, Lq=1024, Lk=1024)
    env = cu.site_env(site, b)
    assert p._grounded(cu, site, b)
    geom = [cu._eval(cu.parse(a), env) for a in site.args[:3]]
    # 16 query tiles of 64 x 512 heads; 4 warps; Q + 2 K + 2 V bf16
    # tiles of (64, 72)
    assert geom == [(16, 512, 1), 128, 2 * (64 + 4 * 64) * 72]


def test_prover_cli_contract(trees):
    root = trees["rlo_tpu_torch"]
    mutate(root, "rlo_tpu_torch/models/serve.py",
           "paged: bool = False, page_size: int = 128,",
           "paged: bool = False, page_size: int = 64,")
    cmd = [sys.executable, "-m", "rlo_tpu_torch.tools.rlo_prover",
           "--root", str(root)]
    proc = subprocess.run(cmd + ["--json"], capture_output=True,
                          text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 1, proc.stderr
    doc = json.loads(proc.stdout)
    assert {d["rule"] for d in doc} == {"P5"}
    assert set(doc[0]) == {"rule", "file", "line", "message", "severity"}
    proc = subprocess.run(cmd + ["--rules", "P3,P4"], capture_output=True,
                          text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run(cmd + ["--rules", "P9"], capture_output=True,
                          text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 2 and "unknown rule" in proc.stderr


# ---------------------------------------------------------------------------
# 4. the schedules and the oracle
# ---------------------------------------------------------------------------

def _steps(topo, n: int):
    out = []
    for origin in range(n):
        out.append(len(topo.binomial_bcast_schedule(n, origin).rounds))
        out.append(len(topo.skip_ring_bcast_schedule(n, origin).rounds))
    out.append(topo.ring_perm(n, 1))
    if topo.is_power_of_2(n):
        out.append(len(topo.recursive_doubling_rounds(n)))
        out.append(tuple(topo.halving_doubling_distances(n)))
    return out


def test_p1_p2_step_counts_equal_for_both_topologies():
    for n in range(2, 65):
        assert _steps(port_topology, n) == _steps(jax_topology, n), n


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_oracle_against_device_collectives(n):
    """The port's symbolic models against ops/device_collectives.py on a
    CPU LocalMesh: every bcast origin delivers the origin's row, and the
    allreduce schedules sum power-of-two contributions to all-ones."""
    from rlo_tpu_torch.ops import device_collectives as dc
    from rlo_tpu_torch.parallel.mesh import LocalMesh
    from rlo_tpu_torch.tools import rlo_prover as p
    mesh = LocalMesh((n,), ("x",), "cpu")
    xs = [torch.full((4,), float(100 + r), dtype=torch.float64)
          for r in range(n)]
    for origin in range(n):
        for schedule, gen in (("binomial", "binomial_bcast_schedule"),
                              ("skip_ring", "skip_ring_bcast_schedule")):
            tok = p.simulate_bcast(
                getattr(port_topology, gen)(n, origin).rounds, n)
            assert tok == [origin] * n
            got = mesh.run(lambda axes, v, o=origin, s=schedule:
                           dc.rootless_bcast(v, o, axes["x"], schedule=s),
                           xs)
            for r in range(n):
                assert torch.equal(got[r], xs[tok[r]])
    gathered, defects = p.simulate_ring_allreduce(n, port_topology)
    assert defects == [] and all(m == (1 << n) - 1
                                 for row in gathered for m in row)
    pows = [torch.full((3 * n,), 2.0 ** r, dtype=torch.float64)
            for r in range(n)]
    algs = ["ring"]
    if port_topology.is_power_of_2(n):
        acc, defects = p.simulate_rd_allreduce(n, port_topology)
        assert defects == [] and all(a == (1 << n) - 1 for a in acc)
        algs += ["recursive_doubling", "halving_doubling"]
    for alg in algs:
        got = mesh.run(lambda axes, v: dc.allreduce(
            v, axes["x"], algorithm=alg, pipeline_chunks=1), pows)
        assert all(torch.equal(g, torch.full_like(g, (1 << n) - 1))
                   for g in got), alg
