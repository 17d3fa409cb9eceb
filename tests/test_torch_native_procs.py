"""The port's C core as processes, on the CPU: its sanitized selftest,
the shm scenario runner, and the one-rank-a-process facades
(``init("mpi")`` under the port's femtompirun, ``init("tcp")`` under its
tcprun) fed torch tensors, at world sizes up to 4. Every binary is built
from ``rlo_tpu_torch/native`` alone into its git-ignored ``_build``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from rlo_tpu_torch.native import build

ROOT = Path(__file__).resolve().parents[1]
TCPRUN = build._DIR / "tcprun"


def _run(cmd, timeout=240, **kw):
    proc = subprocess.run([str(c) for c in cmd], capture_output=True,
                          text=True, timeout=timeout, **kw)
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-3000:],
                                  proc.stderr[-3000:])
    return proc.stdout


def test_selftest_under_asan_and_ubsan(tmp_path):
    exe = build.build_tool("selftest")
    assert exe.parent == build.BUILD_DIR
    proc = subprocess.run([str(exe)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "rlo_selftest: all checks passed" in proc.stdout
    assert "runtime error" not in proc.stderr
    assert "AddressSanitizer" not in proc.stderr
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("args,passes", [
    (["-n", 4, "-m", 8], 12), (["-n", 3, "-c", "iar", "-veto", 1], 1),
    (["-n", 4, "-c", "fail"], 1)])
def test_shm_demo(args, passes):
    out = _run([build.build_tool("demo")] + args)
    assert "FAIL" not in out and out.count("PASS") == passes, out


def test_mpi_demo_under_femtompirun():
    launcher = build.build_tool("femtompirun")
    out = _run([launcher, "-n", 4, "-t", 200, build.build_tool("mpidemo"),
                "-c", "bcast", "-m", 4])
    assert "PASS" in out and "FAIL" not in out


#: one rank's program: the facade from ``init``, tensors in and out
PROG = r"""
import sys
sys.path.insert(0, {root!r})
import torch
import rlo_tpu_torch

b = rlo_tpu_torch.init({facade!r})
r, ws = b.rank, b.world_size
assert b.name == {facade!r}, b.name
x = torch.full((1000,), float(r + 1)) + torch.arange(1000.)
got = b.allreduce(x, algorithm="ring")
assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
assert torch.equal(got, ws * torch.arange(1000.) + ws * (ws + 1) / 2), r
assert sorted(b.last_staging) == ["protocol_s", "to_device_s", "to_host_s"]
got = b.allreduce(torch.tensor([r, -r], dtype=torch.int32), op="max")
assert got.tolist() == [ws - 1, 0], got
# a 0-d tensor (a loss, a count) comes back 0-d through the bcast-gather
for t, want in ((torch.tensor(r + 1.0, dtype=torch.float64),
                 ws * (ws + 1) / 2),
                (torch.tensor(r + 1, dtype=torch.int32), ws * (ws + 1) // 2)):
    got = b.allreduce(t, algorithm="bcast_gather")
    assert isinstance(got, torch.Tensor) and got.dim() == 0, got
    assert got.dtype == t.dtype and got.item() == want, got
g = b.all_gather(torch.tensor([r, 10 * r]))
assert g.tolist() == [[i, 10 * i] for i in range(ws)], g
n = 2 * ws + 1
c = -(-n // ws)
rs = b.reduce_scatter(torch.arange(float(n)))
assert rs.tolist() == [ws * v if v < n else 0.0
                       for v in range(c * r, c * r + c)], rs
a2a = b.all_to_all([torch.tensor([100 * r + d]) for d in range(ws)])
assert [int(t) for t in a2a] == [100 * s + r for s in range(ws)], a2a
y = b.bcast(1, torch.arange(5.) if r == 1 else torch.zeros(5))
assert torch.equal(y, torch.arange(5.)), y
assert b.consensus(1, proposer=ws - 1) == 1
assert b.consensus(0 if r == 2 else 1, proposer=0) == 0
s = b.sub_group([0, 2])
assert (s is None) == (r not in (0, 2))
if s is not None:
    z = s.allreduce(torch.tensor([float(r)]))
    assert z.tolist() == [2.0], z
    assert s.consensus(0 if s.pos == 1 else 1, proposer=0) == 0
b.barrier()
if s is not None:
    s.close()
b.barrier()
try:
    b.allreduce([torch.ones(2, dtype=torch.bfloat16)][0])
    raise SystemExit("bfloat16 was taken")
except TypeError:
    pass
b.close()
import os
os.write(1, f"RANK-OK {{r}} {{ws}}\n".encode())  # one write: no interleaving
"""


@pytest.mark.parametrize("facade", ["mpi", "tcp"])
def test_process_facade_with_tensors(facade, tmp_path):
    prog = tmp_path / "prog.py"
    prog.write_text(PROG.format(root=str(ROOT), facade=facade))
    if facade == "mpi":
        build.build(femtompi=True)  # once, not by every rank at once
        cmd = [build.build_tool("femtompirun"), "-n", 4, "-t", 200]
    else:
        build.build()
        cmd = [sys.executable, TCPRUN, "-n", 4, "-t", 200]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("FEMTOMPI_", "RLO_TCP_"))}
    out = _run(cmd + [sys.executable, prog], env=env)
    assert sorted(out.split("RANK-OK")[1:]) == \
        sorted(f" {r} 4\n" for r in range(4)), out


def test_tcprun_is_executable_and_names_its_world():
    assert os.access(TCPRUN, os.X_OK)
    out = _run([sys.executable, TCPRUN, "-n", 3, sys.executable, "-c",
                "import os; os.write(1, ('W %s %s\\n' % ("
                "os.environ['RLO_TCP_RANK'], os.environ['RLO_TCP_WORLD']))"
                ".encode())"])
    assert sorted(out.split()) == sorted(["W", "W", "W", "0", "1", "2",
                                          "3", "3", "3"])
