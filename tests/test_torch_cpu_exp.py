"""F1's repair: on the CPU, ``torch.exp`` (like log, sin and cos) hands
MKL's vector math chunks of 2048 elements on several threads at once,
and one thread's chunk of a process's first such multi-threaded call now
and then comes out less accurate (1.5e-4 relative; the decode twin's
first tile then missed its f32 tolerance 2.5 times over). Importing the
port makes one single-threaded call first, which settles MKL for the
rest of the process.

Each case runs one of the port's plain twins in a fresh process with
``torch.exp`` watched from before the port's import: the first call must
be that one-element call, and the twin must go on to make a call of more
than one chunk (the kind that missed). Without the settling call every
case fails in every process, where F1 failed in about 1 of 200."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_WATCH = """
import json, sys, torch
sizes = []
exp = torch.exp
def watched(x, *a, **k):
    sizes.append(x.numel())
    return exp(x, *a, **k)
torch.exp = watched
"""

_RUN = {
    "decode": """
from rlo_tpu_torch.kernels import decode as kd
from rlo_tpu_torch.tools import twin_bits
q, kc, vc, pos, _ = twin_bits._case()
kd.flash_block_decode_plain(torch.from_numpy(q), torch.from_numpy(kc),
                            torch.from_numpy(vc), torch.tensor(pos), 0.25,
                            split_k=128)
""",
    "paged": """
from rlo_tpu_torch.kernels import decode as kd
g = torch.Generator().manual_seed(0)
q = torch.randn(3, 1, 8, 16, generator=g)
kp, vp = (torch.randn(13, 8, 16, 128, generator=g) for _ in range(2))
table = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
kd.paged_flash_decode_plain(q, kp, vp, table, torch.tensor(500), 0.25)
""",
    "flash": """
from rlo_tpu_torch.kernels import flash as kf
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn(2, 64, 16, generator=g) for _ in range(3))
m = torch.full((2, 1, 64), -1e30)
l = torch.zeros(2, 1, 64)
o = torch.zeros(2, 64, 16)
pos = torch.arange(64, dtype=torch.int32).reshape(1, 64)
kf.flash_block_update_hld_plain(q, k, v, m, l, o, pos, pos, causal=True,
                                scale=0.25)
""",
    "dq": """
from rlo_tpu_torch.kernels import flash as kf
g = torch.Generator().manual_seed(0)
q, k, v, do2 = (torch.randn(2, 64, 16, generator=g) for _ in range(4))
m2, dl2, route = (torch.randn(2, 1, 64, generator=g) for _ in range(3))
pos = torch.arange(64, dtype=torch.int32).reshape(1, 64)
kf.bwd_dq_plain(q, k, v, m2, dl2, do2, route, pos, pos, causal=True,
                scale=0.25)
""",
}


@pytest.mark.parametrize("twin", sorted(_RUN))
def test_first_exp_of_a_twin_process_is_single_threaded(twin):
    out = subprocess.run(
        [sys.executable, "-c", _WATCH + _RUN[twin] +
         "print(json.dumps(sizes))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    sizes = json.loads(out.stdout.strip().splitlines()[-1])
    assert sizes[0] == 1, sizes[:4]
    assert max(sizes[1:]) > 2048, sizes
