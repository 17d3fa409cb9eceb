"""The plain twins' bits across fresh processes, on the CPU.

    python3 -m rlo_tpu_torch.tools.twin_bits [--variant V] [--procs 500]
                                             [--jobs 6]

Starts ``--procs`` fresh Python processes, ``--jobs`` at a time (each
inherits the caller's environment), and calls one function twice in each.
A miss is a process whose first call's bits differ from its second's.
Variants:

- ``twin``: the decode twin ``flash_block_decode_plain`` at
  ``split_k=128`` on the inputs of ``tests/test_torch_decode_split.py``'s
  ``[scalar-1-1-f32-128]`` case, made with numpy from the test's seed (B
  3, 8 heads, hd 16, L 808, pos 807, scale 0.25);
- ``exp``: ``torch.exp`` of 65536 f32 values in a process that imports
  torch and nothing of the port;
- ``exp-port``: the same after ``import rlo_tpu_torch``.

Prints one JSON line: the processes, the misses, the distinct bits of
each call (a digest) and the largest error of a first call from a
float64 evaluation over the split tests' f32 tolerance (rtol 1e-5, atol
1e-6). Run from a copy of another tree's root, it measures that tree's
twin.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import subprocess
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

VARIANTS = ("twin", "exp", "exp-port")
B, NH, D, L, SPLIT = 3, 8, 16, 3 * 256 + 40, 128


def _digest(arrays) -> str:
    return hashlib.sha1(b"".join(a.tobytes() for a in arrays)).hexdigest()[:10]


def _case():
    """(q, k cache, v cache, pos) of the test's case, and the float64
    attention of its one query row per head."""
    import numpy as np
    rng = np.random.default_rng(zlib.crc32(repr(("f32", 1, 1,
                                                 "scalar")).encode()))
    q = rng.standard_normal((B, 1, NH, D)).astype(np.float32)
    kc = rng.standard_normal((B, NH, D, L)).astype(np.float32)
    vc = rng.standard_normal((B, NH, D, L)).astype(np.float32)
    s = np.einsum("btnd,bndl->btnl", q.astype(np.float64),
                  kc.astype(np.float64)) * 0.25
    w = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("btnl,bndl->btnd", w / w.sum(-1, keepdims=True),
                    vc.astype(np.float64))
    return q, kc, vc, L - 1, ref


def _decode_child() -> dict:
    import numpy as np
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    q, kc, vc, pos, ref = _case()
    args = [torch.from_numpy(x) for x in (q, kc, vc)]
    calls = [kd.flash_block_decode_plain(
        *args, torch.tensor(pos, dtype=torch.int32), 0.25,
        split_k=SPLIT).numpy() for _ in range(2)]
    err = np.abs(calls[0] - ref) / (1e-6 + 1e-5 * np.abs(ref))
    return {"bits": [_digest([c]) for c in calls],
            "err_over_tol": float(err.max())}


def _exp_child(port: bool) -> dict:
    import numpy as np
    import torch
    if port:
        import rlo_tpu_torch  # noqa: F401
    x = np.random.default_rng(0).uniform(-8, 8, 1 << 16).astype(np.float32)
    calls = [torch.exp(torch.from_numpy(x)).numpy() for _ in range(2)]
    ref = np.exp(x.astype(np.float64))
    err = np.abs(calls[0] - ref) / (1e-6 + 1e-5 * np.abs(ref))
    return {"bits": [_digest([c]) for c in calls],
            "err_over_tol": float(err.max())}


def run(variant, procs, jobs) -> dict:
    """``procs`` fresh processes of ``variant``, ``jobs`` at a time."""
    root = Path(__file__).resolve().parents[2]
    # the file as a script, so that ``exp`` imports nothing of the port
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
           "--variant", variant]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (str(root), os.environ.get("PYTHONPATH")))))

    def one(_):
        out = subprocess.run(cmd, cwd=root, env=env, check=True,
                             capture_output=True, text=True, timeout=600)
        return json.loads(out.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(jobs) as pool:
        got = list(pool.map(one, range(procs)))
    return {
        "variant": variant, "processes": len(got),
        "misses": sum(g["bits"][0] != g["bits"][1] for g in got),
        "first_call_bits": dict(collections.Counter(g["bits"][0]
                                                    for g in got)),
        "second_call_bits": dict(collections.Counter(g["bits"][1]
                                                     for g in got)),
        "max_err_over_tol": max(g["err_over_tol"] for g in got),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=VARIANTS, default="twin")
    ap.add_argument("--procs", type=int, default=500)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        out = {"twin": _decode_child, "exp": lambda: _exp_child(False),
               "exp-port": lambda: _exp_child(True)}[a.variant]()
    else:
        out = run(a.variant, a.procs, a.jobs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
