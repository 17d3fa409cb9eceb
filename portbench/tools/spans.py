"""The traced steps of a cell, split by the program's own spans.

    python3 portbench/tools/spans.py --workload <name> --seed <n> \
        [--seconds 10]

Runs the cell once as ``run.py --trace 1`` does, then prints one
``trace span <path> <seconds> <n>x`` line per span path in
``rlo_tpu_torch.utils.tracing.DEVICE_SPANS`` (stream seconds over the
traced steps, and the ranges; the paths are each thread's, so remat's
recompute, which autograd's device thread runs, has paths of its own),
one ``build <library> ...`` line per kernel library
(``kernels.build.build_stats()``), and last the run's correctness,
metrics and breakdown as one JSON line. Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("spans: needs a CUDA card", file=sys.stderr)
        return 2
    res = run.run_cell(args.workload, args.seed, args.seconds, True)
    from rlo_tpu_torch.kernels.build import build_stats
    from rlo_tpu_torch.utils.tracing import DEVICE_SPANS
    for path, (secs, n) in sorted(DEVICE_SPANS.totals().items()):
        print(f"trace span {path} {secs:.6f} {n}x")
    for lib, st in sorted(build_stats().items()):
        print(f"build {lib} builds {st['builds']} nvcc_s "
              f"{st['nvcc_s']:.3f} loads {st['loads']}")
    print(json.dumps({k: res.get(k) for k in
                      ("correct", "metrics", "device", "breakdown")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
