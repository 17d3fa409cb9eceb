#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration, traffic mix and
limits, and the mix's driver and generator, by name, builds the port's
kernels the driver names (into ``rlo_tpu_torch/kernels/_build`` inside
the checkout), sets up the program from the seed, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints the result as
one JSON line, last on standard output; the numbers compared, each
beside its limit, are the last lines on standard error. ``--trace 1``
reports the per-layer metrics, read from a device trace of a
sub-window and from the run's counters, instead of the end-to-end ones.
Exits with a code other than 0 and prints no result without enough
CUDA cards, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# transformers and the like load JAX for flax unless told not to
os.environ.setdefault("USE_FLAX", "0")

from portbench import common  # noqa: E402

def _prebuild(libs) -> None:
    """Build the kernel libraries side by side (one nvcc each); a built
    library only loads."""
    from rlo_tpu_torch.kernels import build
    errs = []

    def one(name):
        try:
            build.load(name)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ths = [threading.Thread(target=one, args=(n,)) for n in libs]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    if errs:
        raise errs[0]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, overrides=None, control: bool = False,
             t_start: float = None, **hooks) -> dict:
    """One run of ``workload``; returns the result dict (the printed
    line's keys, plus ``control`` readings when asked). ``device`` None
    is the first card; ``overrides`` ({"model": {...}, "traffic":
    {...}}) replace entries of the cell's files, for tests on the CPU;
    ``hooks`` reach the driver (``step_fn``)."""
    import torch
    spec = common.cell(workload)
    conf = common.config(spec["config"])
    mix = common.traffic(spec["traffic"])
    ov = overrides or {}
    m = {**conf["model"], **ov.get("model", {})}
    mix = {**mix, **ov.get("traffic", {})}
    driver = common.driver(mix["driver"])
    dev = torch.device(device) if device is not None else \
        torch.device("cuda", 0)
    cuda = dev.type == "cuda"
    if cuda:
        _prebuild(driver.LIBS)
    state = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def window_closed():
        sync()
        state["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
        state["forbidden"] = common.forbidden_loaded()

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    job = {"model": m, "traffic": mix, "config": conf, "seed": seed,
           "seconds": seconds, "trace": trace, "device": dev,
           "limits": common.limits(workload), "control": control,
           "inputs": common.generator(mix["generator"]).inputs,
           "t_start": T_START if t_start is None else t_start,
           "sync": sync, "window_closed": window_closed, "free": free,
           **hooks}
    out = driver.run(torch, job)
    ctx = out["ctx"]
    metrics = {}
    for mspec in common.metric_specs(workload, trace):
        v = common.metric_reader(mspec["name"])(ctx)
        if v is not None:
            metrics[mspec["name"]] = {"value": v, "unit": mspec["unit"]}
    checks = out["checks"]["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    res = {"correct": correct, "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics,
           "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda
                      else "cpu", "count": 1,
                      "memory_peak_bytes": int(state.get("peak", 0))}}
    tr = ctx.get("trace")
    if trace and tr is not None:
        from portbench.trace import breakdown
        res["device"]["busy_s"] = tr["busy_s"]
        res["device"]["window_s"] = tr["window_s"]
        res["breakdown"] = breakdown(tr)
        from portbench.trace import top_ops
        for name, secs, n in top_ops(tr):
            print(f"trace op {secs:.6f} s {n}x {name}", file=sys.stderr)
        print(f"trace skipped {json.dumps(tr['skipped'])}", file=sys.stderr)
    res["checks"] = checks
    res["forbidden_modules"] = state.get("forbidden", [])
    res["readings"] = out["checks"].get("readings", {})
    if control:
        res["control"] = out["checks"].get("control")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = common.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"run: {args.workload} needs {spec['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = sorted(set(res.pop("forbidden_modules")) |
                 set(common.forbidden_loaded()))
    if bad:
        print(f"run: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    readings = res.pop("readings")
    res.pop("control", None)
    print(f"run: readings {json.dumps(readings)}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
