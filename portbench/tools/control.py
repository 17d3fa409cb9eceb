"""Read the control of a cell beside the program, on the card, at the
cell's own size.

    python3 portbench/tools/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 40]

For each seed, in one process (the kernels build once), runs the cell
as the benchmark does and then, on what the timed path produced, both
the f32 reference and the control: the reference in float8
(``reference.model.fp8_mm``) put in the program's place. Prints one
line per seed with the program's numbers (the lower readings) and the
control's (the upper readings), each beside the cell's limit, and a
last line saying whether the control failed a limit on every seed.
With ``--fault`` it plants that fault in the program's training step
instead and prints the fault's readings in the control's place.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import common, run  # noqa: E402


def _unchanged(params, opt, tokens, cfg):
    """A step that returns its state unchanged (the loss still read)."""
    from rlo_tpu_torch.models.transformer import loss_fn
    import torch
    with torch.no_grad():
        return params, loss_fn(params, tokens, cfg)


def _half(params, opt, tokens, cfg):
    """A step that leaves out half of the batch, the mean over the rest."""
    from rlo_tpu_torch.models.transformer import train_step_optim
    return train_step_optim(params, opt, tokens[:tokens.shape[0] // 2], cfg)


#: faults planted in a training cell's timed path
FAULTS = {"unchanged": _unchanged, "half_batch": _half}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float,
                    default=common.benchmark()["run_seconds"])
    ap.add_argument("--fault", choices=sorted(FAULTS),
                    help="plant a fault in the program instead (training "
                         "cells): its readings are the fault's")
    args = ap.parse_args(argv)
    fails = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        hooks = {"step_fn": FAULTS[args.fault]} if args.fault else {}
        res = run.run_cell(args.workload, seed, args.seconds, False,
                           control=not args.fault,
                           t_start=time.perf_counter(), **hooks)
        ctl = res["control"] if not args.fault else {
            k: c["value"] for k, c in res["checks"].items()}
        lim = {k: res["checks"][k]["limit"] for k in ctl}
        failed = any(v > lim[k] for k, v in ctl.items())
        fails.append(failed)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": {k: c["value"] for k, c in
                                      res["checks"].items()},
                          "control": ctl, "limits": lim,
                          "control_fails": failed,
                          "readings": res["readings"]}), flush=True)
    print(json.dumps({"control_fails": all(fails)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
