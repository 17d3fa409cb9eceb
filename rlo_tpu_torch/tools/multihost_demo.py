"""Multi-process demo: engine consensus gating a cross-process all-reduce.

The port of ``benchmarks/multihost_demo.py``'s scenario. Every process is
an engine rank (TCP socket mesh, real cross-process vote frames) and a
``torch.distributed`` rank of the data group:

  round 1: proposer = rank 1 (rootless: not rank 0), every local tensor
           finite -> every process approves and gets the replicated sum
           of ``rank + 1`` over the world;
  round 2: rank 2 (or the last) poisons its own tensor with NaN, another
           rank proposes; its judge votes NO -> the decision is 0 on
           every process and the all-reduce never runs;
  rounds 3-4: a subset ({0, 2, ws-1}, or {0, ws-1}) runs its own gated
           rounds while the others stand by: the highest member's NaN
           vetoes, then a clean round sums ``pos + 1`` over the members.

Each process checks both outcomes itself and prints one ``MULTIHOST-OK``
line. Launch::

    torchrun --nproc-per-node 4 -m rlo_tpu_torch.tools.multihost_demo \\
        [--data-backend nccl|gloo] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch


def run(ctx, n: int = 256) -> dict:
    """Rounds 1-4 on ``ctx`` (a ``MultiHostContext``); raises on a wrong
    outcome. Returns the decisions, the round-1 sum and each round's
    wall ms in this process."""
    rank, ws, dev = ctx.rank, ctx.world_size, ctx.device

    def judge(local):
        return bool(torch.isfinite(local).all())

    ms = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    local = torch.full((n,), float(rank + 1), device=dev)
    d1, out = timed("round1", lambda: ctx.propose_collective(
        local, proposer=1, judge=judge))
    want = float(sum(range(1, ws + 1)))
    if d1 != 1 or out is None or not bool((out == want).all()):
        raise RuntimeError(f"rank {rank}: clean round gave decision {d1}, "
                           f"sum {None if out is None else out[:4]} != "
                           f"{want}")

    poisoner = 2 if ws > 2 else ws - 1
    proposer2 = 3 if ws > 3 else 0
    local2 = local.clone()
    if rank == poisoner:
        local2[7] = float("nan")
    d2, out2 = timed("round2", lambda: ctx.propose_collective(
        local2, proposer=proposer2, judge=judge))
    if d2 != 0 or out2 is not None:
        raise RuntimeError(f"rank {rank}: poisoned round not vetoed "
                           f"(decision {d2})")

    members = [0, 2, ws - 1] if ws >= 4 else [0, ws - 1]
    sctx = ctx.sub_context(members)
    if (sctx is None) != (rank not in members):
        raise RuntimeError(f"rank {rank}: sub_context membership wrong")
    d3 = d4 = None
    if sctx is not None:
        pos, m = sctx.rank, sctx.world_size
        loc = torch.full((64,), float(pos + 1), device=dev)
        bad = loc.clone()
        if pos == m - 1:
            bad[3] = float("nan")
        d3, out3 = timed("round3", lambda: sctx.propose_collective(
            bad, proposer=1, judge=judge))
        if d3 != 0 or out3 is not None:
            raise RuntimeError(f"rank {rank}: subset veto failed "
                               f"(decision {d3})")
        d4, out4 = timed("round4", lambda: sctx.propose_collective(
            loc, proposer=0, judge=judge))
        want4 = m * (m + 1) / 2
        if d4 != 1 or out4 is None or not bool((out4 == want4).all()):
            raise RuntimeError(f"rank {rank}: subset sum wrong")
        sctx.close()
    ctx.barrier()  # the bystanders re-join the full world here
    return {"decisions": [d1, d2, d3, d4], "sum": float(out[0]),
            "round_ms": ms}


def ok_line(ctx, res: dict) -> str:
    return (f"MULTIHOST-OK rank={ctx.rank}/{ctx.world_size} "
            f"sum={res['sum']} decisions={res['decisions']} "
            f"round_ms=" + ",".join(f"{k}:{v:.3f}"
                                    for k, v in res["round_ms"].items()))


def main() -> None:
    from rlo_tpu_torch.parallel.multihost import MultiHostContext

    ap = argparse.ArgumentParser()
    ap.add_argument("--data-backend", default="nccl")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if args.device is None and torch.cuda.is_available():
        import os
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    ctx = MultiHostContext(data_backend=args.data_backend,
                           device=args.device)
    try:
        print(ok_line(ctx, run(ctx)), flush=True)
    finally:
        ctx.close()


if __name__ == "__main__":
    main()
