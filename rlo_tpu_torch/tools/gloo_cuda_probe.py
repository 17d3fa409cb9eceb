"""Which gloo collectives take a card's tensors, on this machine's torch.

    python3 -m rlo_tpu_torch.tools.gloo_cuda_probe

For each of all_reduce, broadcast, all_gather, reduce_scatter,
all_to_all_single and a point-to-point pair (batch_isend_irecv), two
fresh processes on the first card form a gloo group over a FileStore and
make the call on CUDA tensors; each prints "<op> rank <r>: ok <result>"
or the error it raised, and a process that dies (a gloo abort) is
reported as such. ``parallel.mesh.DistAxis`` stages through host
buffers what this shows gloo refusing. Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import tempfile

OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
       "all_to_all_single", "p2p")


def _worker(rank: int, store: str, op: str) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    x = torch.full((4,), float(rank + 1), device="cuda")
    try:
        if op == "all_reduce":
            out = x.clone()
            dist.all_reduce(out)
        elif op == "broadcast":
            out = x.clone()
            dist.broadcast(out, 0)
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            out = torch.stack(parts)
        elif op == "reduce_scatter":
            out = torch.empty_like(x)
            dist.reduce_scatter(out, [x, x])
        elif op == "all_to_all_single":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
        else:
            out = torch.empty_like(x)
            pair = [dist.P2POp(dist.isend, x, 1 - rank),
                    dist.P2POp(dist.irecv, out, 1 - rank)]
            for req in dist.batch_isend_irecv(pair):
                req.wait()
        torch.cuda.synchronize()
        print(f"{op} rank {rank}: ok {out.cpu().tolist()}", flush=True)
    except Exception as e:  # noqa: BLE001 - the probe reports it
        print(f"{op} rank {rank}: {type(e).__name__}: {str(e)[:160]}",
              flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA card", file=sys.stderr)
        return 2
    for op in OPS:
        with tempfile.TemporaryDirectory() as tmp:
            try:
                mp.spawn(_worker, args=(os.path.join(tmp, "store"), op),
                         nprocs=2, join=True)
            except Exception as e:  # noqa: BLE001 - the probe reports it
                print(f"{op}: a process died: {type(e).__name__}: "
                      f"{str(e)[:160]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
