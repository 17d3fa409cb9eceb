"""Multi-process deployment of the port (``parallel/multihost.py``):
spawned gloo processes over a ``FileStore``, each a ``MultiHostContext``
whose engine runs over the TCP socket mesh, run the multihost demo's
rounds 1-4 (``rlo_tpu_torch/tools/multihost_demo.py``).

Oracles, as in ``tests/test_multihost.py``: round 1 (rootless proposer
1) approves on every process and every process holds ``sum(1..ws)``;
round 2 (one process's NaN) is vetoed on every process; rounds 3-4 (a
subset: its highest member's NaN vetoes, then a clean round sums over
the members) decide the same on every member, and the bystander gets
None from ``sub_context``. The decisions must also equal the JAX
package's ``LoopbackBackend.consensus`` on the same votes, computed in
the parent.

This module is imported by the spawned processes too, so it imports
neither JAX nor the JAX package at its top level.
"""

import json
import multiprocessing as mp
import time
from pathlib import Path

import pytest

JOIN_TIMEOUT_S = 60.0


def _worker(rank: int, ws: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from rlo_tpu_torch.parallel.multihost import MultiHostContext
    from rlo_tpu_torch.tools.multihost_demo import ok_line, run

    ctx = MultiHostContext(store=dist.FileStore(store_path, ws), rank=rank,
                           world_size=ws, data_backend="gloo", device="cpu",
                           timeout=30.0)
    try:
        res = run(ctx)
        res["line"] = ok_line(ctx, res)
        res["is_member"] = res["decisions"][2] is not None
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        ctx.close()


def _spawn(ws, tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, ws, str(tmp_path / "store"),
                               str(tmp_path)))
             for r in range(ws)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            # each process gets its own join timeout
            p.join(JOIN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    assert [p.exitcode for p in procs] == [0] * ws, "a process failed or hung"
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(ws)]


def _reference_decisions(ws):
    """The demo's votes through the JAX package's engines."""
    from rlo_tpu.backend import LoopbackBackend

    members = [0, 2, ws - 1] if ws >= 4 else [0, ws - 1]
    poisoner = 2 if ws > 2 else ws - 1
    proposer2 = 3 if ws > 3 else 0
    with LoopbackBackend(world_size=ws) as b:
        d1 = b.consensus([1] * ws, proposer=1)
        d2 = b.consensus([int(r != poisoner) for r in range(ws)],
                         proposer=proposer2)
        sub = b.sub_group(members)
        n = len(members)
        d3 = sub.consensus([int(p != n - 1) for p in range(n)], proposer=1)
        d4 = sub.consensus([1] * n, proposer=0)
        sub.close()
    return members, [d1, d2, d3, d4]


@pytest.mark.parametrize("ws", [4, 3])
def test_consensus_gated_allreduce_across_processes(ws, tmp_path):
    t0 = time.monotonic()
    got = _spawn(ws, tmp_path)
    members, want = _reference_decisions(ws)
    assert want == [1, 0, 0, 1]
    total = float(sum(range(1, ws + 1)))
    for r, res in enumerate(got):
        assert res["line"].startswith(f"MULTIHOST-OK rank={r}/{ws} ")
        assert res["sum"] == total
        assert res["is_member"] == (r in members)
        if r in members:
            assert res["decisions"] == want
        else:
            assert res["decisions"] == want[:2] + [None, None]
    assert time.monotonic() - t0 < 2 * JOIN_TIMEOUT_S
