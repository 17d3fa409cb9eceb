"""The collectives' gradients over ``DistAxis``: two spawned gloo
processes, one rank each, take the gradient of every differentiable
schedule (the manual allreduces with sum and max, reduce-scatter,
all-gather, the bcast trees, hierarchical allreduce) and of a manual-tp
``forward``; each must equal the same run on a two-rank CPU
``LocalMesh`` bit for bit, so nothing is lost between processes.

This module is imported by the spawned ranks too, so it imports neither
JAX nor the JAX package.
"""

import multiprocessing as mp
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.ops import device_collectives as dc
from rlo_tpu_torch.parallel.mesh import LocalMesh, dist_mesh_axes
from rlo_tpu_torch.parallel.sharding import shard_tree

WS = 2
N = 13
JOIN_TIMEOUT_S = 40.0
TP_CFG = dict(vocab=61, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              dtype="float32", n_kv_heads=2, pos_encoding="rope")

#: name -> fn(x, axes) over a (1, 2) ("dcn", "x") mesh
CASES = {
    **{f"allreduce_{alg}_{op}": (
        lambda v, a, alg=alg, op=op: dc.allreduce(
            v, a["x"], op=op, algorithm=alg, pipeline_chunks=2))
       for alg in ("ring", "bidir_ring", "recursive_doubling",
                   "halving_doubling") for op in ("sum", "max")},
    **{f"reduce_scatter_{alg}": (
        lambda v, a, alg=alg: dc.reduce_scatter(v, a["x"], algorithm=alg))
       for alg in ("ring", "halving")},
    **{f"all_gather_{alg}": (
        lambda v, a, alg=alg: dc.all_gather(v, a["x"], algorithm=alg))
       for alg in ("xla", "ring", "doubling")},
    **{f"bcast_{s}": (
        lambda v, a, s=s: dc.rootless_bcast(v, 1, a["x"], schedule=s))
       for s in ("binomial", "skip_ring", "gather")},
    "hierarchical_ring": lambda v, a: dc.hierarchical_allreduce(
        v, a["x"], a["dcn"], dcn_algorithm="ring"),
}


def _inputs(rank):
    """A rank's x (integer-valued, with ties across the ranks) and a
    cotangent for each case's output."""
    rng = np.random.default_rng(11 + rank)
    return torch.from_numpy(rng.integers(-3, 4, N).astype(np.float32))


def _grads(axes, rank):
    out = {}
    x = _inputs(rank)
    for name, fn in CASES.items():
        v = x.clone().requires_grad_(True)
        y = fn(v, axes)
        ct = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) \
            * (rank + 1)
        (out[name],) = torch.autograd.grad(y, v, ct)
    cfg = tt.TransformerConfig(**TP_CFG)
    p = shard_tree(tt.init_params(cfg, seed=3, device="cpu"),
                   tt.param_pspecs(cfg, "tp"), {"tp": axes["x"]})
    leaves = [t.requires_grad_(True) for t in tt.tree_leaves(p)]
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, 61, (2, 8)).astype(np.int32))
    logits = tt.forward(p, tok, cfg, tp_axis=axes["x"], tp_algorithm="ring")
    for i, g in enumerate(torch.autograd.grad(logits.sum(), leaves)):
        out[f"forward_leaf{i}"] = g
    return {k: v.numpy() for k, v in out.items()}


def _worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WS), rank=rank,
        world_size=WS, timeout=timedelta(seconds=30))
    try:
        axes = dist_mesh_axes((1, WS), ("dcn", "x"))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **_grads(axes, rank))
    finally:
        dist.destroy_process_group()


def test_collective_grads_over_gloo_equal_local_mesh(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(WS)]
    for p in procs:
        p.start()
    # the LocalMesh runs meanwhile
    mesh = LocalMesh((1, WS), ("dcn", "x"), device="cpu", timeout=60)
    want = mesh.run(lambda axes: _grads(axes, axes["x"].index))
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    assert not any(p.is_alive() for p in procs)
    assert [p.exitcode for p in procs] == [0] * WS, "a rank failed or hung"
    for r in range(WS):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(got.files) == sorted(want[r])
        for key, w in want[r].items():
            np.testing.assert_array_equal(got[key], w,
                                          err_msg=f"{key} rank {r}")
    # the sum cases' closed form: every rank's cotangent summed
    ct = np.arange(N, dtype=np.float32)
    for r in range(WS):
        np.testing.assert_array_equal(want[r]["allreduce_ring_sum"],
                                      ct * (1 + 2))
