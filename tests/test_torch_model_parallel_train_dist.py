"""Sequence-, tensor- and expert-parallel training over ``DistAxis``: four
spawned gloo processes, one rank each, make their axes with
``dist_mesh_axes((2, 2), ("sp", "tp"))`` and take one SGD step with sp
and tp together, with sp alone, with tp alone and (an MoE config) with
ep over the sp line; the loss and the updated slices of every rank must
equal the same steps on a CPU ``LocalMesh`` of the same shape bit for bit
(every sum is over two ranks, so both transports add the same two
values).

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
from rlo_tpu_torch.parallel.mesh import LocalMesh, dist_mesh_axes
from rlo_tpu_torch.parallel.sharding import shard_tree

WS = 4
JOIN_TIMEOUT_S = 60.0
CFG = dict(vocab=61, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           dtype="float32", n_kv_heads=2, pos_encoding="rope")
MOE_CFG = dict(vocab=61, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               dtype="float32", n_experts=4, capacity_factor=4.0)
#: (name, config, the axes the step takes)
RUNS = [("sp_tp", CFG, ("sp", "tp")), ("sp", CFG, ("sp",)),
        ("tp", CFG, ("tp",)), ("ep", MOE_CFG, ("ep",))]


def _tokens():
    return torch.from_numpy(np.random.default_rng(7).integers(
        0, 61, (4, 16)).astype(np.int32))


def _step(axes, cfg, names):
    """One SGD step on this rank's block of the tokens; ep rides on the
    mesh's sp line."""
    cfg = tt.TransformerConfig(**cfg)
    ax = {n: axes["sp" if n == "ep" else n] for n in names}
    specs = tt.param_pspecs(cfg, "tp" if "tp" in ax else None,
                            "ep" if "ep" in ax else None)
    params = shard_tree(tt.init_params(cfg, seed=3, device="cpu"), specs,
                        ax)
    tok = _tokens()
    if "ep" in ax:
        tok = tok[2 * ax["ep"].index:2 * ax["ep"].index + 2]
    if "sp" in ax:
        blk = tok.shape[1] // 2
        tok = tok[:, ax["sp"].index * blk:(ax["sp"].index + 1) * blk]
    new, loss = tt.train_step(params, tok.contiguous(), cfg, lr=0.1,
                              **{f"{n}_axis": a for n, a in ax.items()})
    return [loss] + tt.tree_leaves(new)


def _worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WS), rank=rank,
        world_size=WS, timeout=timedelta(seconds=45))
    try:
        axes = dist_mesh_axes((2, 2), ("sp", "tp"))
        out = {}
        for name, cfg, names in RUNS:
            for i, t in enumerate(_step(axes, cfg, names)):
                out[f"{name}_{i}"] = t.numpy()
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_training_over_gloo_equals_local_mesh(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(WS)]
    for p in procs:
        p.start()
    # the LocalMesh runs meanwhile
    mesh = LocalMesh((2, 2), ("sp", "tp"), device="cpu")
    want = {name: mesh.run(lambda axes, c=cfg, n=names: _step(axes, c, n))
            for name, cfg, names in RUNS}
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
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(WS)]
    for name, per_rank in want.items():
        for r in range(WS):
            for i, t in enumerate(per_rank[r]):
                np.testing.assert_array_equal(
                    got[r][f"{name}_{i}"], t.numpy(),
                    err_msg=f"{name} rank {r} tensor {i}")
    # the whole batch's loss on every rank of the sp x tp step
    losses = {float(got[r]["sp_tp_0"]) for r in range(WS)}
    assert len(losses) == 1
