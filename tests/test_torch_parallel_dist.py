"""Tensor- and expert-parallel generation over ``DistAxis``: two spawned
gloo processes, one rank each, run ``generate`` with ``tp_axis`` (the
prompt on both ranks) and with ``ep_axis`` (two rows a rank); the tokens
must equal the same runs on a two-rank CPU ``LocalMesh`` (exactly: the
same schedules over the same f32 inputs).

This module is imported by the spawned ranks too, so it imports neither
JAX nor the JAX package.
"""

import multiprocessing as mp
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import DistAxis, LocalMesh
from rlo_tpu_torch.parallel.sharding import shard_tree

WS = 2
JOIN_TIMEOUT_S = 25.0
TP_CFG = dict(vocab=61, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              dtype="float32", n_kv_heads=2, pos_encoding="rope")
EP_CFG = dict(vocab=61, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              dtype="float32", n_experts=4, capacity_factor=4.0)


def _prompt():
    return torch.from_numpy(np.random.default_rng(7).integers(
        0, 61, (4, 6)).astype(np.int32))


def _tp(axis):
    cfg = tt.TransformerConfig(**TP_CFG)
    params = shard_tree(tt.init_params(cfg, seed=3, device="cpu"),
                        tt.param_pspecs(cfg, "tp"), {"tp": axis})
    with torch.no_grad():
        return tg.generate(params, _prompt(), cfg, max_new=6, tp_axis=axis)


def _ep(axis, algorithm):
    cfg = tt.TransformerConfig(**EP_CFG)
    params = shard_tree(tt.init_params(cfg, seed=4, device="cpu"),
                        tt.param_pspecs(cfg, ep_axis="ep"), {"ep": axis})
    rows = _prompt()[2 * axis.index:2 * axis.index + 2]
    with torch.no_grad():
        return tg.generate(params, rows, cfg, max_new=6, ep_axis=axis,
                           all_to_all_algorithm=algorithm)


def _worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WS), rank=rank,
        world_size=WS, timeout=timedelta(seconds=20))
    try:
        axis = DistAxis()
        out = {"tp": _tp(axis), "ep_xla": _ep(axis, "xla"),
               "ep_direct": _ep(axis, "direct")}
        np.savez(Path(out_dir) / f"rank{rank}.npz",
                 **{k: v.numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def test_tp_and_ep_generate_over_gloo_equal_local_mesh(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(WS)]
    for p in procs:
        p.start()
    # the LocalMesh runs meanwhile
    mesh = LocalMesh((WS,), ("x",), device="cpu")
    want = {"tp": mesh.run(lambda axes: _tp(axes["x"])),
            "ep_xla": mesh.run(lambda axes: _ep(axes["x"], "xla")),
            "ep_direct": mesh.run(lambda axes: _ep(axes["x"], "direct"))}
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
    for key, per_rank in want.items():
        for r in range(WS):
            np.testing.assert_array_equal(got[r][key], per_rank[r].numpy(),
                                          err_msg=f"{key} rank {r}")
    # tp: both ranks the same tokens; ep: the rows of a one-rank run
    np.testing.assert_array_equal(got[0]["tp"], got[1]["tp"])
    cfg = tt.TransformerConfig(**EP_CFG)
    with torch.no_grad():
        single = tg.generate(tt.init_params(cfg, seed=4, device="cpu"),
                             _prompt(), cfg, max_new=6).numpy()
    np.testing.assert_array_equal(
        np.concatenate([got[0]["ep_xla"], got[1]["ep_xla"]]), single)
