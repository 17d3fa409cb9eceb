"""Pipeline-parallel training over ``DistAxis``: two spawned gloo
processes, one stage each (pp 2), run a GPipe and a 1F1B step; each
stage's new params and the loss must equal the same steps on a two-rank
CPU ``LocalMesh`` bit for bit (the same f32 schedules on the same
inputs; a two-rank sum is one addition, which gloo and the mesh make
alike).

This module is imported by the spawned ranks too, so it imports neither
JAX nor the JAX package.
"""

import multiprocessing as mp
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from rlo_tpu_torch.models import pipeline as tpl
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import DistAxis, LocalMesh
from rlo_tpu_torch.parallel.sharding import shard_tree
from rlo_tpu_torch.utils.checkpoint import _flatten_paths

PP = 2
N_MICRO = 4
JOIN_TIMEOUT_S = 40.0
CFG = dict(vocab=61, d_model=64, n_heads=4, n_layers=4, d_ff=128,
           dtype="float32", n_kv_heads=2, pos_encoding="rope")
STEPS = {"gpipe": tpl.pipeline_train_step,
         "1f1b": tpl.pipeline_1f1b_train_step}


def _steps(axis) -> dict:
    """Both schedules' step on this rank's stage: {name: (flat stage
    params, loss)}."""
    cfg = tt.TransformerConfig(**CFG)
    params = shard_tree(tpl.stack_layers(tt.init_params(cfg, seed=3,
                                                         device="cpu")),
                        tpl.pipeline_pspecs("pp", cfg), {"pp": axis})
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, CFG["vocab"], (8, 16)).astype(np.int32))
    out = {}
    for name, fn in STEPS.items():
        new, loss = fn(params, tokens, cfg, axis, N_MICRO, lr=0.05)
        flat = {f"{name}{k}": v.numpy() for k, v in
                _flatten_paths(new).items()}
        flat[f"{name}_loss"] = loss.numpy()
        out.update(flat)
    return out


def _worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, PP), rank=rank,
        world_size=PP, timeout=timedelta(seconds=30))
    try:
        np.savez(Path(out_dir) / f"rank{rank}.npz", **_steps(DistAxis()))
    finally:
        dist.destroy_process_group()


def test_pipeline_steps_over_gloo_equal_local_mesh(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(PP)]
    for p in procs:
        p.start()
    # the LocalMesh runs meanwhile
    want = LocalMesh((PP,), ("pp",), device="cpu").run(
        lambda axes: _steps(axes["pp"]))
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
    assert [p.exitcode for p in procs] == [0] * PP, "a rank failed or hung"
    for r in range(PP):
        with np.load(tmp_path / f"rank{r}.npz") as got:
            assert sorted(got.files) == sorted(want[r])
            for k in got.files:
                np.testing.assert_array_equal(got[k], want[r][k],
                                              err_msg=f"rank {r} {k}")
    # the loss is the same on both stages, and the two schedules agree
    for name in STEPS:
        assert want[0][f"{name}_loss"] == want[1][f"{name}_loss"]
    np.testing.assert_allclose(want[0]["1f1b_loss"], want[0]["gpipe_loss"],
                               rtol=1e-5)
