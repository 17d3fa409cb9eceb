"""Sequence- and tensor-parallel training on the card: K4 and K5 at a ring
step's shapes, ``DistAxis`` over gloo on a card's tensors (the
collectives' values and the bytes staged through the host), and an sp
and a tp step taken by two processes on the card against the
single-card ``train_step``.

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py``
says); the spawned ranks import this module too. The ring step: 64
folded heads x 256 x 64 bf16, queries at positions 256..511 with the
state carried from their own block, against a block of an earlier shard
(every key visible) and of a later one (every key masked): K4/K5 within
rtol 1e-4 per unit of the largest |value| of their plain versions (phase
7's class), the masked block's dk and dv exactly zero and its dq its
plain version's. The steps: an f32 config (vocab 61, d 128, 8 heads of
16, 2 layers), TF32 off; the loss within rtol 1e-5 and the params
within rtol 2e-3 / atol 2e-5 (sp) and 5e-3 / 5e-4 (tp) of the single
card's (each rank's GEMMs have fewer rows or columns, so cuBLAS may sum
in another order).
"""

import multiprocessing as mp
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from rlo_tpu_torch.kernels import flash as kf
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import dist_mesh_axes
from rlo_tpu_torch.parallel.sharding import leaf_specs, shard_tree

CFG = dict(vocab=61, d_model=128, n_heads=8, n_layers=2, d_ff=256,
           dtype="float32")
LR = 0.05
WS = 2
JOIN_TIMEOUT_S = 120.0
KERNELS = (kf.flash_block_update_hld, kf.bwd_dq, kf.bwd_dkv)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, rtol=1e-4, atol_unit=1e-4):
    scale = max(1.0, float(want.abs().max()))
    return bool(torch.allclose(got, want, rtol=rtol, atol=atol_unit * scale))


@pytest.mark.gpu
@pytest.mark.parametrize("shard", [0, 2], ids=["earlier", "later"])
def test_ring_step_k4_k5(cuda, shard):
    gen = torch.Generator(device=cuda).manual_seed(16)
    h, n, d, scale = 64, 256, 64, 0.125

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    def pos(s):
        return (s * n + torch.arange(n, dtype=torch.int32,
                                     device=cuda)).reshape(1, n)
    q = rand(h, n, d, dtype=torch.bfloat16)
    qp = pos(1)
    init = (torch.full((h, 1, n), kf.NEG, device=cuda),
            torch.zeros(h, 1, n, device=cuda), torch.zeros(h, n, d,
                                                           device=cuda))
    kw = dict(causal=True, scale=scale)
    own = [rand(h, n, d, dtype=torch.bfloat16) for _ in range(2)]
    k, v = (rand(h, n, d, dtype=torch.bfloat16) for _ in range(2))
    with torch.no_grad():
        state = kf.flash_block_update_hld(q, *own, *init, qp, qp, **kw)
        state_p = kf.flash_block_update_hld_plain(q, *own, *init, qp, qp,
                                                  **kw)
        nxt = kf.flash_block_update_hld(q, k, v, *state, qp, pos(shard),
                                        **kw)
        m2p = kf.flash_block_update_hld_plain(q, k, v, *state_p, qp,
                                              pos(shard), **kw)[0]
    dl2, do2 = rand(h, 1, n), rand(h, n, d)
    route = torch.zeros(h, 1, n, device=cuda)
    dq = kf.bwd_dq(q, k, v, nxt[0], dl2, do2, route, qp, pos(shard), **kw)
    dk, dv = kf.bwd_dkv(q, k, v, nxt[0], dl2, do2, route, qp, pos(shard),
                        **kw)
    ops = (q, k, v, m2p, dl2, do2, route, qp, pos(shard))
    pdq, (pdk, pdv) = kf.bwd_dq_plain(*ops, **kw), kf.bwd_dkv_plain(*ops,
                                                                    **kw)
    for got, want in ((dq, pdq), (dk, pdk), (dv, pdv)):
        assert _close(got, want)
    if shard > 1:
        assert int(torch.count_nonzero(dk)) == 0
        assert int(torch.count_nonzero(dv)) == 0
        assert torch.equal(dq, pdq)
        assert all(torch.equal(a, b) for a, b in zip(nxt, state))
    else:
        assert int(torch.count_nonzero(dk)) > 0


def _ops_worker(rank: int, store_path: str, out_dir: str) -> None:
    """Each collective of a card-device gloo ``DistAxis`` on 4 KB of f32
    rows: its values, and the bytes it stages (both ways)."""
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WS), rank=rank,
        world_size=WS, timeout=timedelta(seconds=60))
    try:
        axis = dist_mesh_axes((WS,), ("x",), device=dev)["x"]
        x = torch.arange(2 * 512, dtype=torch.float32,
                         device=dev).reshape(2, 512) + 1000 * rank
        out, staged = {}, {}
        for name, fn in (
                ("ppermute", lambda: axis.ppermute(x, [(0, 1), (1, 0)])),
                ("all_to_all", lambda: axis.all_to_all(x)),
                ("all_gather", lambda: axis.all_gather(x)),
                ("all_reduce", lambda: axis.all_reduce(x, "sum"))):
            before = axis.staged_bytes
            y = fn()
            assert y.device == dev, (name, y.device)
            out[name] = y.cpu().numpy()
            staged[name] = axis.staged_bytes - before
        np.savez(Path(out_dir) / f"ops{rank}.npz", **out,
                 **{f"staged_{k}": v for k, v in staged.items()})
    finally:
        dist.destroy_process_group()


def _spawn(target, tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(WS)]
    for p in procs:
        p.start()
    return procs


def _join(procs):
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    assert [p.exitcode for p in procs] == [0] * WS, "a rank failed or hung"


@pytest.mark.gpu
def test_gloo_axis_on_card_tensors(cuda, tmp_path):
    """ppermute and all_to_all cross through host buffers (gloo's
    point-to-point ops take host tensors only), all_gather and
    all_reduce go to gloo with the card's tensor; the results come back
    on the card with the values of the CPU exchange, and staged_bytes
    counts the copies each way (n bytes: 2n for a ppermute, an
    all_to_all and an all_reduce, 3n for a 2-rank all_gather)."""
    _join(_spawn(_ops_worker, tmp_path))
    got = [np.load(tmp_path / f"ops{r}.npz") for r in range(WS)]
    x = [np.arange(1024, dtype=np.float32).reshape(2, 512) + 1000 * r
         for r in range(WS)]
    n = x[0].nbytes
    for r in range(WS):
        np.testing.assert_array_equal(got[r]["ppermute"], x[1 - r])
        np.testing.assert_array_equal(got[r]["all_to_all"],
                                      np.stack([x[0][r], x[1][r]]))
        np.testing.assert_array_equal(got[r]["all_gather"], np.stack(x))
        np.testing.assert_array_equal(got[r]["all_reduce"], x[0] + x[1])
        assert [int(got[r][f"staged_{k}"]) for k in (
            "ppermute", "all_to_all", "all_gather", "all_reduce")] == \
            [2 * n, 2 * n, 3 * n, 2 * n]


def _tokens(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    return torch.randint(0, CFG["vocab"], (2, 64), generator=gen,
                         device=dev, dtype=torch.int32)


def _worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WS), rank=rank,
        world_size=WS, timeout=timedelta(seconds=90))
    try:
        cfg = tt.TransformerConfig(**CFG)
        out = {}
        for name in ("sp", "tp"):
            axes = dist_mesh_axes((WS,), (name,), device=dev)
            axis = axes[name]
            specs = tt.param_pspecs(cfg, "tp" if name == "tp" else None)
            params = shard_tree(tt.init_params(cfg, seed=7, device=dev),
                                specs, axes)
            tok = _tokens(dev)
            if name == "sp":
                blk = tok.shape[1] // WS
                tok = tok[:, rank * blk:(rank + 1) * blk].contiguous()
            for fn in KERNELS:
                fn.launches = 0
            new, loss = tt.train_step(params, tok, cfg, lr=LR,
                                      **{f"{name}_axis": axis})
            out[f"{name}_loss"] = float(loss)
            out[f"{name}_staged"] = axis.staged_bytes
            out[f"{name}_launches"] = [fn.launches for fn in KERNELS]
            for i, t in enumerate(tt.tree_leaves(new)):
                out[f"{name}_{i}"] = t.cpu().numpy()
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sp_and_tp_steps_over_processes_match_single_card(cuda, tmp_path):
    from rlo_tpu_torch.kernels import build
    build.load("flash")
    procs = _spawn(_worker, tmp_path)
    cfg = tt.TransformerConfig(**CFG)
    params = tt.init_params(cfg, seed=7, device=cuda)
    want, want_loss = tt.train_step(params, _tokens(cuda), cfg, lr=LR)
    _join(procs)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(WS)]
    leaves = [t.cpu().numpy() for t in tt.tree_leaves(want)]
    specs = leaf_specs(params, tt.param_pspecs(cfg, "tp"))
    for name, tol in (("sp", dict(rtol=2e-3, atol=2e-5)),
                      ("tp", dict(rtol=5e-3, atol=5e-4))):
        for r in range(WS):
            np.testing.assert_allclose(float(got[r][f"{name}_loss"]),
                                       float(want_loss), rtol=1e-5)
            assert int(got[r][f"{name}_staged"]) > 0
            steps = WS if name == "sp" else 1
            assert list(got[r][f"{name}_launches"]) == \
                [CFG["n_layers"] * steps] * 3
        for i, (w, spec) in enumerate(zip(leaves, specs)):
            parts = [got[r][f"{name}_{i}"] for r in range(WS)]
            if name == "tp" and "tp" in spec:
                whole = np.concatenate(parts, axis=list(spec).index("tp"))
            else:
                np.testing.assert_array_equal(parts[0], parts[1])
                whole = parts[0]
            np.testing.assert_allclose(whole, w, **tol, err_msg=f"{name} {i}")
