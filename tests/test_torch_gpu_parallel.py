"""Tensor-, expert- and sequence-parallel inference on the card: ranks as
threads of a ``LocalMesh`` on the one card, held against the same call
on a single rank of the card.

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py``
says). f32 configs (vocab 61, d 128, 8 heads of 16, 2 layers); the router
product runs without TF32. Greedy tokens equal; logits within rtol 1e-4
/ atol 1e-4 (cuBLAS sums the row-parallel halves in another order than
the whole product). K6 launched by 4 rank threads at once on one stream
(its split workspace and arrival counters are shared per stream) gives
each rank the bits that rank gets alone.
"""

import threading

import pytest
import torch

from rlo_tpu_torch.kernels import decode as kd
from rlo_tpu_torch.kernels import flash as kf
from rlo_tpu_torch.kernels import reduce as kr
from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.parallel.sharding import shard_tree

BASE = dict(vocab=61, d_model=128, n_heads=8, n_layers=2, d_ff=256,
            dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", torch.cuda.current_device())


def _prompt(shape, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, BASE["vocab"], shape, generator=g,
                         dtype=torch.int32).to(dev)


def _run(dev, cfg, params, name, n, fn, *per_rank, specs=None):
    mesh = LocalMesh((n,), (name,), device=dev)
    specs = specs or tt.param_pspecs(cfg, name if name == "tp" else None,
                                     name if name == "ep" else None)
    shards = [shard_tree(params, specs, mesh.axes(r)) for r in range(n)]

    def body(axes, p, *args):
        with torch.no_grad():
            return fn(axes[name], p, *args)
    return mesh.run(body, shards, *per_rank)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(n_kv_heads=4, pos_encoding="rope")])
def test_tp_generate_on_card_equals_single_rank(cuda, kw):
    cfg = tt.TransformerConfig(**BASE, **kw)
    params = tt.init_params(cfg, seed=1, device=cuda)
    prompt = _prompt((3, 40), 2, cuda)
    want = tg.generate(params, prompt, cfg, max_new=12)
    for fn in (kd.write_kv_row, kd.flash_block_decode):
        fn.launches = 0
    got = _run(cuda, cfg, params, "tp", 2, lambda ax, p: tg.generate(
        p, prompt, cfg, max_new=12, tp_axis=ax))
    for g in got:
        assert torch.equal(g, want)
    assert kd.flash_block_decode.launches > 0
    assert kd.write_kv_row.launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["ring", "halving_doubling"])
def test_tp_forward_on_card_through_k1(cuda, algorithm):
    cfg = tt.TransformerConfig(**BASE)
    params = tt.init_params(cfg, seed=3, device=cuda)
    tok = _prompt((2, 64), 4, cuda)
    with torch.no_grad():
        want = tt.forward(params, tok, cfg)
    kr.fused_combine.launches = 0
    got = _run(cuda, cfg, params, "tp", 4, lambda ax, p: tt.forward(
        p, tok, cfg, tp_axis=ax, tp_algorithm=algorithm))
    assert kr.fused_combine.launches > 0
    for g in got:
        assert torch.equal(g, got[0])
        torch.testing.assert_close(g, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["xla", "direct"])
def test_ep_generate_on_card_equals_single_rank(cuda, algorithm):
    cfg = tt.TransformerConfig(**BASE, n_experts=4, capacity_factor=4.0)
    params = tt.init_params(cfg, seed=5, device=cuda)
    prompt = _prompt((4, 24), 6, cuda)
    want = tg.generate(params, prompt, cfg, max_new=10)
    got = _run(cuda, cfg, params, "ep", 2, lambda ax, p, t: tg.generate(
        p, t, cfg, max_new=10, ep_axis=ax, all_to_all_algorithm=algorithm),
        list(prompt.chunk(2)))
    assert torch.equal(torch.cat(got), want)


@pytest.mark.gpu
@pytest.mark.parametrize("attention,layout", [("ring", "contiguous"),
                                              ("ring", "striped"),
                                              ("ulysses", "contiguous")])
def test_sp_forward_on_card_equals_single_rank(cuda, attention, layout):
    from rlo_tpu_torch.ops.ring_attention import (stripe_sequence,
                                                  unstripe_sequence)
    cfg = tt.TransformerConfig(**BASE, sp_attention=attention,
                               sp_layout=layout)
    params = tt.init_params(cfg, seed=7, device=cuda)
    tok = _prompt((2, 256), 8, cuda)
    with torch.no_grad():
        want = tt.forward(params, tok, cfg)
    seq = tok.t()
    if layout == "striped":
        seq = stripe_sequence(seq, 4)
    kf.flash_block_update_hld.launches = 0
    got = _run(cuda, cfg, params, "sp", 4, lambda ax, p, t: tt.forward(
        p, t.t().contiguous(), cfg, sp_axis=ax).transpose(0, 1),
        list(seq.chunk(4)))
    got = torch.cat(got)
    if layout == "striped":
        got = unstripe_sequence(got, 4)
    torch.testing.assert_close(got.transpose(0, 1), want, **TOL)
    steps = 4 if attention == "ring" else 1
    assert kf.flash_block_update_hld.launches == \
        steps * cfg.n_layers * 4


@pytest.mark.gpu
def test_k6_from_four_rank_threads_gives_each_rank_its_bits(cuda):
    """Each rank's K6 launch (its own batch, so its own share of the
    per-stream workspace, grown while the others' launches are queued)
    equals that rank's launch alone, over repeated rounds."""
    L, hd, nkv, nh = 1100, 64, 2, 8
    gen = torch.Generator(device=cuda).manual_seed(9)
    cases = []
    for r in range(4):
        b = 2 + 3 * r
        k = torch.randn((b, nkv, hd, L), generator=gen, device=cuda)
        v = torch.randn((b, nkv, hd, L), generator=gen, device=cuda)
        q = torch.randn((b, 1, nh, hd), generator=gen, device=cuda)
        pos = torch.randint(L // 2, L, (b,), generator=gen, device=cuda,
                            dtype=torch.int32)
        cases.append((q, k, v, pos))
    scale = hd ** -0.5
    alone = [kd.flash_decode(q, k, v, pos, scale) for q, k, v, pos in cases]
    torch.cuda.synchronize()
    mesh = LocalMesh((4,), ("x",), device=cuda)
    barrier = threading.Barrier(4)

    def rank(axes, case):
        q, k, v, pos = case
        outs = []
        for _ in range(20):
            barrier.wait()
            outs.append(kd.flash_decode(q, k, v, pos, scale))
        return outs

    for _ in range(3):
        kd._scratch.clear()          # the workspace grows under the run
        got = mesh.run(rank, cases)
        torch.cuda.synchronize()
        for r, outs in enumerate(got):
            for o in outs:
                assert torch.equal(o, alone[r]), r


@pytest.mark.gpu
def test_forward_with_an_axis_under_grad_raises_on_card(cuda):
    cfg = tt.TransformerConfig(**BASE)
    params = tt.init_params(cfg, seed=1, device=cuda)
    tok = _prompt((1, 16), 1, cuda)

    def fwd(ax, p):
        # a manual tp schedule has no backward: refused under autograd
        # before any rank enters a collective (training on the card runs
        # its ranks as processes: tests/test_torch_gpu_model_parallel_
        # train.py)
        with torch.enable_grad():
            for t in tt.tree_leaves(p):
                t.requires_grad_(True)
            return tt.forward(p, tok, cfg, tp_axis=ax, tp_algorithm="ring")

    with pytest.raises(NotImplementedError, match="no backward"):
        _run(cuda, cfg, params, "tp", 2, fwd)
