"""Pipeline-parallel training on the card: the stages as threads of a
``LocalMesh`` on the one card, held against the single-card
``train_step`` on the same batch, with the flash kernels K2 (forward)
and K4/K5 (backward) launched by the stages.

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py``
says). f32 config (vocab 61, d 128, 8 heads of 16, 4 layers), TF32 off;
a step's loss within rtol 1e-5 and its params within rtol 2e-3 / atol
2e-5 of the single-card step's (the tolerances of the CPU tests: the
microbatches' GEMMs have fewer rows, so cuBLAS may sum in another
order), 1F1B within rtol 2e-4 / atol 2e-6 of GPipe.
"""

import pytest
import torch

from rlo_tpu_torch.kernels import flash as kf
from rlo_tpu_torch.models import pipeline as tpl
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.parallel.sharding import gather_tree, shard_tree

CFG = dict(vocab=61, d_model=128, n_heads=8, n_layers=4, d_ff=256,
           dtype="float32")
LR = 0.05
KERNELS = (kf.flash_block_update_hld, kf.bwd_dq, kf.bwd_dkv)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", torch.cuda.current_device())


def _step(dev, cfg, params, tokens, fn, pp, dp=None, n_micro=4):
    shape, names = ((pp,), ("pp",)) if dp is None else ((dp, pp),
                                                        ("dp", "pp"))
    mesh = LocalMesh(shape, names, device=dev)
    specs = tpl.pipeline_pspecs("pp", cfg)
    stacked = tpl.stack_layers(params)
    shards = [shard_tree(stacked, specs, mesh.axes(r))
              for r in range(mesh.world_size)]
    rows = tokens.shape[0] // (dp or 1)
    toks = [tokens[mesh.coords(r)[0] * rows:(mesh.coords(r)[0] + 1) * rows]
            if dp else tokens for r in range(mesh.world_size)]
    outs = mesh.run(lambda axes, p, t: fn(p, t, cfg, axes["pp"], n_micro,
                                          lr=LR, dp_axis=axes.get("dp")),
                    shards, toks)
    losses = [float(o[1]) for o in outs]
    assert len(set(losses)) == 1, losses
    new = gather_tree([o[0] for o in outs], specs, mesh)
    return tt.tree_leaves(tpl.unstack_layers(new, cfg.n_layers)), losses[0]


def _close(got, want, rtol, atol):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("pp,dp", [(4, None), (2, 2)])
def test_pipelined_steps_on_card_equal_single_card(cuda, pp, dp):
    cfg = tt.TransformerConfig(**CFG)
    params = tt.init_params(cfg, seed=1, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (8, 64), generator=gen,
                           device=cuda, dtype=torch.int32)
    want_p, want_loss = tt.train_step(params, tokens, cfg, lr=LR)
    want = tt.tree_leaves(want_p)
    got = {}
    for name, fn in (("gpipe", tpl.pipeline_train_step),
                     ("1f1b", tpl.pipeline_1f1b_train_step)):
        for k in KERNELS:
            k.launches = 0
        got[name] = _step(cuda, cfg, params, tokens, fn, pp, dp,
                          n_micro=2 if dp else 4)
        for k in KERNELS:
            assert k.launches > 0, f"{k.__name__} not launched by {name}"
        torch.testing.assert_close(got[name][1], float(want_loss),
                                   rtol=1e-5, atol=0)
        _close(got[name][0], want, rtol=2e-3, atol=2e-5)
    _close(got["1f1b"][0], got["gpipe"][0], rtol=2e-4, atol=2e-6)
