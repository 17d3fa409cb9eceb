"""The port's training step against the JAX package's on the CPU.

The JAX package's own params cross with ``params_from_numpy``; tokens
are made by numpy from a seed. Both sides run f32 unless stated (the JAX
package attends with its unfused path off a TPU, the port with the
plain twins of K2-K5 behind ``FlashBlockUpdate``), so they differ in
summation order only, and the tolerances are those of
``tests/test_transformer.py``: logits and grads rtol 2e-4 / atol 2e-5,
loss rtol 1e-5, params after a step rtol 1e-4 / atol 1e-5, int8 DCN
within its quantisation distance. Adam over three steps is held at
atol 1e-4: it divides each grad by its own running RMS, which amplifies
a last-ulp difference where a grad is tiny (the reference's tp Adam
test allows 5e-5 after one step). The bf16 entry config
is held at a relative L2 error of 3e-2 per gradient tensor (bf16 rounds
the activations at other places in the two frameworks: about 2^-8 per
rounding, ~1 % measured) and the loss at rtol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.models import transformer as jt
from rlo_tpu_torch.convert import params_from_numpy, params_to_numpy
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.ops.device_collectives import allreduce
from rlo_tpu_torch.parallel.mesh import LocalMesh

SEQ = 32
BASE = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            dtype="float32")
VARIANTS = {"mha_sincos": {}, "gqa_rope": dict(n_kv_heads=2,
                                               pos_encoding="rope")}
#: the small config of tests/test_transformer.py's training tests
SMALL = dict(vocab=16, d_model=32, n_heads=2, n_layers=1, d_ff=64,
             dtype="float32")


def _cfgs(**kw):
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def _params(jc, seed):
    jp = jt.init_params(jax.random.PRNGKey(seed), jc)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _assert_trees_close(got, want, rtol, atol):
    got = jax.tree.leaves(params_to_numpy(got))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jc, tc = _cfgs(**BASE, **VARIANTS[request.param])
    jp, tp = _params(jc, 0)
    return jc, tc, jp, tp


def test_forward_and_loss_match_jax(model):
    jc, tc, jp, tp = model
    tok = _tokens(0, (4, SEQ), BASE["vocab"])
    want = jax.jit(lambda p, t: jt.forward(p, t, jc))(jp, jnp.asarray(tok))
    logits, aux = tt.forward(tp, torch.from_numpy(tok), tc, with_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    assert float(aux) == 0.0
    jl = jax.jit(lambda p, t: jt.loss_fn(p, t, jc))(jp, jnp.asarray(tok))
    np.testing.assert_allclose(float(tt.loss_fn(tp, torch.from_numpy(tok),
                                                tc)), float(jl), rtol=1e-5)


def test_grads_and_loss_match_jax(model):
    jc, tc, jp, tp = model
    tok = _tokens(1, (4, SEQ), BASE["vocab"])
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t: jt.loss_fn(p, t, jc)))(
        jp, jnp.asarray(tok))
    loss, grads = tt.grads_and_loss(tp, torch.from_numpy(tok), tc)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_trees_close(grads, jg, rtol=2e-4, atol=2e-5)
    assert all(p.grad is None and not p.requires_grad
               for p in tt.tree_leaves(tp))


def test_train_step_matches_jax(model):
    jc, tc, jp, tp = model
    tok = _tokens(2, (4, SEQ), BASE["vocab"])
    ref_p, ref_loss = jax.jit(lambda p, t: jt.train_step(p, t, jc, lr=0.1))(
        jp, jnp.asarray(tok))
    before = [p.clone() for p in tt.tree_leaves(tp)]
    new_p, loss = tt.train_step(tp, torch.from_numpy(tok), tc, lr=0.1)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    _assert_trees_close(new_p, ref_p, rtol=1e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tt.tree_leaves(tp)))


def test_graft_entry_config_bf16_matches_jax():
    """``__graft_entry__.entry``'s config and batch: vocab 256, d 128, 4
    heads, 2 layers, d_ff 512, bf16 activations, tokens (2, 64)."""
    kw = dict(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=512,
              dtype="bfloat16")
    jc, tc = _cfgs(**kw)
    jp, tp = _params(jc, 0)
    tok = _tokens(0, (2, 64), 256)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t: jt.loss_fn(p, t, jc)))(
        jp, jnp.asarray(tok))
    loss, grads = tt.grads_and_loss(tp, torch.from_numpy(tok), tc)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    for a, b in zip(jax.tree.leaves(params_to_numpy(grads)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        assert a.dtype == np.float32
        assert np.linalg.norm(a - b) <= 3e-2 * np.linalg.norm(b)
    new_p, loss2 = tt.train_step(tp, torch.from_numpy(tok), tc, lr=1e-2)
    assert float(loss2) == float(loss)
    assert all(p.dtype == torch.float32 for p in tt.tree_leaves(new_p))


def test_remat_matches_non_remat_exactly():
    """Per-layer checkpointing changes what the backward keeps, not a
    bit of the forward or of the step."""
    jc, tc = _cfgs(**dict(SMALL, n_layers=2))
    tr = dataclasses.replace(tc, remat=True)
    _, tp = _params(jc, 6)
    tok = torch.from_numpy(_tokens(6, (2, SEQ), 16))
    assert torch.equal(tt.forward(tp, tok, tc), tt.forward(tp, tok, tr))
    p1, l1 = tt.train_step(tp, tok, tc, lr=0.1)
    p2, l2 = tt.train_step(tp, tok, tr, lr=0.1)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(tt.tree_leaves(p1),
                                                 tt.tree_leaves(p2)))


def test_chunked_loss_matches_unfused_and_jax():
    """The vocab-chunked head (vocab 1000, chunks of 256: the last one
    partial) against the plain loss in value and grads, and against the
    JAX package's chunked loss."""
    kw = dict(vocab=1000, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              dtype="float32")
    jc, tc = _cfgs(**kw, loss_vocab_chunk=256)
    plain = dataclasses.replace(tc, loss_vocab_chunk=0)
    jp, tp = _params(jc, 0)
    tok = _tokens(0, (2, 32), 1000)
    l0, g0 = tt.grads_and_loss(tp, torch.from_numpy(tok), plain)
    l1, g1 = tt.grads_and_loss(tp, torch.from_numpy(tok), tc)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    for a, b in zip(tt.tree_leaves(g1), tt.tree_leaves(g0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t: jt.loss_fn(p, t, jc)))(
        jp, jnp.asarray(tok))
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-5)
    _assert_trees_close(g1, jg, rtol=2e-4, atol=2e-5)


def test_train_step_optim_adam_matches_optax():
    """``train_step_optim`` with ``torch.optim.Adam(lr=1e-2)`` against
    ``train_step_optax`` with ``optax.adam(1e-2)``, three steps."""
    import optax
    jc, tc = _cfgs(**SMALL)
    jp, tp = _params(jc, 7)
    rng = np.random.default_rng(7)
    tok = np.stack([(rng.integers(0, 16) + np.arange(SEQ)) % 16
                    for _ in range(4)]).astype(np.int32)
    opt = optax.adam(1e-2)
    step = jax.jit(lambda p, s, t: jt.train_step_optax(p, s, t, jc, opt))
    state = opt.init(jp)
    adam = torch.optim.Adam(tt.tree_leaves(tp), lr=1e-2)
    for _ in range(3):
        jp, state, jl = step(jp, state, jnp.asarray(tok))
        tp, loss = tt.train_step_optim(tp, adam, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_trees_close(tp, jp, rtol=1e-4, atol=1e-4)
    assert all(p.grad is None for p in tt.tree_leaves(tp))


def _dp_step(mesh, tc, tp, tok, **kw):
    """One SGD step per rank of ``mesh``, rank r on batch row r."""
    rows = [torch.from_numpy(tok[r:r + 1]) for r in range(mesh.world_size)]

    def rank(axes, t):
        dcn = axes.get("dcn")
        return tt.train_step(tp, t, tc, lr=0.1, dp_axis=axes["dp"],
                             dcn_axis=dcn, **kw)
    return mesh.run(rank, rows)


def _single_device_reference(seed):
    jc, tc = _cfgs(**SMALL)
    jp, tp = _params(jc, seed)
    tok = _tokens(seed, (8, SEQ), 16)
    ref_p, ref_loss = jax.jit(lambda p, t: jt.train_step(p, t, jc, lr=0.1))(
        jp, jnp.asarray(tok))
    return tc, tp, tok, ref_p, ref_loss


def test_pure_dp_ring_matches_single_device():
    """The explicit combine: each of 8 ranks (threads of a CPU
    LocalMesh) takes its own grads, then ``allreduce(algorithm='ring')``
    (K1's plain version per step) and /8 -- the JAX package's pure-dp
    step, and its single-device step."""
    tc, tp, tok, ref_p, ref_loss = _single_device_reference(4)
    mesh = LocalMesh((8,), ("dp",), device="cpu")
    outs = _dp_step(mesh, tc, tp, tok, grad_algorithm="ring")
    single_p, single_loss = tt.train_step(tp, torch.from_numpy(tok), tc,
                                          lr=0.1)
    for new_p, loss in outs:
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        _assert_trees_close(new_p, ref_p, rtol=1e-4, atol=1e-5)
        for a, b in zip(tt.tree_leaves(new_p), tt.tree_leaves(single_p)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(
        tt.tree_leaves(outs[0][0]), tt.tree_leaves(outs[5][0])))


def test_two_tier_dp_matches_single_device():
    """A (dcn 2, dp 4) mesh: in-slice reduce-scatter, cross-slice
    allreduce of the scattered shard, in-slice all-gather."""
    tc, tp, tok, ref_p, ref_loss = _single_device_reference(7)
    mesh = LocalMesh((2, 4), ("dcn", "dp"), device="cpu")
    for new_p, loss in _dp_step(mesh, tc, tp, tok):
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        _assert_trees_close(new_p, ref_p, rtol=1e-4, atol=1e-5)


def test_two_tier_int8_dcn_close_to_exact():
    """int8 on the cross-slice hop: within quantisation distance of the
    exact two-tier step (tests/test_transformer.py:211's bounds)."""
    tc, tp, tok, _, _ = _single_device_reference(11)
    mesh = LocalMesh((2, 4), ("dcn", "dp"), device="cpu")
    exact = _dp_step(mesh, tc, tp, tok, dcn_algorithm="psum")
    quant = _dp_step(mesh, tc, tp, tok, dcn_algorithm="int8")
    for (ep, el), (qp, ql) in zip(exact, quant):
        np.testing.assert_allclose(float(ql), float(el), rtol=1e-5)
        for a, b in zip(tt.tree_leaves(qp), tt.tree_leaves(ep)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                       atol=5e-4)


def test_dcn_axis_requires_dp_axis():
    jc, tc = _cfgs(**SMALL)
    _, tp = _params(jc, 9)
    tok = torch.zeros((2, SEQ), dtype=torch.int32)
    with pytest.raises(ValueError, match="dcn_axis requires dp_axis"):
        tt.train_step(tp, tok, tc, dcn_axis=object())


@pytest.mark.parametrize("axis", ["sp_axis", "tp_axis", "ep_axis"])
def test_model_parallel_training_refused(axis):
    """What sequence-, tensor- and expert-parallel training still
    refuses, for dense and MoE layers alike: under every axis an int8
    ``dcn_algorithm`` (the JAX package's vma path sums dp and dcn
    plainly and refuses it too); under sp a striped split (the JAX
    package's sp loss is contiguous only); under tp a psum min/max under
    autograd (``lax.pmax`` has no differentiation rule), while a manual
    ``tp_algorithm`` under autograd differentiates and gives the no-grad
    logits. An MoE loss on one card runs."""
    jc, tc = _cfgs(**SMALL)
    _, tp = _params(jc, 9)
    tok = torch.zeros((2, SEQ), dtype=torch.int32)
    moe = dataclasses.replace(tc, n_experts=4)
    mp = tt.init_params(moe, seed=9, device="cpu")
    assert torch.isfinite(tt.loss_fn(mp, tok, moe))
    for cfg, params in ((tc, tp), (moe, mp)):
        with pytest.raises(ValueError, match="cannot be compressed"):
            tt.train_step(params, tok, cfg, dp_axis=object(),
                          dcn_axis=object(), dcn_algorithm="int8",
                          **{axis: object()})
        if axis == "sp_axis":
            striped = dataclasses.replace(cfg, sp_layout="striped")
            with pytest.raises(ValueError, match="contiguous split"):
                tt.loss_fn(params, tok, striped, sp_axis=object())
        if axis == "tp_axis":
            def ring_forward(axes, params=params, cfg=cfg, grad=True):
                leaves = [t.detach().requires_grad_(grad)
                          for t in tt.tree_leaves(params)]
                logits = tt.forward(tt._rebuild(params, iter(leaves)), tok,
                                    cfg, tp_axis=axes["tp"],
                                    tp_algorithm="ring")
                if grad:
                    grads = torch.autograd.grad(logits.sum(), leaves,
                                                allow_unused=True)
                    assert all(g is None or torch.isfinite(g).all()
                               for g in grads)
                return logits.detach()
            mesh = LocalMesh((1,), ("tp",), device="cpu")
            (got,) = mesh.run(ring_forward)
            (want,) = mesh.run(lambda axes: ring_forward(axes, grad=False))
            assert torch.equal(got, want)

            def psum_max(axes, params=params):
                return allreduce(tt.tree_leaves(params)[0].detach()
                                 .requires_grad_(), axes["tp"], op="max",
                                 algorithm="psum")
            with pytest.raises(NotImplementedError, match="no backward"):
                mesh.run(psum_max)


def test_training_reduces_loss():
    """60 SGD steps on a learnable pattern (token t follows t-1 mod
    vocab), single device: the loss falls below 0.7 of its start."""
    jc, tc = _cfgs(**SMALL)
    _, params = _params(jc, 1)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(np.stack(
        [(rng.integers(0, 16) + np.arange(SEQ)) % 16
         for _ in range(4)]).astype(np.int32))
    losses = []
    for _ in range(60):
        params, loss = tt.train_step(params, tok, tc, lr=0.2)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
