"""The port's sequence-parallel attention and forward against the JAX
package on the CPU.

The port runs each rank as a thread of a ``device="cpu"`` ``LocalMesh``
holding its block of the sequence; the JAX package runs the same function
under ``shard_jit`` on the 8-device CPU mesh with the sequence split
``P("sp")``. Same seeded numpy inputs, f32.

Tolerances: attention outputs rtol 2e-5 / atol 2e-5 (the JAX package's
ring tests against full attention); forward logits rtol 2e-4 / atol 2e-4
(its sp/tp forward class); ``stripe_sequence``/``unstripe_sequence``
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from rlo_tpu.models import transformer as jt
from rlo_tpu.ops import ring_attention as jr
from rlo_tpu.ops import ulysses as ju
from rlo_tpu.parallel.mesh import make_mesh, shard_jit
from rlo_tpu_torch.convert import params_from_numpy
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.ops import ring_attention as tr
from rlo_tpu_torch.ops import ulysses as tu
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.parallel.sharding import shard_tree

WS = 4
ATT_TOL = dict(rtol=2e-5, atol=2e-5)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, seq, heads, kv_heads, dim):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((seq, h, dim)) * 0.5).astype(np.float32)
            for h in (heads, kv_heads, kv_heads)]


def _sp_run(fn, *full, ws=WS):
    """fn(axis, *rank's blocks) on every rank of a CPU sp mesh (each
    full array split along axis 0), outputs concatenated back."""
    parts = [list(torch.from_numpy(np.array(a)).chunk(ws)) for a in full]
    mesh = LocalMesh((ws,), ("sp",), device="cpu")

    def body(axes, *blocks):
        with torch.no_grad():
            return fn(axes["sp"], *(b.contiguous() for b in blocks))
    return torch.cat(mesh.run(body, *parts)).numpy()


def _jax_sp(fn, *full):
    mesh = make_mesh((WS,), ("sp",))
    specs = tuple(JP("sp") for _ in full)
    return np.asarray(shard_jit(fn, mesh, specs, JP("sp"))(
        *(jnp.asarray(a) for a in full)))


@pytest.mark.parametrize("shape", [(16, 3), (12, 5, 2)])
def test_stripe_round_trip_matches_jax(shape):
    x = np.arange(np.prod(shape)).reshape(shape).astype(np.float32)
    got = tr.stripe_sequence(torch.from_numpy(x), WS)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jr.stripe_sequence(jnp.asarray(x), WS)))
    back = tr.unstripe_sequence(got, WS)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jr.unstripe_sequence(
            jr.stripe_sequence(jnp.asarray(x), WS), WS)))
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="divide"):
        tr.stripe_sequence(torch.zeros(7, 2), WS)


@pytest.mark.parametrize("layout", ["contiguous", "striped"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (6, 1)])
def test_ring_attention_matches_jax_and_full(layout, causal, heads,
                                             kv_heads):
    q, k, v = _qkv(0, 32, heads, kv_heads, 16)
    if layout == "striped":
        q, k, v = (np.asarray(jr.stripe_sequence(jnp.asarray(a), WS))
                   for a in (q, k, v))
    want = _jax_sp(lambda a, b, c: jr.ring_attention(
        a, b, c, "sp", causal=causal, layout=layout), q, k, v)
    got = _sp_run(lambda ax, a, b, c: tr.ring_attention(
        a, b, c, ax, causal=causal, layout=layout), q, k, v)
    np.testing.assert_allclose(got, want, **ATT_TOL)
    g = heads // kv_heads
    full = tr.full_attention(
        *(torch.from_numpy(a) for a in (q, np.repeat(k, g, 1),
                                        np.repeat(v, g, 1))),
        causal=causal).numpy() if layout == "contiguous" else None
    if full is not None:
        np.testing.assert_allclose(got, full, **ATT_TOL)
        np.testing.assert_allclose(full, np.asarray(jr.full_attention(
            *(jnp.asarray(a) for a in (q, np.repeat(k, g, 1),
                                       np.repeat(v, g, 1))),
            causal=causal)), **ATT_TOL)


@pytest.mark.parametrize("algorithm", ["xla", "direct", "ring"])
@pytest.mark.parametrize("heads,kv_heads", [(8, 8), (8, 4), (8, 2)])
def test_ulysses_matches_jax(algorithm, heads, kv_heads):
    """kv heads 8 and 4 divide the axis (compact K/V crosses); 2 does
    not (repeated by the smallest factor, 2)."""
    q, k, v = _qkv(1, 32, heads, kv_heads, 16)
    want = _jax_sp(lambda a, b, c: ju.ulysses_attention(
        a, b, c, "sp", causal=True, algorithm=algorithm), q, k, v)
    got = _sp_run(lambda ax, a, b, c: tu.ulysses_attention(
        a, b, c, ax, causal=True, algorithm=algorithm), q, k, v)
    np.testing.assert_allclose(got, want, **ATT_TOL)
    g = heads // kv_heads
    full = tr.full_attention(*(torch.from_numpy(a) for a in (
        q, np.repeat(k, g, 1), np.repeat(v, g, 1))), causal=True).numpy()
    np.testing.assert_allclose(got, full, **ATT_TOL)


def test_ulysses_heads_must_divide():
    q, k, v = (torch.zeros(8, 6, 16) for _ in range(3))
    mesh = LocalMesh((WS,), ("sp",), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        mesh.run(lambda axes: tu.ulysses_attention(q, k, v, axes["sp"]))


BASE = dict(vocab=61, d_model=64, n_heads=8, n_layers=2, d_ff=128,
            dtype="float32")
VARIANTS = {"mha_sincos": {}, "gqa_rope": dict(n_kv_heads=4,
                                               pos_encoding="rope")}


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jc = jt.TransformerConfig(**BASE, **VARIANTS[request.param])
    tc = tt.TransformerConfig(**BASE, **VARIANTS[request.param])
    jp = jt.init_params(jax.random.PRNGKey(3), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], shape).astype(np.int32)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_forward_sp_matches_jax(model, attention):
    jc, tc, jp, tp_ = model
    jc = dataclasses.replace(jc, sp_attention=attention)
    tc = dataclasses.replace(tc, sp_attention=attention)
    tok = _tokens((2, 32), 4)
    want = np.asarray(shard_jit(
        lambda p, t: jt.forward(p, t, jc, sp_axis="sp"),
        make_mesh((WS,), ("sp",)), (jt.param_pspecs(jc), JP(None, "sp")),
        JP(None, "sp"))(jp, jnp.asarray(tok)))
    got = _sp_run(lambda ax, t: tt.forward(tp_, t.t(), tc, sp_axis=ax).transpose(0, 1),
                  tok.T.copy())
    np.testing.assert_allclose(got.transpose(1, 0, 2), want, **FWD_TOL)
    with torch.no_grad():
        single = tt.forward(tp_, torch.from_numpy(tok), tc).numpy()
    np.testing.assert_allclose(got.transpose(1, 0, 2), single, **FWD_TOL)


def test_forward_sp_striped_equals_single_rank(model):
    """The striped split (the port's ``sp_layout``; the JAX package's
    forward is contiguous only): stripe the tokens, run, unstripe the
    logits; equal to the single-rank forward."""
    _, tc, _, tp_ = model
    tc = dataclasses.replace(tc, sp_layout="striped")
    tok = _tokens((2, 32), 5)
    striped = tr.stripe_sequence(torch.from_numpy(tok.T.copy()), WS).numpy()
    got = _sp_run(lambda ax, t: tt.forward(tp_, t.t(), tc, sp_axis=ax)
                  .transpose(0, 1), striped)
    got = tr.unstripe_sequence(torch.from_numpy(got), WS).numpy()
    with torch.no_grad():
        single = tt.forward(tp_, torch.from_numpy(tok), tc).numpy()
    np.testing.assert_allclose(got.transpose(1, 0, 2), single, **FWD_TOL)
    bad = dataclasses.replace(tc, sp_attention="ulysses")
    with pytest.raises(ValueError, match="contiguous"):
        _sp_run(lambda ax, t: tt.forward(tp_, t.t(), bad, sp_axis=ax),
                striped)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_forward_on_sp_tp_mesh_matches_jax(model, attention):
    """A 2-D (sp, tp) = (2, 2) mesh: the sequence over sp, heads and
    hidden units over tp (Ulysses scatters the tp-local heads)."""
    jc, tc, jp, tp_ = model
    jc = dataclasses.replace(jc, sp_attention=attention)
    tc = dataclasses.replace(tc, sp_attention=attention)
    tok = _tokens((2, 16), 6)
    want = np.asarray(shard_jit(
        lambda p, t: jt.forward(p, t, jc, sp_axis="sp", tp_axis="tp"),
        make_mesh((2, 2), ("sp", "tp")),
        (jt.param_pspecs(jc, "tp"), JP(None, "sp")), JP(None, "sp"))(
        jp, jnp.asarray(tok)))
    mesh = LocalMesh((2, 2), ("sp", "tp"), device="cpu")
    specs = tt.param_pspecs(tc, "tp")
    shards, blocks = [], []
    for r in range(4):
        axes = mesh.axes(r)
        shards.append(shard_tree(tp_, specs, axes))
        i = axes["sp"].index
        blocks.append(torch.from_numpy(tok[:, 8 * i:8 * (i + 1)].copy()))

    def body(axes, p, t):
        with torch.no_grad():
            return tt.forward(p, t, tc, sp_axis=axes["sp"],
                              tp_axis=axes["tp"])
    outs = mesh.run(body, shards, blocks)
    # ranks (sp i, tp 0) and (sp i, tp 1) hold the same block
    for i in range(2):
        assert torch.equal(outs[2 * i], outs[2 * i + 1])
    got = torch.cat([outs[0], outs[2]], dim=1).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("axis", ["sp_axis", "tp_axis", "ep_axis"])
def test_forward_with_an_axis_under_grad_raises(axis):
    """Grad mode on: forward with an axis differentiates on a CPU
    LocalMesh (each rank's backward runs on its own thread, with the
    collectives' transposes inside it) and gives the logits it gives
    under no_grad; what still raises under autograd is a manual tp
    schedule (its steps accumulate in place and have no backward),
    refused before any rank enters a collective, so the LocalMesh
    neither runs nor hangs."""
    cfg = tt.TransformerConfig(**dict(BASE, n_experts=4) if axis == "ep_axis"
                               else BASE)
    params = tt.init_params(cfg, device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.int32)
    mesh = LocalMesh((2,), ("x",), device="cpu", timeout=20.0)
    specs = tt.param_pspecs(cfg, "x" if axis == "tp_axis" else None,
                            "x" if axis == "ep_axis" else None)

    def run(axes, grad, specs=specs, **kw):
        p = shard_tree(params, specs, axes)
        leaves = [t.requires_grad_(grad) for t in tt.tree_leaves(p)]
        logits = tt.forward(p, tok, cfg, **kw)
        if grad:
            grads = torch.autograd.grad(logits.sum(), leaves)
            assert all(torch.isfinite(g).all() for g in grads)
        return logits.detach()
    with torch.no_grad():
        want = mesh.run(lambda axes: run(axes, False, **{axis: axes["x"]}))
    got = mesh.run(lambda axes: run(axes, True, **{axis: axes["x"]}))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(NotImplementedError, match="no backward"):
        mesh.run(lambda axes: run(axes, True, tt.param_pspecs(cfg, "x"),
                                  tp_axis=axes["x"], tp_algorithm="ring"))
    with torch.no_grad():
        assert torch.isfinite(tt.forward(params, tok, cfg)).all()
