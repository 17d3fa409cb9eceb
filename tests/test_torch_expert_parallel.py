"""The port's expert-parallel MoE against the JAX package on the CPU.

The port runs each rank as a thread of a ``device="cpu"`` ``LocalMesh``
holding E/ep experts (``param_pspecs(ep_axis=...)`` + ``shard_tree``)
and its own tokens; the JAX package runs the same function under
``shard_jit`` on the 8-device CPU mesh with the tokens split ``P("ep")``.
Both take the JAX package's params and the same seeded numpy inputs, in
f32.

Tolerances: ``moe_ffn`` outputs rtol 1e-5 / atol 1e-5 and the rank's aux
term rtol 1e-6 (the routing is the same; the expert products' order is
not); forward logits rtol 2e-4 / atol 2e-4 (the JAX package's own tp/ep
test class). Greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from rlo_tpu.models import generate as jg
from rlo_tpu.models import moe as jm
from rlo_tpu.models import transformer as jt
from rlo_tpu.parallel.mesh import make_mesh, shard_jit
from rlo_tpu_torch.convert import params_from_numpy
from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import moe as tm
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.parallel.sharding import PartitionSpec as P
from rlo_tpu_torch.parallel.sharding import shard_tree

D, F, E = 16, 32, 8
MOE_SPECS_J = {"wr": JP(), "w1": JP("ep", None, None),
               "w2": JP("ep", None, None)}
MOE_SPECS_T = {"wr": P(), "w1": P("ep", None, None),
               "w2": P("ep", None, None)}
CFG = dict(vocab=61, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           dtype="float32", n_experts=4, capacity_factor=4.0)


def _ep_run(params, specs, ep, fn, *per_rank):
    """fn(axis, rank's params, *rank's args) on every rank of a CPU ep
    mesh, grad off."""
    mesh = LocalMesh((ep,), ("ep",), device="cpu")
    shards = [shard_tree(params, specs, mesh.axes(r)) for r in range(ep)]

    def body(axes, p, *args):
        with torch.no_grad():
            return fn(axes["ep"], p, *args)
    return mesh.run(body, shards, *per_rank)


@pytest.fixture(scope="module")
def moe_params():
    jp = jm.init_moe_params(jax.random.PRNGKey(1), D, F, E)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("algorithm", ["xla", "direct", "ring"])
@pytest.mark.parametrize("capacity", ["one", "default", "drop_free"])
def test_moe_ffn_matches_jax(moe_params, capacity, algorithm):
    """Each rank's output rows and aux term against the JAX package's
    shard of the same ep=4 run (12 tokens a rank): at capacity 1 most
    rows drop, at the default factor some, drop-free none."""
    jp, tp_ = moe_params
    ep, t = 4, 12
    cf = {"one": 0.01, "default": 2.0, "drop_free": float(E)}[capacity]
    h = np.random.default_rng(2).standard_normal((ep * t, D)) \
        .astype(np.float32)
    mesh = make_mesh((ep,), ("ep",))
    out_j, aux_j = shard_jit(
        lambda p, x: (lambda o, a: (o, a[None]))(*jm.moe_ffn(
            p, x, E, capacity_factor=cf, ep_axis="ep",
            all_to_all_algorithm=algorithm)),
        mesh, (MOE_SPECS_J, JP("ep")), (JP("ep"), JP("ep")),
        check_vma=algorithm == "xla")(jp, jnp.asarray(h))
    rows = [torch.from_numpy(h[r * t:(r + 1) * t]) for r in range(ep)]
    got = _ep_run(tp_, MOE_SPECS_T, ep, lambda ax, p, x: tm.moe_ffn(
        p, x, E, capacity_factor=cf, ep_axis=ax,
        all_to_all_algorithm=algorithm), rows)
    out = torch.cat([o for o, _ in got]).numpy()
    np.testing.assert_allclose(out, np.asarray(out_j), rtol=1e-5, atol=1e-5)
    # each rank's aux is its own tokens' term (nothing summed over ep)
    np.testing.assert_allclose([float(a) for _, a in got],
                               np.asarray(aux_j), rtol=1e-6)
    dropped = (np.abs(out).max(axis=1) == 0).sum()
    assert (dropped > 0) == (capacity != "drop_free")


def test_moe_ffn_ep_equals_single_rank_drop_free(moe_params):
    """Drop-free, the split experts give each token what the single-rank
    dispatch gives it."""
    _, tp_ = moe_params
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2 * 10, D)).astype(np.float32))
    want, _ = tm.moe_ffn(tp_, h, E, capacity_factor=float(E))
    got = _ep_run(tp_, MOE_SPECS_T, 2, lambda ax, p, x: tm.moe_ffn(
        p, x, E, capacity_factor=float(E), ep_axis=ax)[0],
        list(h.chunk(2)))
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_moe_ffn_rejects_a_wrong_shard(moe_params):
    _, tp_ = moe_params
    mesh = LocalMesh((2,), ("ep",), device="cpu")
    with pytest.raises(ValueError, match="expert shards"):
        mesh.run(lambda axes: tm.moe_ffn(tp_, torch.zeros(4, D), E,
                                         ep_axis=axes["ep"]))


@pytest.fixture(scope="module")
def model():
    jc, tc = jt.TransformerConfig(**CFG), tt.TransformerConfig(**CFG)
    jp = jt.init_params(jax.random.PRNGKey(5), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab"], shape).astype(np.int32)


@pytest.mark.parametrize("ep", [2, 4])
def test_forward_matches_jax(model, ep):
    """forward(ep_axis) with the batch rows split, logits and each rank's
    aux against the JAX package's at the same ep."""
    jc, tc, jp, tp_ = model
    tok = _tokens((ep, 12), 6)
    logits_j, aux_j = shard_jit(
        lambda p, t: (lambda lg, a: (lg, a[None]))(*jt.forward(
            p, t, jc, ep_axis="ep", with_aux=True)),
        make_mesh((ep,), ("ep",)), (jt.param_pspecs(jc, ep_axis="ep"),
                                    JP("ep")), (JP("ep"), JP("ep")))(
        jp, jnp.asarray(tok))
    got = _ep_run(tp_, tt.param_pspecs(tc, ep_axis="ep"), ep,
                  lambda ax, p, t: tt.forward(p, t, tc, ep_axis=ax,
                                              with_aux=True),
                  [torch.from_numpy(tok[r:r + 1]) for r in range(ep)])
    np.testing.assert_allclose(torch.cat([lg for lg, _ in got]).numpy(),
                               np.asarray(logits_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose([float(a) for _, a in got],
                               np.asarray(aux_j), rtol=1e-5)


@pytest.mark.parametrize("algorithm", ["xla", "direct"])
def test_generate_matches_jax_and_single_rank(model, algorithm):
    """generate(ep_axis) with 2 rows a rank, drop-free decode: tokens
    equal the JAX package's ep generate and the single-rank port's over
    the whole batch."""
    jc, tc, jp, tp_ = model
    ep, prompt = 2, _tokens((4, 6), 7)
    want = np.asarray(shard_jit(
        lambda p, t: jg.generate(p, t, jc, max_new=6, ep_axis="ep"),
        make_mesh((ep,), ("ep",)), (jt.param_pspecs(jc, ep_axis="ep"),
                                    JP("ep")), JP("ep"))(
        jp, jnp.asarray(prompt)))
    got = _ep_run(tp_, tt.param_pspecs(tc, ep_axis="ep"), ep,
                  lambda ax, p, t: tg.generate(
                      p, t, tc, max_new=6, ep_axis=ax,
                      all_to_all_algorithm=algorithm),
                  [torch.from_numpy(prompt[2 * r:2 * r + 2])
                   for r in range(ep)])
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    single = tg.generate(tp_, torch.from_numpy(prompt), tc, max_new=6)
    np.testing.assert_array_equal(single.numpy(), want)


def test_ragged_generate_at_ep(model):
    """Ragged prompts split over ep: every row equals its own prompt's
    single-rank generate (drop-free routing keeps padding inert)."""
    _, tc, _, tp_ = model
    lengths, prompt = [3, 6, 1, 5], _tokens((4, 6), 8)
    got = _ep_run(tp_, tt.param_pspecs(tc, ep_axis="ep"), 2,
                  lambda ax, p, t, n: tg.generate(p, t, tc, max_new=5,
                                                  ep_axis=ax,
                                                  prompt_lengths=n),
                  [torch.from_numpy(prompt[2 * r:2 * r + 2])
                   for r in range(2)],
                  [lengths[2 * r:2 * r + 2] for r in range(2)])
    got = torch.cat(got)
    for i, n in enumerate(lengths):
        want = tg.generate(tp_, torch.from_numpy(prompt[i:i + 1, :n]), tc,
                           max_new=5)
        assert torch.equal(got[i], want[0]), i


def test_decode_step_and_block_decode_at_ep(model):
    """decode_step and block_decode (T = 4) with the rows split equal
    the single-rank calls (drop-free: every token routes as alone)."""
    _, tc, _, tp_ = model
    prompt, tok, block = _tokens((4, 5), 9), _tokens((4,), 10), \
        _tokens((4, 4), 11)

    def chain(p, t, tk, bl, ax=None):
        c = tg.init_kv_cache(tc, t.shape[0], 10, device="cpu")
        _, c = tg.prefill(p, t, c, tc, ep_axis=ax)
        l1, c = tg.decode_step(p, tk, 5, c, tc, ep_axis=ax)
        l2, _ = tg.block_decode(p, bl, 6, c, tc, ep_axis=ax)
        return l1, l2

    with torch.no_grad():
        w1, w2 = chain(tp_, *(torch.from_numpy(a)
                              for a in (prompt, tok, block)))
    got = _ep_run(tp_, tt.param_pspecs(tc, ep_axis="ep"), 2,
                  lambda ax, p, t, tk, bl: chain(p, t, tk, bl, ax),
                  *[[torch.from_numpy(a[2 * r:2 * r + 2]) for r in range(2)]
                    for a in (prompt, tok, block)])
    np.testing.assert_allclose(torch.cat([g[0] for g in got]).numpy(),
                               w1.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(torch.cat([g[1] for g in got]).numpy(),
                               w2.numpy(), rtol=2e-4, atol=2e-4)
