"""The port's tensor-parallel inference against the JAX package on the CPU.

The port runs each rank as a thread of a ``device="cpu"`` ``LocalMesh``
on its slices of the params (``param_pspecs`` + ``shard_tree``); the JAX
package runs the same function under ``shard_jit`` on the 8-device CPU
mesh at the same tp and ``tp_algorithm`` (manual schedules with
check_vma off, as its own tests run them). Both take the JAX package's
params (``params_from_numpy``) and the same seeded numpy tokens. f32
config: vocab 61, d 64, 8 heads, 2 layers, d_ff 128; MHA + sincos and
GQA (4 kv heads) + RoPE.

Tolerances, the class of the JAX package's own tp tests: f32 logits and
caches rtol 2e-4 / atol 2e-4; bf16 logits rtol 2e-2 / atol 2e-2 (bf16
caches atol 4e-2: a few bf16 ulps of the residual); int8 caches (K6
dots in bf16 as the TPU kernel does, the JAX einsum path off a TPU in
f32) logits rtol 2e-2 / atol 2e-2, cache bytes within one quantisation
step. Greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from rlo_tpu.models import generate as jg
from rlo_tpu.models import transformer as jt
from rlo_tpu.parallel.mesh import make_mesh, shard_jit
from rlo_tpu_torch.convert import params_from_numpy
from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.parallel.sharding import (PartitionSpec, gather_tree,
                                             shard_tree)

BASE = dict(vocab=61, d_model=64, n_heads=8, n_layers=2, d_ff=128,
            dtype="float32")
VARIANTS = {"mha_sincos": {}, "gqa_rope": dict(n_kv_heads=4,
                                               pos_encoding="rope")}
ALGORITHMS = ("psum", "ring", "bidir_ring", "recursive_doubling",
              "halving_doubling")
TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(variant, **extra):
    kw = dict(BASE, **VARIANTS[variant], **extra)
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jc, tc = _cfgs(request.param)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], shape).astype(np.int32)


def _tp_run(tc, params, tp, fn):
    """fn(axis, rank's params) on every rank of a CPU tp mesh, grad off."""
    mesh = LocalMesh((tp,), ("tp",), device="cpu")
    shards = [shard_tree(params, tt.param_pspecs(tc, "tp"), mesh.axes(r))
              for r in range(tp)]

    def body(axes, p):
        with torch.no_grad():
            return fn(axes["tp"], p)
    return mesh.run(body, shards), mesh


def _jax_tp(jc, tp, fn, extra_in=(), out=JP(), check_vma=True):
    mesh = make_mesh((tp,), ("tp",))
    return shard_jit(fn, mesh, (jt.param_pspecs(jc, "tp"),) + extra_in,
                     out, check_vma=check_vma)


@pytest.mark.parametrize("moe", [False, True])
def test_param_pspecs_match_jax(model, moe):
    jc, tc, _, _ = model
    if moe:
        jc = dataclasses.replace(jc, n_experts=4)
        tc = dataclasses.replace(tc, n_experts=4)
    want = jt.param_pspecs(jc, "tp", "ep")
    got = tt.param_pspecs(tc, "tp", "ep")
    want_leaves, want_def = jax.tree.flatten(
        want, is_leaf=lambda x: isinstance(x, JP))
    got_leaves, got_def = jax.tree.flatten(
        got, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert got_def == want_def
    assert [tuple(g) for g in got_leaves] == [tuple(w) for w in want_leaves]
    assert all(isinstance(g, PartitionSpec) for g in got_leaves)


def test_shard_tree_round_trip(model):
    _, tc, _, tp_params = model
    mesh = LocalMesh((4,), ("tp",), device="cpu")
    specs = tt.param_pspecs(tc, "tp")
    shards = [shard_tree(tp_params, specs, mesh.axes(r)) for r in range(4)]
    layer, full = shards[2]["layers"][1], tp_params["layers"][1]
    n = full["wo"].shape[0] // 4
    assert torch.equal(layer["wo"], full["wo"][2 * n:3 * n])
    n = full["w1"].shape[1] // 4
    assert torch.equal(layer["w1"], full["w1"][:, 2 * n:3 * n])
    assert layer["w1"].is_contiguous()
    assert shards[2]["embed"].data_ptr() != tp_params["embed"].data_ptr()
    back = gather_tree(shards, specs, mesh)
    for a, b in zip(tt.tree_leaves(back), tt.tree_leaves(tp_params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tp", [2, 4])
def test_apply_layer_matches_jax(model, tp):
    jc, tc, jp, tp_params = model
    x = np.random.default_rng(1).standard_normal((2, 12, 64)) \
        .astype(np.float32)
    pos = np.arange(12)
    mesh = make_mesh((tp,), ("tp",))
    spec = jt.param_pspecs(jc, "tp")["layers"][0]
    want = shard_jit(
        lambda lp, xx: jt.apply_layer(xx, lp, jc, tp_axis="tp",
                                      pos=jnp.asarray(pos))[0],
        mesh, (spec, JP()), JP())(jp["layers"][0], jnp.asarray(x))
    outs, _ = _tp_run(tc, tp_params, tp, lambda ax, p: tt.apply_layer(
        torch.from_numpy(x), p["layers"][0], tc, tp_axis=ax,
        pos=torch.from_numpy(pos))[0])
    for o in outs:
        np.testing.assert_allclose(o.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tp,algorithm",
                         [(4, a) for a in ALGORITHMS] + [(2, "psum"),
                                                         (2, "ring")])
def test_forward_matches_jax(model, tp, algorithm):
    jc, tc, jp, tp_params = model
    tok = _tokens((2, 16), 3)
    want = _jax_tp(jc, tp, lambda p, t: jt.forward(
        p, t, jc, tp_axis="tp", tp_algorithm=algorithm), (JP(),),
        check_vma=algorithm == "psum")(jp, jnp.asarray(tok))
    outs, _ = _tp_run(tc, tp_params, tp, lambda ax, p: tt.forward(
        p, torch.from_numpy(tok), tc, tp_axis=ax, tp_algorithm=algorithm))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), **TOL)
    # the row-parallel sums leave the same bits on every rank
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_uneven_split_rejected():
    _, tc = _cfgs("mha_sincos")
    cfg = dataclasses.replace(tc, n_heads=4, d_ff=96)
    params = tt.init_params(cfg, device="cpu")
    layer = params["layers"][0]
    mesh = LocalMesh((8,), ("tp",), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        mesh.run(lambda axes: tt.apply_layer(
            torch.zeros(1, 2, 64), layer, cfg, tp_axis=axes["tp"]))
    with pytest.raises(ValueError, match="divide"):
        tg.init_kv_cache(dataclasses.replace(tc, n_kv_heads=2), 1, 4,
                         device="cpu", tp_axis=mesh.axes(0)["tp"])


@pytest.mark.parametrize("cache", ["act", "int8"])
def test_kv_cache_shapes_and_pspecs_match_jax(model, cache):
    jc, tc, _, _ = model
    kw = {} if cache == "act" else dict(kv_cache_dtype="int8")
    jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    want_specs = jg.kv_cache_pspecs(jc, "tp")
    got_specs = tg.kv_cache_pspecs(tc, "tp")
    assert [{k: tuple(v) for k, v in lc.items()} for lc in got_specs] == \
        [{k: tuple(v) for k, v in lc.items()} for lc in want_specs]
    want = jg.init_kv_cache(jc, 3, 7)
    got = LocalMesh((2,), ("tp",), device="cpu").run(
        lambda axes: tg.init_kv_cache(tc, 3, 7, device="cpu",
                                      tp_axis=axes["tp"]))
    for lg, lw in zip(got[0], want):
        assert set(lg) == set(lw)
        for key in lw:
            w = np.asarray(lw[key])
            # each rank holds half the K/V heads
            assert lg[key].shape[1] * 2 == w.shape[1]
            assert lg[key].shape[:1] + lg[key].shape[2:] == \
                w.shape[:1] + w.shape[2:]
            assert str(lg[key].dtype).split(".")[1] == w.dtype.name
            assert not lg[key].any()


def _decode_chain_jax(jc, jp, prompt, tok, block):
    """prefill, one decode_step, one T=4 block_decode at tp 2 (the cache
    gathered along its heads after each)."""
    b, plen = prompt.shape
    max_len = plen + 1 + block.shape[1]
    cspecs = jg.kv_cache_pspecs(jc, "tp")
    pspecs = jt.param_pspecs(jc, "tp")
    mesh = make_mesh((2,), ("tp",))
    pre = shard_jit(lambda p, t: jg.prefill(
        p, t, jg.init_kv_cache(jc, b, max_len, tp_axis="tp"), jc,
        tp_axis="tp"), mesh, (pspecs, JP()), (JP(), cspecs))
    l0, c0 = pre(jp, jnp.asarray(prompt))
    step = shard_jit(lambda p, t, c: jg.decode_step(
        p, t, plen, c, jc, tp_axis="tp"), mesh, (pspecs, JP(), cspecs),
        (JP(), cspecs))
    l1, c1 = step(jp, jnp.asarray(tok), c0)
    pos0 = jnp.full((b,), plen + 1, jnp.int32)
    blk = shard_jit(lambda p, t, c: jg.block_decode(
        p, t, pos0, c, jc, tp_axis="tp"), mesh,
        (pspecs, JP(), cspecs), (JP(), cspecs))
    l2, c2 = blk(jp, jnp.asarray(block), c1)
    return [np.asarray(x) for x in (l0, l1, l2)], \
        jax.tree.map(np.asarray, c2)


@pytest.mark.parametrize("cache", ["f32", "int8", "bf16"])
def test_prefill_decode_block_decode_match_jax(model, cache):
    """prefill, decode_step and block_decode (T = 4) at tp 2 on the
    rank's kv_heads/2 cache, against the JAX package's at tp 2; the
    gathered caches equal the JAX package's (int8: the same bytes)."""
    jc, tc, jp, tp_params = model
    kw = {"f32": {}, "int8": dict(kv_cache_dtype="int8"),
          "bf16": dict(dtype="bfloat16")}[cache]
    jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    tol = TOL if cache == "f32" else dict(rtol=2e-2, atol=2e-2)
    prompt, tok, block = _tokens((2, 7), 4), _tokens((2,), 5), \
        _tokens((2, 4), 6)
    want, want_cache = _decode_chain_jax(jc, jp, prompt, tok, block)
    b, plen = prompt.shape

    def chain(ax, p):
        c = tg.init_kv_cache(tc, b, plen + 5, device="cpu", tp_axis=ax)
        l0, c = tg.prefill(p, torch.from_numpy(prompt), c, tc, tp_axis=ax)
        l1, c = tg.decode_step(p, torch.from_numpy(tok), plen, c, tc,
                               tp_axis=ax)
        l2, c = tg.block_decode(p, torch.from_numpy(block), plen + 1, c, tc,
                                tp_axis=ax)
        return (l0, l1, l2), c

    outs, mesh = _tp_run(tc, tp_params, 2, chain)
    for got, w in zip(outs[0][0], want):
        np.testing.assert_allclose(got.float().numpy(), w, **tol)
    for r in range(1, 2):
        assert all(torch.equal(a, b)
                   for a, b in zip(outs[r][0], outs[0][0]))
    gathered = gather_tree([o[1] for o in outs], tg.kv_cache_pspecs(tc, "tp"),
                           mesh)
    for lg, lw in zip(gathered, want_cache):
        for key in lw:
            g = lg[key].float().numpy()
            w = np.asarray(lw[key]).astype(np.float32)
            if cache == "int8" and key in ("k", "v"):
                # one quantisation step where a value sits on a rounding
                # edge and the two products part in the last bit
                assert np.abs(g - w).max() <= 1
            elif cache == "bf16":
                # a bf16 rounding that parts in layer 0's residual (ulp
                # 2^-6 at |x| in 2..4) moves layer 1's K/V rows by a few
                # ulps of the residual
                np.testing.assert_allclose(g, w, rtol=2e-2, atol=4e-2)
            else:
                np.testing.assert_allclose(g, w, **tol)


def test_prefill_scan_matches_prefill_at_tp(model):
    jc, tc, jp, tp_params = model
    prompt = _tokens((2, 5), 7)

    def both(ax, p):
        a = tg.prefill(p, torch.from_numpy(prompt),
                       tg.init_kv_cache(tc, 2, 5, device="cpu", tp_axis=ax),
                       tc, tp_axis=ax)
        b = tg.prefill_scan(p, torch.from_numpy(prompt),
                            tg.init_kv_cache(tc, 2, 5, device="cpu",
                                             tp_axis=ax), tc, tp_axis=ax)
        return a, b

    outs, _ = _tp_run(tc, tp_params, 2, both)
    (la, ca), (lb, cb) = outs[1]
    np.testing.assert_allclose(la.numpy(), lb.numpy(), **TOL)
    for x, y in zip(tt.tree_leaves(ca), tt.tree_leaves(cb)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_generate_tokens_equal_jax(model, tp):
    jc, tc, jp, tp_params = model
    prompt = _tokens((2, 5), 8)
    want = np.asarray(_jax_tp(jc, tp, lambda p, t: jg.generate(
        p, t, jc, max_new=7, tp_axis="tp"), (JP(),))(jp,
                                                     jnp.asarray(prompt)))
    outs, _ = _tp_run(tc, tp_params, tp, lambda ax, p: tg.generate(
        p, torch.from_numpy(prompt), tc, max_new=7, tp_axis=ax))
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), want)
    single = tg.generate(tp_params, torch.from_numpy(prompt), tc, max_new=7)
    np.testing.assert_array_equal(single.numpy(), want)


def test_ragged_generate_at_tp(model):
    """Ragged prompts under tp: each row equals that row's own tp
    generate."""
    _, tc, _, tp_params = model
    lengths = [3, 6]
    prompt = _tokens((2, 6), 9)

    def gen(ax, p):
        out = tg.generate(p, torch.from_numpy(prompt), tc, max_new=4,
                          tp_axis=ax, prompt_lengths=lengths)
        rows = [tg.generate(p, torch.from_numpy(prompt[i:i + 1, :n]), tc,
                            max_new=4, tp_axis=ax)
                for i, n in enumerate(lengths)]
        return out, torch.cat(rows)

    outs, _ = _tp_run(tc, tp_params, 2, gen)
    for out, rows in outs:
        assert torch.equal(out, rows)


def test_sampling_picks_equal_on_every_rank(model):
    """temperature > 0 under tp: every rank's generator starts from the
    same seed and sees the same logits bits, so every rank samples the
    same tokens; a different seed samples other tokens."""
    _, tc, _, tp_params = model
    prompt = _tokens((3, 4), 10)

    def sample(ax, p, seed):
        g = torch.Generator().manual_seed(seed)
        return tg.generate(p, torch.from_numpy(prompt), tc, max_new=12,
                           temperature=1.0, generator=g, tp_axis=ax)

    mesh = LocalMesh((4,), ("tp",), device="cpu")
    shards = [shard_tree(tp_params, tt.param_pspecs(tc, "tp"), mesh.axes(r))
              for r in range(4)]
    same = mesh.run(lambda axes, p: sample(axes["tp"], p, 11), shards)
    assert all(torch.equal(s, same[0]) for s in same[1:])
    other = mesh.run(lambda axes, p: sample(axes["tp"], p, 12), shards)
    assert not torch.equal(other[0], same[0])
