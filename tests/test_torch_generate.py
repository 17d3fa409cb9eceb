"""The port's transformer layer, prefill, decode and generate against the
JAX package on the CPU, on the JAX package's own params carried across
with ``params_from_numpy`` (f32 tiny config: vocab 128, d 64, 4 heads,
2 layers; MHA + sincos and GQA + RoPE).

Tolerances: logits atol 1e-4 (f32; the two sides differ in summation
order, and the JAX package attends with its unfused einsum path off a
TPU); greedy tokens identical. int8 caches: K6 dots in bf16 as the TPU
kernel does, while the JAX einsum path off a TPU keeps f32, so logits
are held at rtol 2e-2 / atol 2e-2; the quantised cache bytes and scales
are identical for identical inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.models import generate as jg
from rlo_tpu.models import transformer as jt
from rlo_tpu_torch.convert import (cache_from_numpy, cache_to_numpy,
                                   params_from_numpy, params_to_numpy)
from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.models.moe import moe_ffn
from rlo_tpu_torch.ops.device_collectives import allreduce
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.utils.metrics import Registry

BASE = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            dtype="float32")
VARIANTS = {"mha_sincos": {}, "gqa_rope": dict(n_kv_heads=2,
                                               pos_encoding="rope")}


def _cfgs(variant, **extra):
    kw = dict(BASE, **VARIANTS[variant], **extra)
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jc, tc = _cfgs(request.param)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _prompt(b, plen, seed):
    return np.random.default_rng(seed).integers(0, BASE["vocab"],
                                                (b, plen)).astype(np.int32)


def test_init_params_tree_matches_jax(model):
    jc, tc, jp, _ = model
    mine = params_to_numpy(tt.init_params(tc, seed=1, device="cpu"))
    ref = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_apply_layer_matches_jax(model):
    jc, tc, jp, tp = model
    x = np.random.default_rng(1).standard_normal((2, 12, 64)) \
        .astype(np.float32)
    pos = np.arange(12)
    want, _ = jt.apply_layer(jnp.asarray(x), jp["layers"][0], jc,
                             pos=jnp.asarray(pos))
    got, aux = tt.apply_layer(torch.from_numpy(x), tp["layers"][0], tc,
                              pos=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(aux) == 0.0


def test_prefill_and_decode_match_jax(model):
    jc, tc, jp, tp = model
    prompt = _prompt(3, 9, seed=2)
    jl, jcache = jax.jit(lambda p, t, c: jg.prefill(p, t, c, jc))(
        jp, jnp.asarray(prompt), jg.init_kv_cache(jc, 3, 16))
    tcache = tg.init_kv_cache(tc, 3, 16, device="cpu")
    tl, out = tg.prefill(tp, torch.from_numpy(prompt), tcache, tc)
    assert out is tcache                           # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for a, b in zip(cache_to_numpy(tcache), jcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(a[key], np.asarray(b[key]),
                                       atol=1e-5)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for pos in (9, np.array([9, 4, 12], np.int32)):
        jl2, _ = jax.jit(lambda p, t, q, c: jg.decode_step(p, t, q, c, jc))(
            jp, jnp.asarray(tok), jnp.asarray(pos), jcache)
        tc2 = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
        tl2, _ = tg.decode_step(tp, torch.from_numpy(tok),
                                torch.as_tensor(pos), tc2, tc)
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4)


def test_block_decode_matches_jax(model):
    jc, tc, jp, tp = model
    prompt = _prompt(2, 6, seed=3)
    _, jcache = jax.jit(lambda p, t, c: jg.prefill(p, t, c, jc))(
        jp, jnp.asarray(prompt), jg.init_kv_cache(jc, 2, 20))
    toks = _prompt(2, 5, seed=4)
    pos0 = np.array([6, 3], np.int32)
    jl, jc2 = jax.jit(lambda p, t, q, c: jg.block_decode(p, t, q, c, jc))(
        jp, jnp.asarray(toks), jnp.asarray(pos0), jcache)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    tl, _ = tg.block_decode(tp, torch.from_numpy(toks),
                            torch.from_numpy(pos0), tcache, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for a, b in zip(cache_to_numpy(tcache), jc2):
        np.testing.assert_allclose(a["k"], np.asarray(b["k"]), atol=1e-5)


def test_generate_greedy_matches_jax(model):
    jc, tc, jp, tp = model
    prompt = _prompt(2, 7, seed=5)
    want = np.asarray(jax.jit(lambda p, t: jg.generate(p, t, jc, max_new=8))(
        jp, jnp.asarray(prompt)))
    got = tg.generate(tp, torch.from_numpy(prompt), tc, max_new=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_generate_matches_jax_and_per_row(model):
    jc, tc, jp, tp = model
    lengths = [3, 7, 5, 1]
    prompt = np.zeros((4, 7), np.int32)
    rng = np.random.default_rng(6)
    for i, n in enumerate(lengths):
        prompt[i, :n] = rng.integers(0, BASE["vocab"], n)
    want = np.asarray(jax.jit(lambda p, t, n: jg.generate(
        p, t, jc, max_new=6, max_len=13, prompt_lengths=n))(
        jp, jnp.asarray(prompt), jnp.asarray(lengths, jnp.int32)))
    got = tg.generate(tp, torch.from_numpy(prompt), tc, max_new=6,
                      max_len=13, prompt_lengths=lengths).numpy()
    np.testing.assert_array_equal(got, want)
    for i, n in enumerate(lengths):
        row = tg.generate(tp, torch.from_numpy(prompt[i:i + 1, :n]), tc,
                          max_new=6).numpy()
        np.testing.assert_array_equal(got[i], row[0])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_matches_prefill_scan(variant):
    """The port's one-forward prefill equals its own token-at-a-time
    scan (logits and every cache entry), as the JAX package pins."""
    _, tc = _cfgs(variant)
    tp = tt.init_params(tc, seed=3, device="cpu")
    prompt = torch.from_numpy(_prompt(2, 8, seed=4))
    la, ca = tg.prefill(tp, prompt, tg.init_kv_cache(tc, 2, 12, "cpu"), tc)
    lb, cb = tg.prefill_scan(tp, prompt, tg.init_kv_cache(tc, 2, 12, "cpu"),
                             tc)
    torch.testing.assert_close(la, lb, rtol=2e-4, atol=2e-4)
    for x, y in zip(ca, cb):
        for key in ("k", "v"):
            torch.testing.assert_close(x[key], y[key], rtol=2e-4, atol=2e-4)
        assert not x["k"][..., 8:].any()          # the tail stays zero


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_int8_cache_matches_jax(variant):
    jc, tc = _cfgs(variant, kv_cache_dtype="int8")
    jp = jt.init_params(jax.random.PRNGKey(7), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompt = _prompt(3, 9, seed=8)
    jl, jcache = jax.jit(lambda p, t, c: jg.prefill(p, t, c, jc))(
        jp, jnp.asarray(prompt), jg.init_kv_cache(jc, 3, 16))
    tl, _ = tg.prefill(tp, torch.from_numpy(prompt),
                       tg.init_kv_cache(tc, 3, 16, "cpu"), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2,
                               atol=2e-2)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jl2, jc2 = jax.jit(lambda p, t, c: jg.decode_step(p, t, 9, c, jc))(
        jp, jnp.asarray(tok), jcache)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    tl2, _ = tg.decode_step(tp, torch.from_numpy(tok), 9, tcache, tc)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=2e-2,
                               atol=2e-2)
    # the written column: layer 0 quantises rows that agree to f32
    # rounding (int8 within one step, scales within 1e-5); deeper layers
    # see the bf16-dot attention of the layers below, so their scales
    # agree to the logits' tolerance. Nothing else in the cache moves.
    for layer, (a, b) in enumerate(zip(cache_to_numpy(tcache), jc2)):
        for key in ("k", "v"):
            np.testing.assert_array_equal(a[key][..., :9],
                                          np.asarray(b[key])[..., :9])
            if layer == 0:
                diff = np.abs(a[key][..., 9].astype(int)
                              - np.asarray(b[key])[..., 9].astype(int))
                assert diff.max() <= 1
        for key in ("ks", "vs"):
            np.testing.assert_allclose(
                a[key], np.asarray(b[key]),
                rtol=1e-5 if layer == 0 else 2e-2)


def test_int8_write_is_identical_on_identical_rows():
    """Identical K/V rows quantise and land in the cache bit for bit as
    the compiled JAX decode write does (quantise, then the column
    update)."""
    rng = np.random.default_rng(9)
    k_row = (3 * rng.standard_normal((3, 2, 16))).astype(np.float32)
    v_row = (3 * rng.standard_normal((3, 2, 16))).astype(np.float32)
    pos = np.array([4, 0, 11], np.int32)

    @jax.jit
    def jax_write(k_row, v_row):
        (qk, ks), (qv, vs) = jg._quantize_kv(k_row), jg._quantize_kv(v_row)
        r, h = jnp.arange(3)[:, None], jnp.arange(2)[None, :]
        c = jnp.zeros((3, 2, 16, 12), jnp.int8)
        s = jnp.zeros((3, 2, 12), jnp.float32)
        d = jnp.arange(16)[None, None, :]
        idx = (r[..., None], h[..., None], d, jnp.asarray(pos)[:, None, None])
        return (c.at[idx].set(qk), c.at[idx].set(qv),
                s.at[r, h, jnp.asarray(pos)[:, None]].set(ks),
                s.at[r, h, jnp.asarray(pos)[:, None]].set(vs))

    want = [np.asarray(x) for x in jax_write(k_row, v_row)]
    lc = {"k": torch.zeros(3, 2, 16, 12, dtype=torch.int8),
          "v": torch.zeros(3, 2, 16, 12, dtype=torch.int8),
          "ks": torch.zeros(3, 2, 12), "vs": torch.zeros(3, 2, 12)}
    tg._write_rows(lc, torch.from_numpy(k_row), torch.from_numpy(v_row),
                   torch.from_numpy(pos))
    for key, w in zip(("k", "v", "ks", "vs"), want):
        np.testing.assert_array_equal(lc[key].numpy(), w)


def test_generate_timed_same_tokens_and_metrics(model):
    _, tc, _, tp = model
    prompt = torch.from_numpy(_prompt(2, 5, seed=10))
    reg = Registry()
    got = tg.generate_timed(tp, prompt, tc, max_new=4, metrics=reg)
    torch.testing.assert_close(got, tg.generate(tp, prompt, tc, max_new=4))
    snap = reg.snapshot()
    assert snap["counters"]["serve.tokens_out"] == 8
    assert snap["histograms"]["serve.ttft_usec"]["count"] == 1
    assert snap["histograms"]["serve.tok_usec"]["count"] == 1


def test_sampling_contract(model):
    _, tc, _, tp = model
    prompt = torch.from_numpy(_prompt(2, 5, seed=11))
    with pytest.raises(ValueError, match="generator"):
        tg.generate(tp, prompt, tc, max_new=2, temperature=0.7)
    g = torch.Generator().manual_seed(0)
    out = tg.generate(tp, prompt, tc, max_new=4, temperature=0.7,
                      generator=g)
    assert out.shape == (2, 4) and int(out.max()) < BASE["vocab"]
    with pytest.raises(ValueError, match="exceeds max_len"):
        tg.generate(tp, prompt, tc, max_new=4, max_len=6)


def test_later_slices_raise():
    """Inference and training run with the sp/tp/ep axes
    (tests/test_torch_{tensor,expert,sequence}_parallel.py,
    tests/test_torch_model_parallel_train.py); what the port still
    refuses, as the JAX package does, raises: the loss of a striped
    sequence split, an int8 ``dcn_algorithm`` beside any of the axes,
    and a psum min/max under autograd (``lax.pmax`` has no
    differentiation rule). ``forward`` under autograd with a manual
    ``tp_algorithm`` runs and gives the logits of ``no_grad``."""
    _, tc = _cfgs("mha_sincos")
    moe = dataclasses.replace(tc, n_experts=2)
    params = {False: tt.init_params(tc, device="cpu"),
              True: tt.init_params(moe, device="cpu")}
    tok = torch.zeros((1, 4), dtype=torch.int32)
    for axis in ("sp_axis", "tp_axis", "ep_axis"):
        cfg = moe if axis == "ep_axis" else tc
        p = params[axis == "ep_axis"]
        with pytest.raises(ValueError, match="contiguous split"):
            tt.loss_fn(p, tok, dataclasses.replace(cfg, sp_layout="striped"),
                       sp_axis=object())
        with pytest.raises(ValueError, match="cannot be compressed"):
            tt.grads_and_loss(p, tok, cfg, dp_axis=object(),
                              dcn_axis=object(), dcn_algorithm="int8",
                              **{axis: object()})

        def ring_forward(axes, p=p, cfg=cfg, grad=True):
            live = tt._rebuild(p, iter(t.detach().requires_grad_(grad)
                                       for t in tt.tree_leaves(p)))
            return tt.forward(live, tok, cfg, tp_axis=axes["tp"],
                              tp_algorithm="ring")
        mesh = LocalMesh((1,), ("tp",), device="cpu")
        (got,) = mesh.run(ring_forward)
        assert got.requires_grad
        (want,) = mesh.run(lambda axes: ring_forward(axes, grad=False))
        assert torch.equal(got.detach(), want)

        def psum_max(axes, p=p):
            return allreduce(tt.tree_leaves(p)[0].detach().requires_grad_(),
                             axes["tp"], op="max", algorithm="psum")
        with pytest.raises(NotImplementedError, match="no backward"):
            mesh.run(psum_max)
    x = torch.zeros(1, 2, 64)
    layer = params[True]["layers"][0]
    with torch.no_grad():
        out, aux = moe_ffn(layer["moe"], x, 2)
        assert out.shape == x.shape and torch.isfinite(aux)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, tc = _cfgs("mha_sincos")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.init_kv_cache(tc, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(tc)
