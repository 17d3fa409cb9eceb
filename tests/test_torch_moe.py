"""The port's mixture-of-experts layers against the JAX package on the CPU.

``moe_ffn`` against ``rlo_tpu.models.moe.moe_ffn`` (out, aux and
grads), with forced drops at capacity 1, at the default capacity and
drop-free, through both dispatch routes (the padded block and the
per-expert products over the sorted rows); the MoE transformer's
params, loss and grads; and its decode, ragged prefill, generate, paged
decode and both ``DecodeServer`` modes against the JAX package's, on
the JAX package's own params carried across with ``params_from_numpy``.

Tolerances are the reference's own (``tests/test_expert_parallel.py``,
``tests/test_transformer.py``): out and grads rtol 2e-4 / atol 2e-5,
aux and loss rtol 1e-5, logits rtol 1e-5 / atol 1e-6 (f32, summation
order only); tokens identical. The seeds give router gates without near
ties (``test_seeds_have_no_router_near_ties`` checks the margins of
``moe_ffn``'s cases), so the two frameworks pick the same experts.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.models import generate as jg
from rlo_tpu.models import moe as jm
from rlo_tpu.models import paged as jpaged
from rlo_tpu.models import serve as js
from rlo_tpu.models import transformer as jt
from rlo_tpu.utils.metrics import Registry as JaxRegistry
from rlo_tpu_torch.convert import (cache_from_numpy, params_from_numpy,
                                   params_to_numpy)
from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import moe as tm
from rlo_tpu_torch.models import paged as tpaged
from rlo_tpu_torch.models import serve as ts
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.utils.metrics import Registry

D, F, E, T = 16, 32, 8, 24
KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          dtype="float32", n_experts=4)
#: capacity factors: C = 1 (most tokens dropped), the default 2.0, and
#: drop-free (>= E)
CAPACITY = {"drops": 0.25, "default": 2.0, "drop_free": float(E)}


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _moe_case(seed):
    params = jm.init_moe_params(jax.random.PRNGKey(seed), D, F, E)
    h = np.random.default_rng(seed).standard_normal((T, D)) \
        .astype(np.float32)
    return params, h


@pytest.fixture(params=["padded", "sorted"])
def route(request, monkeypatch):
    """The dispatch route: ``sorted`` forces the per-expert products."""
    if request.param == "sorted":
        monkeypatch.setattr(tm, "PAD_ROWS", 0)
        monkeypatch.setattr(tm, "PAD_RATIO", 0)
    return request.param


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_moe_ffn_matches_jax(capacity, route):
    jp, h = _moe_case(1)
    cf = CAPACITY[capacity]
    want, want_aux = jm.moe_ffn(jp, jnp.asarray(h), E, capacity_factor=cf)
    got, aux = tm.moe_ffn(_to_torch(jp), torch.from_numpy(h), E,
                          capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    dropped = int((np.abs(np.asarray(want)).max(-1) == 0).sum())
    assert dropped == {"drops": T - E, "default": 1, "drop_free": 0}[
        capacity]
    assert np.array_equal(got.numpy().max(-1) == 0,
                          np.asarray(want).max(-1) == 0)


def test_capacity_one_keeps_the_first_token(route):
    """The reference's forced routing: every token to expert 2 at
    capacity 1 keeps only the first; the rest come out 0."""
    jp = jm.init_moe_params(jax.random.PRNGKey(0), 8, 16, 4)
    wr = np.zeros((8, 4), np.float32)
    wr[:, 2] = 100.0
    jp["wr"] = jnp.asarray(wr)
    h = np.ones((4, 8), np.float32)
    want, want_aux = jm.moe_ffn(jp, jnp.asarray(h), 4, capacity_factor=0.25)
    got, aux = tm.moe_ffn(_to_torch(jp), torch.from_numpy(h), 4,
                          capacity_factor=0.25)
    assert np.abs(got[0].numpy()).max() > 0
    np.testing.assert_array_equal(got[1:].numpy(), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("capacity", ["drops", "default"])
def test_moe_ffn_grads_match_jax(capacity, route):
    """d/d(params, h) of sum(out * R) + aux, through the gate
    probability, the expert weights and the aux term."""
    jp, h = _moe_case(2)
    cf = CAPACITY[capacity]
    r = np.random.default_rng(3).standard_normal((T, D)).astype(np.float32)

    def jloss(p, x):
        out, aux = jm.moe_ffn(p, x, E, capacity_factor=cf)
        return jnp.sum(out * r) + aux

    jgp, jgh = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(h))
    tp = {k: v.requires_grad_(True) for k, v in _to_torch(jp).items()}
    th = torch.from_numpy(h).requires_grad_(True)
    out, aux = tm.moe_ffn(tp, th, E, capacity_factor=cf)
    ((out * torch.from_numpy(r)).sum() + aux).backward()
    for k in ("wr", "w1", "w2"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=2e-4,
                               atol=2e-5)


def test_seeds_have_no_router_near_ties():
    """The top-1 margins of every routing the file's MoE tests make stay
    far above f32's resolution, so both frameworks pick the same
    experts."""
    for seed in (1, 2):
        jp, h = _moe_case(seed)
        g = np.sort(np.asarray(jax.nn.softmax(h @ np.asarray(jp["wr"]))),
                    axis=-1)
        assert (g[:, -1] - g[:, -2]).min() > 1e-4, seed


def test_ep_axis_raises():
    """Expert parallelism runs (tests/test_torch_expert_parallel.py);
    under an ep axis, weights that are not the rank's E/ep experts
    raise."""
    from rlo_tpu_torch.parallel.mesh import LocalMesh
    jp, h = _moe_case(1)
    mesh = LocalMesh((2,), ("ep",), device="cpu")
    with pytest.raises(ValueError, match="expert shards"):
        mesh.run(lambda axes: tm.moe_ffn(_to_torch(jp), torch.from_numpy(h),
                                         E, ep_axis=axes["ep"]))


def test_init_moe_params_shapes():
    got = tm.init_moe_params(torch.Generator().manual_seed(0), D, F, E)
    want = jm.init_moe_params(jax.random.PRNGKey(0), D, F, E)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == \
            torch.float32
        # the same scales: the draws' spread within 10 % of the reference's
        assert math.isclose(float(got[k].std()), float(jnp.std(v)),
                            rel_tol=0.1), k


# ---------------------------------------------------------------------------
# the MoE transformer
# ---------------------------------------------------------------------------

def _model(seed=0, **extra):
    jc = jt.TransformerConfig(**KW, **extra)
    tc = tt.TransformerConfig(**KW, **extra)
    jp = jt.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, _to_torch(jp)


@pytest.fixture(scope="module")
def moe():
    return _model()


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, KW["vocab"], shape) \
        .astype(np.int32)


def test_init_params_tree_matches_jax(moe):
    jc, tc, jp, _ = moe
    mine = params_to_numpy(tt.init_params(tc, seed=1, device="cpu"))
    ref = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert "moe" in mine["layers"][0] and "w1" not in mine["layers"][0]


def test_params_cross_both_ways(moe):
    """``params_from_numpy`` / ``params_to_numpy`` carry the ``moe``
    subtree across, bit for bit."""
    _, _, jp, tp = moe
    ref = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert sorted(back["layers"][1]["moe"]) == ["w1", "w2", "wr"]
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_cast_params_keeps_the_router_f32(moe):
    _, _, _, tp = moe
    cast = tt.cast_params(tp, torch.bfloat16)
    for mine, orig in zip(cast["layers"], tp["layers"]):
        assert torch.equal(mine["moe"]["wr"], orig["moe"]["wr"])
        assert mine["moe"]["wr"].dtype == torch.float32
        assert mine["moe"]["w1"].dtype == torch.bfloat16
        assert mine["wqkv"].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("capacity", [1.0, 2.0])
def test_forward_loss_and_grads_match_jax(capacity, route):
    """At capacity 1.0 the training forward drops tokens; the loss
    carries moe_aux_coef * aux."""
    jc, tc, jp, tp = _model(capacity_factor=capacity)
    tok = _tokens(0, (2, 16))
    logits, aux = tt.forward(tp, torch.from_numpy(tok), tc, with_aux=True)
    wl, waux = jt.forward(jp, jnp.asarray(tok), jc, with_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(wl), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    assert float(aux) > 0
    jl, jgr = jax.value_and_grad(lambda p: jt.loss_fn(
        p, jnp.asarray(tok), jc))(jp)
    loss, grads = tt.grads_and_loss(tp, torch.from_numpy(tok), tc)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got = jax.tree.leaves(params_to_numpy(grads))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgr))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_remat_and_train_step(moe):
    jc, tc, jp, tp = moe
    tok = _tokens(1, (2, 16))
    ref_p, ref_loss = jt.train_step(jp, jnp.asarray(tok), jc, lr=0.1)
    new_p, loss = tt.train_step(tp, torch.from_numpy(tok),
                                dataclasses.replace(tc, remat=True), lr=0.1)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(new_p)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref_p))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_decode_step_and_ragged_prefill_match_jax(moe):
    """Ragged prefill and decode route drop-free in both frameworks."""
    jc, tc, jp, tp = moe
    prompt = _tokens(2, (3, 7))
    lengths = np.array([7, 4, 5], np.int32)
    jcache = jg.init_kv_cache(jc, 3, 12)
    jl, jcache = jg.prefill(jp, jnp.asarray(prompt), jcache, jc,
                            last_index=jnp.asarray(lengths - 1))
    tcache = tg.init_kv_cache(tc, 3, 12, device="cpu")
    tl, _ = tg.prefill(tp, torch.from_numpy(prompt), tcache, tc,
                       last_index=torch.from_numpy(lengths - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jcache = jg.decode_step(jp, jnp.asarray(tok),
                                    jnp.asarray(lengths), jcache, jc)
        tl, _ = tg.decode_step(tp, torch.from_numpy(tok),
                               torch.from_numpy(lengths), tcache, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-6)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        lengths = lengths + 1


@pytest.mark.parametrize("capacity", [2.0, 4.0])
def test_generate_matches_jax(capacity):
    """At capacity 2.0 the plain prefill may drop tokens, in both
    frameworks alike; at 4.0 (= n_experts) nothing drops and the tokens
    also equal the teacher-forced forward's argmax (the reference's
    oracle, ``tests/test_generate.py:93``)."""
    jc, tc, jp, tp = _model(seed=7, capacity_factor=capacity)
    prompt = _tokens(8, (2, 6))
    want = np.asarray(jg.generate(jp, jnp.asarray(prompt), jc, max_new=8))
    got = tg.generate(tp, torch.from_numpy(prompt), tc, max_new=8).numpy()
    np.testing.assert_array_equal(got, want)
    jb, _ = jg.block_decode(jp, jnp.asarray(prompt[:, :3]),
                            jnp.zeros((2,), jnp.int32),
                            jg.init_kv_cache(jc, 2, 8), jc)
    tb, _ = tg.block_decode(tp, torch.from_numpy(prompt[:, :3]), 0,
                            tg.init_kv_cache(tc, 2, 8, device="cpu"), tc)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-6)
    if capacity < KW["n_experts"]:
        return
    seq = prompt
    for _ in range(8):
        logits = tt.forward(tp, torch.from_numpy(seq), tc)
        nxt = torch.argmax(logits[:, -1], -1).numpy().astype(np.int32)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(seq[:, 6:], got)


def test_paged_decode_step_matches_jax(moe):
    jc, tc, jp, tp = moe
    ps, P = 8, 9
    rng = np.random.default_rng(1)
    pools = [{k: rng.standard_normal((P, tc.kv_heads, tc.head_dim, ps))
              .astype(np.float32) for k in ("k", "v")}
             for _ in range(tc.n_layers)]
    for e in pools:
        for x in e.values():
            x[0] = 0
    table = np.array([[3, 5, 0], [2, 0, 0], [7, 8, 1]], np.int32)
    pos = np.array([12, 4, 23], np.int32)
    active = np.array([True, False, True])
    token = np.array([5, 9, 61], np.int32)
    jl, _ = jpaged.paged_decode_step(
        jp, jnp.asarray(token), jnp.asarray(pos),
        [{k: jnp.asarray(x) for k, x in e.items()} for e in pools],
        jnp.asarray(table), jnp.asarray(active), jc)
    tl, _ = tpaged.paged_decode_step(
        tp, torch.as_tensor(token), torch.as_tensor(pos),
        cache_from_numpy(pools, "cpu"), torch.as_tensor(table),
        torch.as_tensor(active), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("paged", [False, True])
def test_servers_match_jax_server_and_generate(moe, paged):
    """A mixed stream (a prompt past the largest bucket, a max_new = 1
    request) through both server modes: the port's tokens equal the JAX
    server's and each prompt's own drop-free ``generate`` (capacity
    factor = n_experts: the servers route drop-free throughout)."""
    jc, tc, jp, tp = moe
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, KW["vocab"], (int(rng.integers(3, 16)),)),
             int(rng.integers(2, 10))) for _ in range(4)]
    reqs.insert(1, (rng.integers(0, KW["vocab"], (37,)), 6))
    reqs.insert(3, (rng.integers(0, KW["vocab"], (5,)), 1))
    kw = dict(n_slots=3, max_len=64, round_len=5)
    kw.update(page_size=8, paged=True) if paged else \
        kw.update(prompt_buckets=(8, 16))
    mine = ts.DecodeServer(tp, tc, metrics=Registry(), **kw)
    ref = js.DecodeServer(jp, jc, metrics=JaxRegistry(), **kw)
    for srv in (mine, ref):
        for p, m in reqs:
            srv.submit(p, m)
    got, want = mine.run(), ref.run()
    for (p, m), g, w in zip(reqs, got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        alone = tg.generate(tp, torch.as_tensor(p[None], dtype=torch.int32),
                            dataclasses.replace(tc, capacity_factor=4.0),
                            max_new=m)[0].numpy()
        np.testing.assert_array_equal(g, alone)
    assert (mine.rounds_run, mine.steps_run) == (ref.rounds_run,
                                                 ref.steps_run)
