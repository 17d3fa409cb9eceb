"""The gradient of the flash block update: the port's ``FlashBlockUpdate``
(K2 forward; K3-K5 or autograd through the plain version backward)
against the JAX package's custom VJP on the CPU, mirroring
``tests/test_flash_grad.py``.

The JAX side runs ``flash_block_update_hld(interpret=True, bwd=...)``
for the 'pallas' modes and autodiff through its pure restatement
``_ref_block_update_hld`` for 'xla' (what its 'xla' backward is), each
under ``jax.jit``; the port runs the same ``bwd`` through its glue
(``flash_backward``) over the plain twins of K3-K5, which is what a CPU
tensor takes. Inputs are
made by numpy from a seed. Tolerances are the reference tests' own: rtol
and atol 2e-4 on single updates and tie cases, 3e-4 through a chain of
two updates (f32 throughout; the two sides differ in summation order
only). The kernels themselves are held against the plain twins on the
card (``gpu`` tests, skipped without one, and ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.pallas import flash as jflash
from rlo_tpu_torch.convert import from_numpy
from rlo_tpu_torch.kernels import flash as tf

NAMES6 = ["dq", "dk", "dv", "dm", "dl", "do"]


def make_hld(seed, h, lq, lk, d, hk=None):
    rng = np.random.default_rng(seed)
    hk = h if hk is None else hk
    q = (rng.standard_normal((h, lq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((hk, lk, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((hk, lk, d)) * 0.5).astype(np.float32)
    m = rng.standard_normal((h, 1, lq)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (h, 1, lq)).astype(np.float32)
    o = rng.standard_normal((h, lq, d)).astype(np.float32)
    qp = np.arange(lq, dtype=np.int32).reshape(1, lq)
    kp = np.arange(lk, dtype=np.int32).reshape(1, lk)
    return [q, k, v, m, l, o, qp, kp]


def _weights(n, shape, fn, step):
    return fn(np.arange(n, dtype=np.float64) * step).reshape(shape) \
        .astype(np.float32)


def jax_loss(update):
    """The reference tests' scalar functional of (m', l', o')."""
    def loss(q, k, v, m, l, o, qp, kp):
        m2, l2, o2 = update(q, k, v, m, l, o, qp, kp)
        w = jnp.asarray(_weights(o2.size, o2.shape, np.cos, 0.01))
        return jnp.sum(o2 * w) + jnp.sum(jnp.sin(l2)) + jnp.sum(m2 * 0.3)
    return loss


def port_loss(update):
    def loss(q, k, v, m, l, o, qp, kp):
        m2, l2, o2 = update(q, k, v, m, l, o, qp, kp)
        w = torch.from_numpy(_weights(o2.numel(), tuple(o2.shape), np.cos,
                                      0.01))
        return (o2 * w).sum() + torch.sin(l2).sum() + (m2 * 0.3).sum()
    return loss


def jax_update(bwd, causal, scale, **tiles):
    """The JAX package's block update for one ``bwd`` mode."""
    if bwd == "xla":
        return lambda *a: jflash._ref_block_update_hld(*a, causal, scale)
    return functools.partial(jflash.flash_block_update_hld, causal=causal,
                             scale=scale, interpret=True, bwd=bwd, **tiles)


def jax_grads(loss, args, n):
    return jax.jit(jax.grad(loss, argnums=tuple(range(n))))(
        *(jnp.asarray(a) for a in args))


def port_grads(loss, args, n):
    ts = from_numpy(list(args), "cpu")
    for t in ts[:n]:
        t.requires_grad_(True)
    return torch.autograd.grad(loss(*ts), ts[:n])


def _close(got, want, names, tol):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("bwd", ["xla", "pallas", "pallas_fast"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h,lq,lk,d,block_q,block_k", [
    (2, 32, 32, 16, 16, None),
    (1, 16, 64, 8, 16, 16),
    (3, 24, 48, 16, 8, 24),
])
def test_single_update_grads_match_jax(bwd, causal, h, lq, lk, d, block_q,
                                       block_k):
    args = make_hld(0, h, lq, lk, d)
    want = jax_grads(jax_loss(jax_update(bwd, causal, 0.3, block_q=block_q,
                                         block_k=block_k)), args, 6)
    got = port_grads(port_loss(functools.partial(
        tf.flash_block_update_hld, causal=causal, scale=0.3, bwd=bwd)),
        args, 6)
    _close(got, want, NAMES6, 2e-4)


def _chain_inputs(seed, h, lq, d):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((h, lq, d)) * 0.5).astype(np.float32)
            for _ in range(5)]


def _chain(update, h, lq, d, lib):
    """Two chained block updates, the second over positions all past
    the queries' (fully masked when causal: the ring step), then the
    normalisation."""
    if lib is jnp:
        qp = jnp.arange(lq, dtype=jnp.int32).reshape(1, lq)
        kp2 = jnp.arange(lq, 2 * lq, dtype=jnp.int32).reshape(1, lq)
        m = jnp.full((h, 1, lq), jflash._NEG, jnp.float32)
        l = jnp.zeros((h, 1, lq), jnp.float32)
        o = jnp.zeros((h, lq, d), jnp.float32)
    else:
        qp = torch.arange(lq, dtype=torch.int32).reshape(1, lq)
        kp2 = torch.arange(lq, 2 * lq, dtype=torch.int32).reshape(1, lq)
        m = torch.full((h, 1, lq), tf.NEG)
        l = torch.zeros((h, 1, lq))
        o = torch.zeros((h, lq, d))

    def loss(q, k1, v1, k2, v2):
        m_, l_, o_ = update(q, k1, v1, m, l, o, qp, qp)
        m_, l_, o_ = update(q, k2, v2, m_, l_, o_, qp, kp2)
        lt = l_.transpose(0, 2, 1) if lib is jnp else l_.transpose(1, 2)
        if lib is jnp:
            out = o_ / jnp.where(lt > 0, lt, 1.0)
            w = jnp.asarray(_weights(out.size, out.shape, np.tanh, 0.01))
            return jnp.sum(out * w)
        out = o_ / torch.where(lt > 0, lt, torch.ones_like(lt))
        w = torch.from_numpy(_weights(out.numel(), tuple(out.shape),
                                      np.tanh, 0.01))
        return (out * w).sum()
    return loss


@pytest.mark.parametrize("bwd", ["xla", "pallas", "pallas_fast"])
@pytest.mark.parametrize("causal", [False, True])
def test_chained_updates_grads_match_jax(bwd, causal):
    """The ring composition: (m, l, o) cotangents flow between steps;
    'pallas_fast' (the training path's mode) must stay exact through the
    normalised chain."""
    h, lq, d = 2, 16, 8
    args = _chain_inputs(7, h, lq, d)
    want = jax_grads(_chain(jax_update(bwd, causal, 0.35, block_q=8), h,
                            lq, d, jnp), args, 5)
    got = port_grads(_chain(functools.partial(
        tf.flash_block_update_hld, causal=causal, scale=0.35, bwd=bwd),
        h, lq, d, torch), args, 5)
    _close(got, want, ["dq", "dk1", "dv1", "dk2", "dv2"], 3e-4)


def _tie_inputs():
    """Duplicated K rows (the row max divides among 2 tied slots), m
    preset to the exact row max for rows 0-1 (maximum's 0.5/0.5 split)
    and a zero q row (every score ties at 0): the tie branches of the
    exact backward (tests/test_flash_grad.py:135-170). q and k are
    multiples of 1/8, so every score is exact and both packages round
    it to the same bits: the ties hold on both sides."""
    h, lq, lk, d = 1, 8, 16, 8
    rng = np.random.default_rng(21)

    def eighths(shape):
        return np.round(rng.standard_normal(shape) * 4) / 8

    q = eighths((h, lq, d)).astype(np.float32)
    q[0, 3] = 0.0
    k = eighths((h, lk, d)).astype(np.float32)
    k[0, 9] = k[0, 4]
    v = (rng.standard_normal((h, lk, d)) * 0.5).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (h, 1, lq)).astype(np.float32)
    o = rng.standard_normal((h, lq, d)).astype(np.float32)
    qp = np.arange(lq, dtype=np.int32).reshape(1, lq)
    kp = np.arange(lk, dtype=np.int32).reshape(1, lk)
    return h, lq, [q, k, v, None, l, o, qp, kp]


@pytest.mark.parametrize("bwd", ["xla", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
def test_tie_routing_matches_jax(bwd, causal):
    h, lq, args = _tie_inputs()
    m = np.full((h, 1, lq), -1e30, np.float32)
    probe = jflash._ref_block_update_hld(
        *(jnp.asarray(a) for a in args[:3]), jnp.asarray(m),
        *(jnp.asarray(a) for a in args[4:]), causal, 0.3)[0]
    m[0, 0, 0:2] = np.asarray(probe)[0, 0, 0:2]
    args[3] = m
    want = _tie_reference(causal, args)
    got = port_grads(port_loss(functools.partial(
        tf.flash_block_update_hld, causal=causal, scale=0.3, bwd=bwd)),
        args, 6)
    _close(got, want, NAMES6, 2e-4)


_TIE_REFS: dict = {}


def _tie_reference(causal, args):
    """JAX's exact-mode grads on the tie inputs, once per causal flag:
    both port modes are held against them."""
    if causal not in _TIE_REFS:
        _TIE_REFS[causal] = jax_grads(jax_loss(jax_update(
            "pallas", causal, 0.3, block_q=8, block_k=8)), args, 6)
    return _TIE_REFS[causal]


def test_tie_counts_of_the_plain_k3():
    """rowstats_plain counts the duplicated key twice, every position of
    the zero q row, and (causal) the masked slots of a row whose m' is
    -1e30 -- as the JAX package's own count does."""
    h, lq, args = _tie_inputs()
    q, k, _, _, _, _, qp, kp = from_numpy(
        [a if a is not None else np.zeros(1, np.float32) for a in args],
        "cpu")
    m = torch.full((h, 1, lq), tf.NEG)
    for causal in (False, True):
        m2, _, _ = tf.flash_block_update_hld_plain(
            q, k, k, m, torch.zeros_like(m), torch.zeros(h, lq, 8), qp, kp,
            causal=causal, scale=0.3)
        cnt = tf.rowstats_plain(q, k, m2, qp, kp, causal=causal, scale=0.3)
        s = np.einsum("hqd,hkd->hqk", q.numpy(), k.numpy()) * 0.3
        if causal:
            s = np.where(kp.numpy()[0][None, :] <= qp.numpy()[0][:, None],
                         s, -1e30)
        want = (s == s.max(-1, keepdims=True)).sum(-1)
        np.testing.assert_array_equal(cnt[:, 0].numpy(), want)
        assert cnt[0, 0, 3] == (4 if causal else 16)  # the zero q row
    # a fully masked row: every position ties at -1e30
    m2 = torch.full((h, 1, lq), tf.NEG)
    cnt = tf.rowstats_plain(q, k, m2, qp, kp + 100, causal=True, scale=0.3)
    assert (cnt == 16).all()


@pytest.mark.parametrize("bwd", ["pallas", "pallas_fast", "xla"])
def test_fully_masked_rows_match_jax(bwd):
    """Ring-style inputs: every key lies past every query, from the
    initial state. Every row is fully masked, m' = -1e30 and all 64
    masked slots tie, so the exact mode gives m half of dmacc and routes
    the other half onto masked slots, where the mask kills it -- the
    reference's autodiff semantics."""
    h, lq, lk, d = 2, 16, 64, 8
    args = make_hld(3, h, lq, lk, d)
    args[3] = np.full((h, 1, lq), -1e30, np.float32)
    args[7] = args[7] + lq
    want = jax_grads(jax_loss(jax_update(bwd, True, 0.3, block_q=8,
                                         block_k=16)), args, 6)
    got = port_grads(port_loss(functools.partial(
        tf.flash_block_update_hld, causal=True, scale=0.3, bwd=bwd)),
        args, 6)
    _close(got, want, NAMES6, 2e-4)
    q, k, _, m, _, _, qp, kp = from_numpy(args, "cpu")
    assert (tf.rowstats_plain(q, k, m, qp, kp, causal=True, scale=0.3)
            == lk).all()


@pytest.mark.parametrize("lq,lk", [(37, 50), (5, 129), (64, 1)])
@pytest.mark.parametrize("bwd", ["pallas", "xla"])
def test_ragged_lengths_match_reference_autodiff(bwd, lq, lk):
    """Lq and Lk that no tile divides (the interpret path takes only
    tile-divisible shapes): held against autodiff through the JAX
    package's pure restatement ``_ref_block_update_hld``, with the K
    block offset as on a ring, so some rows are fully masked."""
    args = make_hld(lq, 2, lq, lk, 16)
    args[7] = args[7] + lq // 2
    for causal in (True, False):
        want = jax_grads(jax_loss(lambda *a: jflash._ref_block_update_hld(
            *a, causal, 0.25)), args, 6)
        got = port_grads(port_loss(functools.partial(
            tf.flash_block_update_hld, causal=causal, scale=0.25, bwd=bwd)),
            args, 6)
        _close(got, want, NAMES6, 2e-4)


@pytest.mark.parametrize("bwd", ["pallas", "pallas_fast", "xla"])
@pytest.mark.parametrize("g", [2, 4])
def test_gqa_fold_grads_match_jax(g, bwd):
    """H query heads over H/g K/V heads: both packages fold the group
    into the query axis; dk and dv sum a K/V head's g query heads."""
    args = make_hld(11, 4, 16, 32, 8, hk=4 // g)
    if bwd == "xla":  # the restatement takes no group: repeat K/V heads
        args_j = args[:1] + [np.repeat(a, g, axis=0) for a in args[1:3]] \
            + args[3:]
        want = jax_grads(jax_loss(jax_update(bwd, True, 0.3)), args_j, 6)
        want = list(want[:1]) + [np.asarray(w).reshape(4 // g, g, 32, 8)
                                 .sum(1) for w in want[1:3]] + \
            list(want[3:])
    else:
        want = jax_grads(jax_loss(jax_update(bwd, True, 0.3, block_q=16)),
                         args, 6)
    got = port_grads(port_loss(functools.partial(
        tf.flash_block_update_hld, causal=True, scale=0.3, bwd=bwd)),
        args, 6)
    _close(got, want, NAMES6, 2e-4)


@pytest.mark.parametrize("exact", [True, False])
def test_flash_backward_matches_jax_pallas_bwd(exact):
    """The glue on raw cotangents, no autograd around it: the port's
    ``flash_backward`` against the JAX package's ``_pallas_bwd`` in
    interpret mode, with random cotangents for all of m', l' and o'."""
    h, lq, lk, d = 2, 16, 32, 8
    args = make_hld(5, h, lq, lk, d)
    rng = np.random.default_rng(6)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((h, 1, lq), (h, 1, lq), (h, lq, d))]
    # each side's (m', l', o') from its own forward: the tie count
    # compares the backward's recomputed scores with that m'
    ja = [jnp.asarray(a) for a in args]
    outs = jflash.flash_block_update_hld(*ja, causal=True, scale=0.3,
                                         block_q=8, block_k=16,
                                         interpret=True)
    want = jflash._pallas_bwd(*ja, *outs, *(jnp.asarray(c) for c in cots),
                              causal=True, scale=0.3, bq=8, bk=16,
                              interpret=True, exact_max=exact)
    ts = from_numpy(args, "cpu")
    outs = tf.flash_block_update_hld(*ts, causal=True, scale=0.3)
    got = tf.flash_backward(*ts, *outs, *from_numpy(cots, "cpu"),
                            causal=True, scale=0.3, exact_max=exact)
    _close(got, want, NAMES6, 2e-4)


def test_bf16_cotangent_dtypes():
    """dq, dk, dv come back in q's, k's and v's dtypes."""
    q, k, v, m, l, o, qp, kp = from_numpy(make_hld(3, 1, 16, 16, 8), "cpu")
    kb = k.to(torch.bfloat16).requires_grad_(True)
    vb = v.to(torch.bfloat16).requires_grad_(True)
    q.requires_grad_(True)
    for bwd in tf.BWD_MODES:
        out = tf.flash_block_update_hld(q.to(torch.bfloat16), kb, vb, m, l,
                                        o, qp, kp, causal=True, scale=0.3,
                                        bwd=bwd)
        g = torch.autograd.grad(out[2].sum() + out[1].sum(), (q, kb, vb))
        assert [t.dtype for t in g] == [torch.float32, torch.bfloat16,
                                        torch.bfloat16], bwd


def _qkv(seed, seq, heads, dim, kv_heads):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((seq, n, dim)) * 0.5).astype(np.float32)
            for n in (heads, kv_heads, kv_heads)]


@pytest.mark.parametrize("g", [1, 2])
def test_flash_attention_grad_matches_jax(g):
    """Whole attention (the training path's call, 'pallas_fast')."""
    args = _qkv(14, 32, 2, 16, 2 // g)

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=True, block_q=8,
                                     interpret=True)
        w = jnp.asarray(_weights(out.size, out.shape, np.cos, 0.02))
        return jnp.sum(out * w)

    def tloss(q, k, v):
        out = tf.flash_attention(q, k, v, causal=True)
        w = torch.from_numpy(_weights(out.numel(), tuple(out.shape),
                                      np.cos, 0.02))
        return (out * w).sum()

    want = jax_grads(jloss, args, 3)
    got = port_grads(tloss, args, 3)
    _close(got, want, ["dq", "dk", "dv"], 3e-4)


def test_flash_block_update_caller_layout_matches_jax():
    """The caller-layout wrapper: values and grads."""
    rng = np.random.default_rng(8)
    lq, lk, h, d = 16, 24, 2, 8
    args = [(rng.standard_normal((lq, h, d)) * 0.5).astype(np.float32),
            (rng.standard_normal((lk, h, d)) * 0.5).astype(np.float32),
            (rng.standard_normal((lk, h, d)) * 0.5).astype(np.float32),
            rng.standard_normal((h, lq)).astype(np.float32),
            rng.uniform(0.5, 2.0, (h, lq)).astype(np.float32),
            rng.standard_normal((lq, h, d)).astype(np.float32),
            np.arange(8, 8 + lq, dtype=np.int32),
            np.arange(lk, dtype=np.int32)]
    jfn = functools.partial(jflash.flash_block_update, causal=True,
                            scale=0.3, block_q=8, interpret=True)
    tfn = functools.partial(tf.flash_block_update, causal=True, scale=0.3)
    want_vals = jfn(*(jnp.asarray(a) for a in args))
    got_vals = tfn(*from_numpy(args, "cpu"))
    _close(got_vals, want_vals, ["m", "l", "o"], 1e-5)
    want = jax_grads(jax_loss(jfn), args, 6)
    got = port_grads(port_loss(tfn), args, 6)
    _close(got, want, NAMES6, 2e-4)


def test_value_unchanged_by_autograd():
    """The differentiable path gives the forward's values bit for bit
    in every mode, and the JAX package's within 1e-5."""
    args = make_hld(5, 2, 32, 32, 16)
    ts = from_numpy(args, "cpu")
    plain = tf.flash_block_update_hld(*ts, causal=True, scale=0.3)
    want = jflash.flash_block_update_hld(*(jnp.asarray(a) for a in args),
                                         causal=True, scale=0.3,
                                         block_q=16, interpret=True)
    _close(plain, want, ["m", "l", "o"], 1e-5)
    for bwd in tf.BWD_MODES:
        ts[0].requires_grad_(True)
        got = tf.flash_block_update_hld(*ts, causal=True, scale=0.3,
                                        bwd=bwd)
        assert all(g.grad_fn is not None for g in got)
        for g, p in zip(got, plain):
            assert torch.equal(g.detach(), p)


def test_rejects_unknown_bwd_and_unfolded_heads():
    ts = from_numpy(make_hld(1, 2, 8, 8, 8), "cpu")
    with pytest.raises(ValueError, match="unknown bwd"):
        tf.flash_block_update_hld(*ts, bwd="triton")
    q, k, v, m, l, o, qp, kp = from_numpy(make_hld(1, 4, 8, 8, 8, hk=2),
                                          "cpu")
    with pytest.raises(ValueError, match="one head count"):
        tf.rowstats(q, k, m, qp, kp)


def test_backward_kernels_no_fallback_off_cpu():
    """A tensor on neither the CPU nor a card raises and counts no
    launch; there is no silent fallback."""
    q, k, v, m, l, o, qp, kp = (t.to("meta") for t in
                                from_numpy(make_hld(2, 2, 8, 8, 16), "cpu"))
    before = (tf.rowstats.launches, tf.bwd_dq.launches, tf.bwd_dkv.launches)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tf.rowstats(q, k, m, qp, kp)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tf.bwd_dq(q, k, v, m, l, o, m, qp, kp)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tf.bwd_dkv(q, k, v, m, l, o, m, qp, kp)
    assert (tf.rowstats.launches, tf.bwd_dq.launches,
            tf.bwd_dkv.launches) == before


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bwd_operands(h, lq, lk, d, seed, dev, dtype, causal):
    """Backward operands from the initial state, with K2's m' (and the
    plain forward's, for the plain count)."""
    q, k, v, _, _, _, qp, kp = from_numpy(make_hld(seed, h, lq, lk, d), dev)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    m = torch.full((h, 1, lq), tf.NEG, device=dev)
    state = (m, torch.zeros_like(m), torch.zeros(h, lq, d, device=dev))
    kw = dict(causal=causal, scale=0.125)
    m2 = tf.flash_block_update_hld(q, k, v, *state, qp, kp, **kw)[0]
    m2p = tf.flash_block_update_hld_plain(q, k, v, *state, qp, kp, **kw)[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    dl2 = torch.randn(h, 1, lq, generator=gen, device=dev)
    do2 = torch.randn(h, lq, d, generator=gen, device=dev)
    route = torch.randn(h, 1, lq, generator=gen, device=dev)
    return (q, k, v, m2, dl2, do2, route, qp, kp), m2p


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,lq,lk,d", [(8, 100, 130, 64), (4, 64, 64, 128),
                                       (4, 33, 7, 16)])
def test_backward_kernels_match_plain_on_card(cuda, h, lq, lk, d, dtype):
    """K3's counts equal the plain counts (each on its own forward's m')
    and are >= 1 on every row (its recomputed scores tie K2's m'); K4
    and K5 within rtol/atol 1e-4 of their plain versions, each side on
    its own forward's m' too: the routed term lands where a side's own
    recomputed score ties its m' (bf16 scores come from the tensor cores
    in the kernels and from an f32 BLAS product in the plain versions,
    whose last bits differ)."""
    for causal in (True, False):
        ops, m2p = _bwd_operands(h, lq, lk, d, lq, cuda, dtype, causal)
        q, k, v, m2, dl2, do2, route, qp, kp = ops
        kw = dict(causal=causal, scale=0.125)
        before = (tf.rowstats.launches, tf.bwd_dq.launches,
                  tf.bwd_dkv.launches)
        cnt = tf.rowstats(q, k, m2, qp, kp, **kw)
        dq = tf.bwd_dq(*ops, **kw)
        dk, dv = tf.bwd_dkv(*ops, **kw)
        torch.cuda.synchronize()
        assert (tf.rowstats.launches, tf.bwd_dq.launches,
                tf.bwd_dkv.launches) == tuple(b + 1 for b in before)
        assert torch.equal(cnt, tf.rowstats_plain(q, k, m2p, qp, kp, **kw))
        assert bool((cnt >= 1).all())
        pops = (q, k, v, m2p, dl2, do2, route, qp, kp)
        torch.testing.assert_close(dq, tf.bwd_dq_plain(*pops, **kw),
                                   rtol=1e-4, atol=1e-4)
        pk, pv = tf.bwd_dkv_plain(*pops, **kw)
        torch.testing.assert_close(dk, pk, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(dv, pv, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("h,hk,lq,lk", [(4, 4, 33, 7), (4, 2, 129, 77),
                                        (8, 1, 64, 256)])
def test_bf16_ties_with_k2_max_on_card(cuda, h, hk, lq, lk, d):
    """bf16 operands: K3 recomputes each score with K2's tensor-core
    routine, so from the initial state every row ties K2's m' at least
    once (through the GQA fold too, whose folded rows repeat positions),
    causal and not."""
    q, k, v, _, _, _, qp, kp = from_numpy(make_hld(d + lq, h, lq, lk, d, hk),
                                          cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    g = h // hk
    qf, qpf = q.reshape(hk, g * lq, d), qp.repeat(1, g)
    m = torch.full((hk, 1, g * lq), tf.NEG, device=cuda)
    state = (m, torch.zeros_like(m), torch.zeros(hk, g * lq, d, device=cuda))
    for causal in (True, False):
        kw = dict(causal=causal, scale=0.125)
        m2 = tf.flash_block_update_hld(qf, k, v, *state, qpf, kp, **kw)[0]
        cnt = tf.rowstats(qf, k, m2, qpf, kp, **kw)
        torch.cuda.synchronize()
        assert bool((cnt >= 1).all()), int((cnt < 1).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("bwd", ["pallas", "pallas_fast"])
def test_vjp_on_card_matches_xla_mode(cuda, bwd):
    args = from_numpy(make_hld(9, 4, 96, 160, 64), cuda)
    args[6] = args[6] + 64

    def grads(mode):
        ts = [t.clone().requires_grad_(i < 6) for i, t in enumerate(args)]
        m2, l2, o2 = tf.flash_block_update_hld(*ts, causal=True,
                                               scale=0.125, bwd=mode)
        return torch.autograd.grad(o2.sum() + l2.sum(), ts[:6])

    for g, w, name in zip(grads(bwd), grads("xla"), NAMES6):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)
