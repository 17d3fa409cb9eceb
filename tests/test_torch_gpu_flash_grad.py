"""K3, K4 and K5 (the flash backward) against their plain versions on
the card, the bf16 tie contract with K2, and the VJP modes there.

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py`` says);
the inputs are those of ``tests/test_torch_flash_grad.py``, made with
numpy from the same seeds.
"""

import numpy as np
import pytest
import torch

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


#: K5's shapes: (folded heads, GQA groups, rows a group, Lk, D, causal).
#: Under the fold positions repeat a group, so a 128-key block's causal
#: span holds dead query tiles; Lk off 128 and Lq off 64 leave ragged
#: blocks and tiles; every head_dim the kernel takes.
K5_CASES = {
    "gqa-fold-causal": (2, 3, 200, 200, 128, True),
    "gqa-fold-d64": (3, 4, 150, 150, 64, True),
    "ragged-d16": (3, 1, 100, 130, 16, True),
    "ragged-d32": (3, 1, 100, 130, 32, True),
    "ragged-d64": (3, 1, 100, 130, 64, True),
    "ragged-d128": (3, 1, 100, 130, 128, True),
    "keys-past-queries": (2, 1, 70, 300, 128, True),
    "non-causal": (2, 1, 150, 200, 128, False),
    "non-causal-fold": (2, 3, 70, 90, 32, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_matches_plain_on_card(cuda, case):
    """bf16 K5 against ``bwd_dkv_plain`` within rtol 1e-4 and atol 1e-4
    per unit of the largest |value| (phase 7's rule: f32 sums of up to
    600 split-precision products in another order), each side on its own
    forward's m' and with a nonzero route (exact mode: every row ties its
    m' from the initial state, so the routed term lands); one K5 launch
    and one prepass launch a call, and the prepass equals its plain twin
    bit for bit."""
    h, groups, lq, lk, d, causal = K5_CASES[case]
    n = groups * lq
    q, k, v, _, _, _, qp, kp = from_numpy(
        make_hld(7 * lq + d, h, n, lk, d), cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    qp = torch.arange(lq, dtype=torch.int32, device=cuda).repeat(
        groups).reshape(1, n) + max(0, lk - lq)
    m = torch.full((h, 1, n), tf.NEG, device=cuda)
    state = (m, torch.zeros_like(m), torch.zeros(h, n, d, device=cuda))
    kw = dict(causal=causal, scale=0.125)
    m2 = tf.flash_block_update_hld(q, k, v, *state, qp, kp, **kw)[0]
    m2p = tf.flash_block_update_hld_plain(q, k, v, *state, qp, kp, **kw)[0]
    gen = torch.Generator(device=cuda).manual_seed(n + lk + d)
    dl2 = torch.randn(h, 1, n, generator=gen, device=cuda)
    do2 = torch.randn(h, n, d, generator=gen, device=cuda)
    route = torch.randn(h, 1, n, generator=gen, device=cuda)
    before = (tf.bwd_dkv.launches, tf.bwd_dkv_prep.launches)
    dk, dv = tf.bwd_dkv(q, k, v, m2, dl2, do2, route, qp, kp, **kw)
    prep = tf.bwd_dkv_prep(do2, qp)
    torch.cuda.synchronize()
    assert (tf.bwd_dkv.launches, tf.bwd_dkv_prep.launches) == (
        before[0] + 1, before[1] + 2)
    for got, want in zip(prep, tf.bwd_dkv_prep_plain(do2, qp)):
        assert torch.equal(got, want)
    pk, pv = tf.bwd_dkv_plain(q, k, v, m2p, dl2, do2, route, qp, kp, **kw)
    for got, want in ((dk, pk), (dv, pv)):
        unit = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * unit)


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
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 16),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64)])
@pytest.mark.parametrize("lq,lk", [(33, 7), (129, 77), (256, 256),
                                   (1024, 1024)])
def test_tie_counts_match_plain_on_card(cuda, lq, lk, dtype, d):
    """K3's counts equal ``rowstats_plain``'s exactly, each side on its
    own forward's m' (the kernels': K2's; the plain version's: the plain
    forward's), causal and not, from the initial state (every row ties
    at least once) and from a carried one; repeat launches give the same
    bits."""
    h = 8 if lq < 1024 else 4
    for causal in (True, False):
        for carried in (False, True):
            q, k, v, m, l, o, qp, kp = from_numpy(
                make_hld(lq + lk + d, h, lq, lk, d), cuda)
            q, k, v = (t.to(dtype) for t in (q, k, v))
            qp = qp + (lk - lq)
            if not carried:
                m = torch.full_like(m, tf.NEG)
                l, o = torch.zeros_like(l), torch.zeros_like(o)
            kw = dict(causal=causal, scale=0.125)
            m2 = tf.flash_block_update_hld(q, k, v, m, l, o, qp, kp, **kw)[0]
            m2p = tf.flash_block_update_hld_plain(q, k, v, m, l, o, qp, kp,
                                                  **kw)[0]
            cnt = tf.rowstats(q, k, m2, qp, kp, **kw)
            again = tf.rowstats(q, k, m2, qp, kp, **kw)
            torch.cuda.synchronize()
            assert torch.equal(cnt, tf.rowstats_plain(q, k, m2p, qp, kp,
                                                      **kw)), (causal, carried)
            assert torch.equal(cnt, again)
            if not carried:
                assert bool((cnt >= 1).all()), (causal, int((cnt < 1).sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("bwd", ["pallas", "pallas_fast"])
def test_vjp_on_card_matches_xla_mode(cuda, bwd):
    """Each backward mode against autograd through the plain version
    ('xla') under the consumers its contract covers: 'pallas' (exact tie
    routing) on raw (m', l', o') cotangents and on the normalised o'/l';
    'pallas_fast' drops the m' routing, exact only when the consumer
    normalises by l' and discards m', so on the normalised o'/l' alone
    (on raw cotangents it parts from 'xla' by design, on the CPU's plain
    path as on the card)."""
    args = from_numpy(make_hld(9, 4, 96, 160, 64), cuda)
    args[6] = args[6] + 64

    def grads(mode, normalised):
        ts = [t.clone().requires_grad_(i < 6) for i, t in enumerate(args)]
        m2, l2, o2 = tf.flash_block_update_hld(*ts, causal=True,
                                               scale=0.125, bwd=mode)
        loss = (o2 / l2.transpose(1, 2)).sum() if normalised else \
            o2.sum() + l2.sum()
        return torch.autograd.grad(loss, ts[:6])

    for normalised in ((False, True) if bwd == "pallas" else (True,)):
        for g, w, name in zip(grads(bwd, normalised),
                              grads("xla", normalised), NAMES6):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4,
                                       msg=f"{name} ({normalised=})")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_repeat_the_same_bits_on_card(cuda, dtype):
    """No atomics: K4 owns query rows and K5 key rows, so launches on the
    same operands give the same bits. A race between a block's warps
    shows as a rare launch that differs, so the launches repeat."""
    ops, _ = _bwd_operands(8, 129, 200, 64, 4, cuda, dtype, True)
    kw = dict(causal=True, scale=0.125)
    first = (tf.bwd_dq(*ops, **kw), *tf.bwd_dkv(*ops, **kw))
    for _ in range(50):
        again = (tf.bwd_dq(*ops, **kw), *tf.bwd_dkv(*ops, **kw))
        for a, b in zip(first, again):
            assert torch.equal(a, b)
