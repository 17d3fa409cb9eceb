"""The precision design of K4 and K5's tensor-core route, on the CPU.

The bf16 kernels (``csrc/flash.cu``: ``flash_bwd_dq_mma_kernel``,
``flash_bwd_dkv_mma_kernel``) run every product of the flash backward
on bf16 operands with f32 accumulation. q, k and v are bf16 already;
the f32 operands do', ds~ and p are split exactly into bf16 hi + lo:
dP = do'_hi.v^T + do'_lo.v^T, dq = scale (ds~_hi.k + ds~_lo.k),
dk = scale (ds~_hi^T.q + ds~_lo^T.q) and dv = p_hi^T.do'_hi +
p_hi^T.do'_lo + p_lo^T.do'_hi. This file restates that route in torch
(exact bf16 products summed in f32, scores over 16-wide steps of d then
an f32 multiply by scale) and holds the whole VJP built on it against
the JAX package's ``_pallas_bwd`` in interpret mode: rtol 1e-4 and atol
1e-4 per unit of the largest |value|, the tolerance the card's check
holds the kernels to. How far one bf16 rounding of each f32 operand
would land is reported, not asserted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.pallas import flash as jflash
from rlo_tpu_torch.convert import from_numpy
from rlo_tpu_torch.kernels import flash as tf

H, LQ, LK, SCALE, TILE = 2, 64, 64, 0.3, 32
NAMES6 = ("dq", "dk", "dv", "dm", "dl", "do")


def _inputs(seed, d):
    """bf16-valued q, k, v held in f32 (so the reference returns f32
    grads of the same values), a carried state and random cotangents."""
    rng = np.random.default_rng(seed)

    def bf16_values(shape):
        x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()

    q, k, v = bf16_values((H, LQ, d)), bf16_values((H, LK, d)), \
        bf16_values((H, LK, d))
    m = rng.standard_normal((H, 1, LQ)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (H, 1, LQ)).astype(np.float32)
    o = rng.standard_normal((H, LQ, d)).astype(np.float32)
    qp = np.arange(LQ, dtype=np.int32).reshape(1, LQ)
    kp = np.arange(LK, dtype=np.int32).reshape(1, LK)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((H, 1, LQ), (H, 1, LQ), (H, LQ, d))]
    return [q, k, v, m, l, o, qp, kp], cots


def _split(x, single):
    """(hi, lo) with hi = bf16(x), lo = bf16(x - hi); lo = 0 when
    ``single`` (one bf16 rounding)."""
    hi = x.to(torch.bfloat16).float()
    lo = torch.zeros_like(x) if single else \
        (x - hi).to(torch.bfloat16).float()
    return hi, lo


def _scores(q, k, q_pos, k_pos, causal, scale):
    """mma_scores then the f32 multiply by scale, and the mask."""
    s = torch.zeros(q.shape[0], q.shape[1], k.shape[1])
    for d0 in range(0, q.shape[2], 16):
        s = s + torch.einsum("hqd,hkd->hqk", q[..., d0:d0 + 16].float(),
                             k[..., d0:d0 + 16].float())
    s = s * scale
    mask = (k_pos[0][None, :] <= q_pos[0][:, None])[None] if causal else \
        torch.ones_like(s, dtype=torch.bool)
    return torch.where(mask, s, tf.NEG), mask


def _tensor_core_route(single=()):
    """(rowstats, bwd_dq, bwd_dkv) restating the kernels' bf16 route;
    ``single`` names the f32 operands ('do', 'ds', 'p') rounded once to
    bf16 instead of split."""
    def ds_p(q, k, v, m2, dl2, do2, route, q_pos, k_pos, causal, scale):
        s, mask = _scores(q, k, q_pos, k_pos, causal, scale)
        mrow = m2[:, 0, :, None]
        u = torch.exp(s - mrow)
        do_hi, do_lo = _split(do2, "do" in single)
        dp = torch.einsum("hqd,hkd->hqk", do_lo, v.float()) + \
            torch.einsum("hqd,hkd->hqk", do_hi, v.float())
        ds = u * torch.where(mask, dl2[:, 0, :, None] + dp, 0.0) + \
            torch.where(mask & (s == mrow), route[:, 0, :, None], 0.0)
        return ds, torch.where(mask, u, 0.0), (do_hi, do_lo)

    def rowstats(q, k, m2, q_pos, k_pos, *, causal, scale):
        s, _ = _scores(q, k, q_pos, k_pos, causal, scale)
        return (s == m2[:, 0, :, None]).sum(-1, dtype=torch.float32)[
            :, None, :]

    def bwd_dq(q, k, v, m2, dl2, do2, route, q_pos, k_pos, *, causal,
               scale):
        ds, _, _ = ds_p(q, k, v, m2, dl2, do2, route, q_pos, k_pos, causal,
                        scale)
        ds_hi, ds_lo = _split(ds, "ds" in single)
        return (torch.einsum("hqk,hkd->hqd", ds_lo, k.float())
                + torch.einsum("hqk,hkd->hqd", ds_hi, k.float())) * scale

    def bwd_dkv(q, k, v, m2, dl2, do2, route, q_pos, k_pos, *, causal,
                scale):
        ds, p, (do_hi, do_lo) = ds_p(q, k, v, m2, dl2, do2, route, q_pos,
                                     k_pos, causal, scale)
        ds_hi, ds_lo = _split(ds, "ds" in single)
        p_hi, p_lo = _split(p, "p" in single)
        dk = (torch.einsum("hqk,hqd->hkd", ds_hi, q.float())
              + torch.einsum("hqk,hqd->hkd", ds_lo, q.float())) * scale
        dv = torch.einsum("hqk,hqd->hkd", p_hi, do_hi) \
            + torch.einsum("hqk,hqd->hkd", p_hi, do_lo) \
            + torch.einsum("hqk,hqd->hkd", p_lo, do_hi)
        return dk, dv

    return rowstats, bwd_dq, bwd_dkv


def _port(monkeypatch, args, cots, causal, exact, single=()):
    """The port's VJP glue (``flash_backward``) over the emulated route,
    on the bf16 values of q, k, v held in f32 (so dq, dk, dv come back in
    f32); m' is the max of the emulated scores (K2 forms its scores with
    the same routine, so the tie count sees its bits)."""
    ts = from_numpy(args, "cpu")
    q, k, v, m, l, o, qp, kp = ts
    _, l2, o2 = tf.flash_block_update_hld_plain(*ts, causal=causal,
                                                scale=SCALE)
    s, _ = _scores(q, k, qp, kp, causal, SCALE)
    m2 = torch.maximum(m, s.amax(-1)[:, None, :])
    rowstats, bwd_dq, bwd_dkv = _tensor_core_route(single)
    with monkeypatch.context() as mp:
        mp.setattr(tf, "rowstats", rowstats)
        mp.setattr(tf, "bwd_dq", bwd_dq)
        mp.setattr(tf, "bwd_dkv", bwd_dkv)
        got = tf.flash_backward(*ts, m2, l2, o2, *from_numpy(cots, "cpu"),
                                causal=causal, scale=SCALE,
                                exact_max=exact)
    return [g.float().numpy() for g in got]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
def test_split_route_matches_pallas_bwd(monkeypatch, d, causal, exact,
                                        record_property):
    args, cots = _inputs(d + 2 * causal + exact, d)
    ja = [jnp.asarray(a) for a in args]
    outs = jflash.flash_block_update_hld(*ja, causal=causal, scale=SCALE,
                                         block_q=TILE, block_k=TILE,
                                         interpret=True)
    want = [np.asarray(w) for w in jflash._pallas_bwd(
        *ja, *outs, *(jnp.asarray(c) for c in cots), causal=causal,
        scale=SCALE, bq=TILE, bk=TILE, interpret=True, exact_max=exact)]
    units = [max(1.0, float(np.abs(w).max())) for w in want]

    def dev(got):
        return {n: float(np.abs(g - w).max()) / u
                for n, g, w, u in zip(NAMES6[:3], got, want, units)}

    got = _port(monkeypatch, args, cots, causal, exact)
    report = {"split": dev(got)}
    for op in ("do", "ds", "p"):
        report[f"single {op}"] = dev(_port(monkeypatch, args, cots, causal,
                                           exact, single=(op,)))
    record_property("dev_per_unit", report)
    print("dq/dk/dv from the reference, per unit of max|value|: " + "; ".join(
        f"{k} " + " ".join(f"{v:.2g}" for v in r.values())
        for k, r in report.items()))
    for name, g, w, u in zip(NAMES6, got, want, units):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * u,
                                   err_msg=f"{name}: {report}")


@pytest.mark.parametrize("h,groups,lq,d,shuffled", [
    (1, 1, 64, 16, False), (2, 3, 200, 128, False), (3, 1, 37, 32, True),
    (1, 4, 129, 64, False)])
def test_dkv_prep_plain_splits_do_once(h, groups, lq, d, shuffled):
    """K5's prepass, its plain twin: hi is bf16(do') exactly, lo the
    bf16 of the remainder (this file's split), hi + lo within 2^-16 |do'|
    in f32; and each 64-row query tile's largest position, over positions
    that repeat under the GQA fold, arbitrary ones and a ragged last
    tile. CPU tensors take the twin through the wrapper too."""
    rng = np.random.default_rng(lq + d)
    n = groups * lq
    x = rng.standard_normal((h, n, d)).astype(np.float32) * \
        (np.float32(10.0) ** rng.integers(-20, 20, (h, n, 1))).astype(
            np.float32)
    x[0, 0, :3] = [0.0, -0.0, 1e30]
    do2 = torch.from_numpy(x)
    pos = np.tile(np.arange(lq, dtype=np.int32), groups)
    if shuffled:
        pos = rng.permutation(pos).astype(np.int32)
    q_pos = torch.from_numpy(pos).reshape(1, n)
    hi, lo, tmax = tf.bwd_dkv_prep_plain(do2, q_pos)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert hi.shape == lo.shape == do2.shape
    assert torch.equal(hi, do2.to(torch.bfloat16))
    want_hi, want_lo = _split(do2, False)
    assert torch.equal(hi.float(), want_hi)
    assert torch.equal(lo.float(), want_lo)
    err = (hi.float() + lo.float() - do2).abs()
    assert bool((err <= 2.0 ** -16 * do2.abs()).all())
    assert tmax.dtype == torch.int32
    assert tmax.tolist() == [int(pos[t:t + tf.K5_TILE_ROWS].max())
                             for t in range(0, n, tf.K5_TILE_ROWS)]
    for got, want in zip(tf.bwd_dkv_prep(do2, q_pos), (hi, lo, tmax)):
        assert torch.equal(got, want)
