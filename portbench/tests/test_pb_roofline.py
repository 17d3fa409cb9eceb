"""The FLOP and byte counts against hand counts at a small shape."""

import pytest

from portbench import roofline

M = {"vocab": 10, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
     "n_layers": 3, "d_ff": 16}


def test_matmul_params_by_hand():
    # per layer: wq 8*8 + wkv 8*(2*1*4) + wo 8*8 + w1 8*16 + w2 16*8
    per = 64 + 64 + 64 + 128 + 128
    assert roofline.matmul_params(M) == 3 * per + 8 * 10


def test_attention_and_step_flops_by_hand():
    # 4 * layers * heads * head_dim per key attended
    assert roofline.attn_flops(M, 5) == 4 * 3 * 2 * 4 * 5
    n = roofline.matmul_params(M)
    # batch 1, seq 3: keys attended 1 + 2 + 3 = 6
    want = 3 * (2 * n * 3 + 4 * 3 * 2 * 4 * 6)
    assert roofline.train_step_flops(M, 1, 3) == want


def test_attention_bound_by_hand():
    b, s = 2, 4
    heads, hd, kvh = 2 * 2, 4, 1
    pairs = 4 * 5 / 2
    one = 2 * heads * hd * pairs
    q = heads * s * hd * 2
    kv = 2 * b * kvh * s * hd * 2
    st = heads * s * 4
    bound = roofline.bound_s
    # forward: q k^T, p v; reads q, k, v, writes o and the statistics
    fwd = bound(2 * one, 2 * q + kv + st)
    # backward: s, dp, dv, dq, dk; reads q, k, v, o, do and the
    # statistics, writes dq, dk, dv
    bwd = bound(5 * one, 4 * q + 2 * kv + st)
    assert roofline.attention_bound(M, b, s) == fwd + bwd


def test_attention_at_the_cell_is_bound_by_its_products():
    m = {"vocab": 49152, "d_model": 3072, "n_heads": 24, "n_kv_heads": 2,
         "n_layers": 30, "d_ff": 12288}
    b, s = 8, 4096
    pairs = s * (s + 1) / 2
    flops = 7 * 2.0 * b * 24 * 128 * pairs
    assert roofline.attention_bound(m, b, s) == pytest.approx(
        flops / roofline.PEAK_BF16_FLOPS)
