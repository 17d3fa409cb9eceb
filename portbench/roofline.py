"""Peaks of the card and the operations and bytes each piece of work
needs, from its shapes. Counts are what the inputs need: each input byte
read once, each output byte written once, causal attention over the
pairs it keeps; never what a kernel happens to do again.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3
#: bytes/s, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16, F32 = 2, 4


def dims(m: dict) -> dict:
    d, H = m["d_model"], m["n_heads"]
    kvh = m.get("n_kv_heads") or H
    return {"d": d, "H": H, "kvh": kvh, "hd": d // H, "f": m["d_ff"],
            "L": m["n_layers"], "V": m["vocab"]}


def matmul_params(m: dict) -> int:
    """Weights that every token multiplies: the projections, the MLP
    and the (tied) head; the embedding lookup is no product."""
    k = dims(m)
    per_layer = (k["d"] * k["d"] + k["d"] * 2 * k["kvh"] * k["hd"]
                 + k["d"] * k["d"] + 2 * k["d"] * k["f"])
    return k["L"] * per_layer + k["d"] * k["V"]


def attn_flops(m: dict, positions_plus_one: float) -> float:
    """Forward attention FLOPs (q k^T and p v, all layers) of tokens
    whose contexts sum to ``positions_plus_one`` keys."""
    k = dims(m)
    return 4.0 * k["L"] * k["H"] * k["hd"] * positions_plus_one


def token_flops(m: dict, n_tokens: float, positions_plus_one: float) -> float:
    """Forward model FLOPs of ``n_tokens`` tokens."""
    return 2.0 * matmul_params(m) * n_tokens + attn_flops(
        m, positions_plus_one)


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: forward plus a backward of
    twice the forward, no recompute counted."""
    return 3.0 * token_flops(m, batch * seq, batch * seq * (seq + 1) / 2)


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ---- causal attention, the function the flash kernels compute --------
def attention_bound(m: dict, batch: int, seq: int) -> float:
    """One layer's causal attention in a training step, forward and
    backward, counted once whatever the kernels recompute: the forward
    takes q k^T and p v (2 products) and reads q, k, v and writes o and
    the row statistics; the backward takes s, dp, dv, dq and dk (5
    products: s is the backward's own, since keeping p would write
    seq^2 values a head) and reads q, k, v, o, do and the statistics and
    writes dq, dk and dv. Each pass's bound is the larger of its FLOPs at
    the bf16 peak and its bytes at the HBM peak."""
    k = dims(m)
    heads = batch * k["H"]
    pairs = seq * (seq + 1) / 2            # causal (query, key) pairs
    one = 2.0 * heads * k["hd"] * pairs    # FLOPs of one causal product
    q = heads * seq * k["hd"] * BF16       # q, o, do, dq alike
    kv = 2 * batch * k["kvh"] * seq * k["hd"] * BF16
    stats = heads * seq * F32
    fwd = bound_s(2 * one, q + kv + q + stats)
    bwd = bound_s(5 * one, 3 * q + kv + stats + q + kv)
    return fwd + bwd
