"""Ulysses sequence parallelism: all_to_all head-scatter attention.

The port of ``rlo_tpu/ops/ulysses.py``. Each rank holds its
sequence block of every head, (blk, H, D); one ``all_to_all`` per tensor
(``ops.device_collectives.all_to_all``, any of its schedules) re-splits
to the whole sequence of H/ws heads, (seq, H/ws, D); the attention of
those heads runs with no communication through the port's
``flash_attention`` (K2, one launch); one more ``all_to_all`` puts the
output back to (blk, H, D). Needs ws to divide H; the causal mask uses
global positions, which hold because every rank sees whole sequences.
Differentiable: the ``all_to_all``s move the cotangents back the way
they came, and ``flash_attention``'s backward is K4 and K5.
"""

from __future__ import annotations

from typing import Optional

from rlo_tpu_torch.kernels.flash import flash_attention
from rlo_tpu_torch.ops.device_collectives import all_to_all


def _seq_to_heads(x, axis, ws: int, algorithm: str):
    """(blk, H, D) per rank -> (seq, H/ws, D): scatter heads, gather the
    sequence."""
    blk, h, d = x.shape
    if h % ws:
        raise ValueError(f"ulysses needs the axis size ({ws}) to divide the "
                         f"head count ({h}); use ring_attention for "
                         f"few-head configs")
    chunks = x.reshape(blk, ws, h // ws, d).transpose(0, 1)
    out = all_to_all(chunks, axis, algorithm=algorithm)
    # row s now holds rank s's sequence block of this rank's heads
    return out.reshape(ws * blk, h // ws, d)


def _heads_to_seq(x, axis, ws: int, algorithm: str):
    """(seq, H/ws, D) -> (blk, H, D): the inverse."""
    seq, hl, d = x.shape
    blk = seq // ws
    out = all_to_all(x.reshape(ws, blk, hl, d), axis, algorithm=algorithm)
    # row g: this rank's sequence block of rank g's heads
    return out.transpose(0, 1).reshape(blk, ws * hl, d)


def ulysses_attention(q, k, v, axis, *, causal: bool = False,
                      scale: Optional[float] = None,
                      algorithm: str = "xla"):
    """Sequence-parallel attention for one rank of ``axis``, with
    ``ring_attention``'s contract: q (blk, H, D) this rank's contiguous
    block; k, v (blk, Hkv, D) with Hkv dividing H. When ws divides Hkv
    only the compact K/V crosses the all_to_alls (rank s's query-head
    chunk lines up with its K/V-head chunk); otherwise K/V are repeated
    by the smallest factor that makes it divide. Returns the (blk, H, D)
    output in q's dtype."""
    ws = axis.size
    hq, hk = q.shape[1], k.shape[1]
    if hq % hk:
        raise ValueError(f"query heads {hq} must be a multiple of K/V "
                         f"heads {hk}")
    g = hq // hk
    if hk % ws and hq % ws == 0:
        # repeat composes with the grouping (expanded head j copies head
        # j // r); r = g always qualifies, as hk * g = hq
        r = next(r for r in range(1, g + 1)
                 if g % r == 0 and (hk * r) % ws == 0)
        k = k.repeat_interleave(r, dim=1)
        v = v.repeat_interleave(r, dim=1)
    qh = _seq_to_heads(q, axis, ws, algorithm)
    kh = _seq_to_heads(k, axis, ws, algorithm)
    vh = _seq_to_heads(v, axis, ws, algorithm)
    oh = flash_attention(qh, kh, vh, causal=causal, scale=scale)
    return _heads_to_seq(oh, axis, ws, algorithm)
