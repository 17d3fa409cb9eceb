"""Ring attention: sequence-parallel attention over the ppermute ring.

The port of ``rlo_tpu/ops/ring_attention.py``. The
sequence is split over an ``Axis``; each rank keeps its q block, and the
compact K/V blocks rotate rank -> rank+1 (``topology.ring_perm``, the
ring allreduce's schedule) through ``axis.ppermute``. Each of the ws
steps is one launch of K2 (``kernels.flash.flash_block_update_hld``) on
the local q block against the arriving K/V with their global positions;
the online-softmax state (m, l, o) is carried in K2's head-leading layout
with the GQA group folded into the query axis once, before the loop (one
transpose in, one out), as the JAX package's fused path does. The JAX
package's ``block_q``/``block_k`` are Pallas tile sizes: K2 picks its
own, so they are not taken.

Differentiable end to end: each step's ``FlashBlockUpdate`` gives its
backward (K4 and K5, 'pallas_fast' as in the JAX package), and the
rotations are ``parallel.autodiff.ppermute``, so the cotangents of K and
V travel the ring backwards to the ranks that own them. Under a causal
contiguous split the blocks from later shards are masked whole: K2
leaves the state as it was, and K4/K5 give them zero dk/dv and add
nothing to dq.

On a ``LocalMesh`` a ppermute clones what it receives, so each step
copies the K/V blocks once.
"""

from __future__ import annotations

from typing import Optional

import torch

from rlo_tpu_torch import topology
from rlo_tpu_torch.kernels.flash import NEG, flash_block_update_hld
from rlo_tpu_torch.parallel.autodiff import ppermute


def stripe_sequence(x, ws: int):
    """Reorder a full sequence (axis 0) into the striped layout: rank r of
    a striped ring holds tokens r, r+ws, r+2ws, ... Apply before the
    split with ``layout='striped'``; ``unstripe_sequence`` inverts it.
    Striping leaves every (q block, K/V block) pair about half unmasked
    under causal masking, where a contiguous split masks whole steps."""
    seq = x.shape[0]
    if seq % ws:
        raise ValueError(f"sequence {seq} must divide by ws {ws}")
    blk = seq // ws
    return x.reshape(blk, ws, *x.shape[1:]).transpose(0, 1) \
        .reshape(seq, *x.shape[1:])


def unstripe_sequence(x, ws: int):
    """Inverse of ``stripe_sequence`` (axis 0)."""
    seq = x.shape[0]
    if seq % ws:
        raise ValueError(f"sequence {seq} must divide by ws {ws}")
    blk = seq // ws
    return x.reshape(ws, blk, *x.shape[1:]).transpose(0, 1) \
        .reshape(seq, *x.shape[1:])


def ring_attention(q, k, v, axis, *, causal: bool = False,
                   scale: Optional[float] = None,
                   layout: str = "contiguous"):
    """Sequence-parallel attention for one rank of ``axis``.

    q (blk, H, D) is this rank's block of the sequence; k, v (blk, Hkv,
    D) with Hkv dividing H (query head h attends K/V head h // (H/Hkv));
    only the compact K/V travels. ``layout``: 'contiguous' (rank r holds
    tokens [r*blk, (r+1)*blk)) or 'striped' (tokens r, r+ws, ...). Returns
    the (blk, H, D) output of q's rows, in q's dtype, equal to full
    softmax attention over the whole sequence."""
    ws, idx = axis.size, axis.index
    blk, h, d = q.shape
    hk = k.shape[1]
    if h % hk:
        raise ValueError(f"query heads {h} must be a multiple of K/V heads "
                         f"{hk}")
    g = h // hk
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dev = q.device
    ar = torch.arange(blk, dtype=torch.int32, device=dev)
    if layout == "contiguous":
        def positions(shard):
            return (shard * blk + ar).reshape(1, blk)
    elif layout == "striped":
        def positions(shard):
            return (shard + ws * ar).reshape(1, blk)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    # the GQA fold, once: q (H, blk, D) -> (Hkv, G*blk, D), positions
    # tiled G times; K/V rotate compact as (Hkv, blk, D)
    q_hld = q.transpose(0, 1).reshape(hk, g * blk, d).contiguous()
    qp = positions(idx).repeat(1, g)
    kc = k.transpose(0, 1).contiguous()
    vc = v.transpose(0, 1).contiguous()
    m = torch.full((hk, 1, g * blk), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((hk, 1, g * blk), dtype=torch.float32, device=dev)
    o = torch.zeros((hk, g * blk, d), dtype=torch.float32, device=dev)
    # K/V travel rank -> rank+1: the block held at step s came from rank
    # idx - s. ws-1 rotations; the last block is used where it arrives
    perm = topology.ring_perm(ws)
    for s in range(ws):
        m, l, o = flash_block_update_hld(
            q_hld, kc, vc, m, l, o, qp, positions((idx - s) % ws),
            causal=causal, scale=scale, bwd="pallas_fast")
        if s + 1 < ws:
            kc = ppermute(kc, axis, perm)
            vc = ppermute(vc, axis, perm)
    lt = l.transpose(1, 2)
    denom = torch.where(lt > 0, lt, torch.ones_like(lt))
    return (o / denom).reshape(h, blk, d).transpose(0, 1).to(q.dtype)


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None):
    """Unsharded softmax attention (the tests' oracle): q (Lq, H, D), k, v
    (Lk, H, D), computed in f32; returns q's dtype."""
    qn, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    if causal:
        kn = k.shape[0]
        mask = torch.arange(kn, device=q.device)[None, :] <= \
            torch.arange(qn, device=q.device)[:, None]
        s = torch.where(mask[None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v.float()).to(q.dtype)
