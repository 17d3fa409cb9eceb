"""Mixture-of-experts FFN, on one card or with the experts split over ranks.

The port of ``rlo_tpu/models/moe.py``: ``init_moe_params`` and
``moe_ffn`` (``ep_axis``: expert parallelism over an ``Axis``).

Routing is the JAX package's (switch-style top-1 with a static
capacity):

  - router logits ``x @ wr`` and their softmax in f32 (``wr`` stays f32
    through ``transformer.cast_params``: a bf16-rounded router flips
    top-1 near ties); each token goes to its first maximal expert,
    carrying that gate probability (the gradient's only path through
    the discrete choice);
  - capacity C = max(1, ceil(capacity_factor * T / E)) over the
    flattened token order; a token's slot in its expert's queue is the
    number of earlier tokens routed to that expert, and tokens at slot
    C or beyond are dropped (output 0: the residual stream carries
    them);
  - the expert FFNs run in the activation dtype with tanh GELU; the
    combine multiplies each kept row by its gate probability cast to
    that dtype, in f32, then casts back;
  - the Switch aux loss E * sum_e fraction_routed(e) * mean_gate(e).

Dispatch is by index, not by the JAX package's one-hot (T, E, C) tensor
and its einsums (at a 32 x 1024 prefill that tensor holds 8.6 G
elements). While E * C is at most ``PAD_RATIO`` rows a token or
``PAD_ROWS`` in all (training at capacity factor 2, decode steps, verify
blocks, the servers' prefills) the kept rows are placed at (expert,
slot) of a padded (E, C, d) block (the dropped rows go to one scratch
row past it, their results multiplied by 0) and both products are one
batched product each, with no host read and the same shapes every
call. Otherwise (drop-free batch prefills, E * C = E * T) the kept rows
are sorted by expert and each expert's rows take one ``torch.matmul``
per product; the per-expert row counts are read on the host, one
synchronisation per layer, and the products' shapes change with the
routing. The products are
plain matrix products outside any Pallas kernel in the JAX package, so
the port runs them through PyTorch's matmul too. Gradients flow
through the gate probability, the expert weights and the aux term; the
dispatch carries none.

Expert parallelism (``ep_axis``, the JAX package's dispatch and return):
each rank holds E/ep experts (``w1``/``w2`` cut by
``transformer.param_pspecs``) and routes its own tokens, with capacity C
from its own token count. Its kept rows go to the same padded (E, C,
d) block, viewed as (ep, E_local, C, d): one ``all_to_all`` sends row
s to rank s, the local experts run on (E_local, ep * C, d), and a
second ``all_to_all`` brings each rank's results home. Every rank
calls both with equal shapes, so every rank must route the same number
of tokens. The sorted dispatch has variable-length rows that no
all_to_all carries: it is the single-rank route only. The aux term is
the rank's own tokens' (as in the JAX package, nothing is summed over
the axis). Under autograd both ``all_to_all``s carry the cotangents
back (``ops.device_collectives``), so an expert's weight gradient
gathers every rank's tokens routed to it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: the padded dispatch runs while its (expert, slot) block holds at most
#: PAD_RATIO rows a token, or PAD_ROWS rows in all; past both the
#: per-expert products over the sorted rows take over
PAD_RATIO = 3
PAD_ROWS = 4096


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int) -> dict:
    """Router and per-expert FFN weights, f32, with the JAX package's
    shapes and scales: ``wr`` (d, E), ``w1`` (E, d, f), ``w2`` (E, f,
    d), drawn from ``gen`` on its device."""
    def norm(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32) * scale

    return {"wr": norm((d_model, n_experts), d_model ** -0.5),
            "w1": norm((n_experts, d_model, d_ff), d_model ** -0.5),
            "w2": norm((n_experts, d_ff, d_model), d_ff ** -0.5)}


def route(wr, x, n_experts: int, capacity_factor: float):
    """Top-1 routing of ``x`` (T, d): returns (gates (T, E) f32, expert
    (T,), its one-hot (T, E), slot (T,) in the expert's queue, keep (T,)
    bool, capacity)."""
    t = x.shape[0]
    cap = max(1, math.ceil(capacity_factor * t / n_experts))
    gates = torch.softmax(x.float() @ wr.float(), dim=-1)
    expert = torch.argmax(gates, dim=-1)          # the first maximum
    onehot = F.one_hot(expert, n_experts)
    # the running count per expert, scanned along the contiguous token
    # axis of the (E, T) transpose (a scan down the 8 columns of (T, E)
    # runs one thread a column on the card)
    counts = torch.cumsum(onehot.t().contiguous(), dim=1)
    slot = counts.gather(0, expert[None])[0] - 1
    return gates, expert, onehot, slot, slot < cap, cap


def _ffn(x, w1, w2):
    # jax.nn.gelu defaults to the tanh approximation
    return torch.matmul(F.gelu(torch.matmul(x, w1), approximate="tanh"), w2)


def _experts_padded(x, w1, w2, expert, slot, keep, cap, ep_axis=None,
                    algorithm: str = "xla"):
    """Each kept token's expert output (T, d) from a padded (E * C, d)
    block: kept rows at (expert, slot), dropped ones at a scratch row
    past the block; a dropped row reads the block's last output, which
    ``moe_ffn`` weighs by 0. With ``ep_axis`` ``w1``/``w2`` are this
    rank's E/ep experts: the block, viewed as (ep, E_local, C, d), goes
    to its experts' ranks and comes back by two ``all_to_all``s
    (``algorithm``)."""
    ep = ep_axis.size if ep_axis is not None else 1
    e_local, d = w1.shape[0], x.shape[1]
    rows = ep * e_local * cap
    at = torch.where(keep, expert * cap + slot, rows)
    block = x.new_zeros((rows + 1, d)).index_copy(0, at, x)[:rows]
    if ep_axis is None:
        y = _ffn(block.view(e_local, cap, d), w1, w2)
    else:
        from rlo_tpu_torch.ops.device_collectives import all_to_all
        blocks = all_to_all(block.view(ep, e_local, cap, d), ep_axis,
                            algorithm=algorithm)
        y = _ffn(blocks.transpose(0, 1).reshape(e_local, ep * cap, d), w1,
                 w2)
        y = all_to_all(y.view(e_local, ep, cap, d).transpose(0, 1)
                       .contiguous(), ep_axis, algorithm=algorithm)
    return y.reshape(rows, d).index_select(0, at.clamp(max=rows - 1))


def _experts_sorted(x, w1, w2, expert, onehot, keep):
    """Each kept token's expert output (T, d; dropped rows 0): the kept
    rows sorted by expert, one product per expert over its rows (the
    row counts read on the host)."""
    e = w1.shape[0]
    order = torch.argsort(torch.where(keep, expert, e), stable=True)
    counts = (onehot * keep[:, None]).sum(dim=0).tolist()
    idx = order[:sum(counts)]
    parts = torch.split(x[idx], counts)
    y = torch.cat([_ffn(p, a, b) for p, a, b in zip(parts, w1.unbind(0),
                                                      w2.unbind(0))])
    return x.new_zeros(x.shape).index_copy(0, idx, y)


def moe_ffn(params: dict, h, n_experts: int, *,
            capacity_factor: float = 2.0, ep_axis=None,
            all_to_all_algorithm: str = "xla"):
    """The MoE FFN on ``h`` (..., d) in its dtype. Returns (out shaped
    like ``h``, aux f32 scalar). With ``ep_axis`` ``params``' experts are
    this rank's E/ep and ``h`` its tokens; ``all_to_all_algorithm`` is
    the dispatch's schedule ('xla', 'direct' or 'ring')."""
    ep = ep_axis.size if ep_axis is not None else 1
    if params["w1"].shape[0] * ep != n_experts:
        raise ValueError(f"expert shards {params['w1'].shape[0]} x {ep} != "
                         f"n_experts {n_experts}")
    dt = h.dtype
    x = h.reshape(-1, h.shape[-1])
    gates, expert, onehot, slot, keep, cap = route(
        params["wr"], x, n_experts, capacity_factor)
    prob = gates.gather(1, expert[:, None])[:, 0]
    frac = onehot.float().mean(dim=0)
    aux = n_experts * (frac * gates.mean(dim=0)).sum()
    w1, w2 = params["w1"].to(dt), params["w2"].to(dt)
    if ep_axis is not None or \
            n_experts * cap <= max(PAD_ROWS, PAD_RATIO * x.shape[0]):
        y = _experts_padded(x, w1, w2, expert, slot, keep, cap, ep_axis,
                            all_to_all_algorithm)
    else:
        y = _experts_sorted(x, w1, w2, expert, onehot, keep)
    weight = torch.where(keep, prob, torch.zeros_like(prob)).to(dt)
    out = weight.float()[:, None] * y.float()
    return out.to(dt).reshape(h.shape), aux
