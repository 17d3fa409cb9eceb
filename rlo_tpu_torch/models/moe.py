"""Mixture-of-experts FFN on one card.

The port of ``rlo_tpu/models/moe.py`` without expert parallelism:
``init_moe_params`` and ``moe_ffn`` (``ep_axis`` raises: the all_to_all
dispatch over processes comes with the TP/EP slice of the port).

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
slot) of a padded (E, C + 1, d) block (slot C collects the dropped
rows, whose results are multiplied by 0) and both products are one
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


def _experts_padded(x, w1, w2, expert, slot, keep, cap):
    """Each token's expert output (T, d), from a padded (E, C + 1, d)
    block: kept rows at (expert, slot), dropped ones all at slot C (the
    last copy there wins; its output is multiplied by 0)."""
    e, d = w1.shape[0], x.shape[1]
    at = expert * (cap + 1) + torch.where(keep, slot, cap)
    block = x.new_zeros((e * (cap + 1), d)).index_copy(0, at, x)
    y = _ffn(block.view(e, cap + 1, d), w1, w2)
    return y.view(e * (cap + 1), d).index_select(0, at)


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
            capacity_factor: float = 2.0, ep_axis=None):
    """The MoE FFN on ``h`` (..., d) in its dtype. Returns (out shaped
    like ``h``, aux f32 scalar)."""
    if ep_axis is not None:
        raise NotImplementedError(
            "expert parallelism (ep_axis) is not ported yet: its "
            "all_to_all dispatch over processes comes with the TP/EP "
            "slice of the port")
    if params["w1"].shape[0] != n_experts:
        raise ValueError(f"{params['w1'].shape[0]} expert weights for "
                         f"n_experts {n_experts}")
    dt = h.dtype
    x = h.reshape(-1, h.shape[-1])
    gates, expert, onehot, slot, keep, cap = route(
        params["wr"], x, n_experts, capacity_factor)
    prob = gates.gather(1, expert[:, None])[:, 0]
    frac = onehot.float().mean(dim=0)
    aux = n_experts * (frac * gates.mean(dim=0)).sum()
    w1, w2 = params["w1"].to(dt), params["w2"].to(dt)
    if n_experts * cap <= max(PAD_ROWS, PAD_RATIO * x.shape[0]):
        y = _experts_padded(x, w1, w2, expert, slot, keep, cap)
    else:
        y = _experts_sorted(x, w1, w2, expert, onehot, keep)
    weight = torch.where(keep, prob, torch.zeros_like(prob)).to(dt)
    out = weight.float()[:, None] * y.float()
    return out.to(dt).reshape(h.shape), aux
