"""Speculative decoding: a cheap draft proposes, the target verifies.

The port of ``rlo_tpu/models/speculative.py``. Decode reads every
weight for one token a row, so a small draft model proposes ``gamma``
tokens one step at a time and the target judges them all in one
forward (``generate.block_decode``), reading its weights once a round
instead of once a token.

Greedy speculative decoding is lossless: a round emits the target's own
predictions ``t_pred[:, :j + 1]`` (a draft token is accepted exactly
when it equals the target's prediction, so the accepted prefix and the
bonus token are all target predictions), hence the output equals plain
greedy decode token for token wherever the verify's logits equal the
decode step's. On the CPU in f32 they do. On the card the draft steps
and the verify run other GEMM shapes (M = b against b * gamma), so a
near-tie may part them: the tokens then equal ``generate`` up to such
a near-tie.

With temperature > 0 (an explicit ``torch.Generator``) it is lossless
speculative sampling: the draft samples x_i ~ p_d, the target accepts
x_i with probability min(1, p_t(x_i) / p_d(x_i)), and the first
rejected position resamples from norm(max(p_t - p_d, 0)) (from p_t when
that residual is empty). Each emitted token is distributed as plain
temperature sampling from the target: equal in distribution, not in
trajectory.

A round is ``gamma`` draft ``decode_step``s at each row's own position
(K6 at T = 1, K7 writes) and one target ``block_decode`` over
``[last_tok, d_1 .. d_{gamma-1}]`` (K6 at T = gamma, K8 writes).
Rejected drafts leave entries beyond each row's position in both
caches; every attend masks at the row's own position and later rounds
overwrite them in order, so they are never read. The JAX package's
``lax.while_loop`` is a Python loop over rounds with one host read a
round (whether any row is still short of ``max_new``), bounded by
``max_new`` rounds like the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch

from rlo_tpu_torch.models.generate import (block_decode, decode_step,
                                           init_kv_cache, prefill)
from rlo_tpu_torch.models.transformer import TransformerConfig, cast_params


def _sample(weights, generator):
    """One token a row from non-negative ``weights`` (b, V)."""
    return torch.multinomial(weights, 1, generator=generator)[:, 0] \
        .to(torch.int32)


def speculative_generate(params: dict, draft_params: dict, prompt,
                         cfg: TransformerConfig,
                         draft_cfg: TransformerConfig, *, max_new: int,
                         gamma: int = 4, max_len: Optional[int] = None,
                         temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         return_rounds: bool = False):
    """Speculative continuation of ``prompt`` (b, plen): returns (b,
    max_new) int32 on the params' device, and with ``return_rounds``
    also the number of verify rounds taken (an int). The two configs
    must share the vocabulary. temperature 0 is greedy, equal to
    ``generate(params, prompt, cfg, max_new=max_new)``; > 0 samples
    with ``generator``. ``max_len`` (default plen + max_new + gamma)
    bounds both caches: the last round's writes reach position
    plen + max_new - 1 + gamma."""
    if cfg.vocab != draft_cfg.vocab:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab} != target vocab {cfg.vocab}")
    if gamma < 1:
        raise ValueError("gamma >= 1 required")
    sampling = temperature > 0
    if sampling and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    b, plen = prompt.shape
    max_len = max_len or (plen + max_new + gamma)
    if plen + max_new + gamma > max_len:
        raise ValueError(f"max_len {max_len} < plen {plen} + max_new "
                         f"{max_new} + gamma {gamma}")

    # the weight casts once, before the round loop (the router stays f32)
    params = cast_params(params, cfg.act_dtype)
    draft_params = cast_params(draft_params, draft_cfg.act_dtype)
    dev = params["embed"].device
    prompt = prompt.to(dev)
    t_cache = init_kv_cache(cfg, b, max_len, device=dev)
    d_cache = init_kv_cache(draft_cfg, b, max_len, device=dev)
    t_logits, _ = prefill(params, prompt, t_cache, cfg)
    prefill(draft_params, prompt, d_cache, draft_cfg)

    if sampling:
        first = _sample(torch.softmax(t_logits / temperature, dim=-1),
                        generator)
    else:
        first = torch.argmax(t_logits, dim=-1).to(torch.int32)
    # per row from here on: out[:n_out] emitted; both caches hold valid
    # entries through position pos - 1; last_tok, at position pos, has
    # not been through either model yet
    out = torch.zeros((b, max_new), dtype=torch.int32, device=dev)
    out[:, 0] = first
    n_out = torch.ones((b,), dtype=torch.int32, device=dev)
    pos = torch.full((b,), plen, dtype=torch.int32, device=dev)
    last_tok = first
    rows = torch.arange(b, device=dev)
    steps = torch.arange(gamma, device=dev)
    rounds = 0
    # every round emits >= 1 token for each unfinished row, so max_new
    # rounds always suffice
    while rounds < max_new and bool((n_out < max_new).any()):
        done = n_out >= max_new
        # --- draft rollout: gamma ragged decode steps
        cur, d_toks, d_probs = last_tok, [], []
        for i in range(gamma):
            logits, _ = decode_step(draft_params, cur, pos + i, d_cache,
                                    draft_cfg)
            if sampling:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                d_probs.append(probs)
                cur = _sample(probs, generator)
            else:
                cur = torch.argmax(logits, dim=-1).to(torch.int32)
            d_toks.append(cur)
        d_mat = torch.stack(d_toks, dim=1)                  # (b, gamma)

        # --- verify: one target forward over [last_tok, d_1..d_{g-1}]
        block = torch.cat([last_tok[:, None], d_mat[:, :gamma - 1]], dim=1)
        v_logits, _ = block_decode(params, block, pos, t_cache, cfg)

        if not sampling:
            # lossless greedy acceptance: the round emits the target's own
            # predictions t_pred[:, :j + 1]
            t_pred = torch.argmax(v_logits, dim=-1).to(torch.int32)
            n_acc = torch.cumprod((d_mat == t_pred).to(torch.int32),
                                  dim=1).sum(dim=1)
            j = torch.clamp(n_acc, max=gamma - 1)
            n_emit_raw = j + 1
            emit = t_pred
            new_last_live = t_pred[rows, j]
        else:
            # lossless rejection sampling
            p_t = torch.softmax(v_logits.float() / temperature, dim=-1)
            p_d = torch.stack(d_probs, dim=1)               # (b, gamma, V)
            idx = d_mat.long()[..., None]
            pt_x = p_t.gather(-1, idx)[..., 0]
            pd_x = p_d.gather(-1, idx)[..., 0]
            u = torch.rand((b, gamma), generator=generator, device=dev)
            accept = u * pd_x < pt_x       # u < pt / pd, division-free
            n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
            j = torch.clamp(n_acc, max=gamma - 1)
            p_t_j, p_d_j = p_t[rows, j], p_d[rows, j]
            resid = torch.clamp_min(p_t_j - p_d_j, 0.0)
            # p_t == p_d: the residual is empty and a sample from p_t is
            # already right
            y = _sample(torch.where(resid.sum(-1, keepdim=True) > 0, resid,
                                    p_t_j), generator)
            # all gamma accepted: emit them all (the target never saw
            # d_gamma, as in the greedy path); else the accepted prefix
            # and the adjustment sample
            all_in = n_acc == gamma
            n_emit_raw = torch.where(all_in, gamma, n_acc + 1)
            emit = torch.where(steps[None, :] < n_acc[:, None], d_mat,
                               y[:, None])
            new_last_live = torch.where(all_in, d_mat[:, -1], y)

        n_emit = torch.where(done, 0, n_emit_raw)
        for i in range(gamma):
            at = torch.clamp(n_out + i, max=max_new - 1).long()
            ok = (i < n_emit_raw) & (n_out + i < max_new) & ~done
            out[rows, at] = torch.where(ok, emit[:, i], out[rows, at])
        last_tok = torch.where(done, last_tok, new_last_live)
        n_out = torch.clamp(n_out + n_emit, max=max_new).to(torch.int32)
        pos = (pos + n_emit).to(torch.int32)
        rounds += 1
    return (out, rounds) if return_rounds else out
