"""KV-cache generation for the flagship transformer.

The port of ``rlo_tpu/models/generate.py`` (dense mode): ``init_kv_cache``,
``_quantize_kv``, ``_attend_cache``, ``_attend_cache_block``,
``decode_step`` (scalar or ragged per-row positions), ``block_decode``,
``prefill`` (with ``last_index`` for ragged prompts), ``prefill_scan``
(the token-at-a-time oracle), ``generate``, ``_pick_token`` and
``generate_timed`` (into the port's ``SERVING`` registry).

The cache keeps the JAX package's layout: per layer a dict {"k", "v"}
of (batch, kv_heads, head_dim, max_len), sequence-minor, in the
activation dtype, or int8 with f32 scale sidecars "ks", "vs" of
(batch, kv_heads, max_len) when ``cfg.kv_cache_dtype == "int8"``. There
is no round-up of max_len to 128: that padding existed for the TPU's
lanes.

Where the JAX functions return a new cache, the port updates the cache
it is given **in place** (and returns that same list): decode writes
through K7 (``kernels.decode.write_kv_row``), block decode through K8
(``write_kv_block``), and prefill copies the prompt block into
positions [0, plen). Attention against the cache is K6
(``flash_block_decode``); prefill attends its prompt block through K2
(``models.transformer._local_attention``). On CPU tensors each kernel
wrapper takes its plain twin; on the card they launch the kernels.

MoE configs route drop-free in ``decode_step``, ``block_decode`` and a
ragged ``prefill`` (``_decode_cfg``); a plain ``prefill`` routes with
the training capacity, as the JAX package's does.

Tensor and expert parallelism: every function from ``init_kv_cache`` to
``generate`` takes ``tp_axis`` and ``ep_axis`` (``Axis`` objects of
``parallel.mesh``; the ones that run layers also take their schedules,
``tp_algorithm`` and ``all_to_all_algorithm``, as
``transformer.apply_layer`` does), runs once per rank, and every rank
makes the same calls. Under ``tp_axis`` the params are the rank's slices
(``transformer.param_pspecs``), the cache holds kv_heads/tp heads
(``kv_cache_pspecs``), the prompt is the same on every rank, and every
rank ends with the same logits bit for bit: the row-parallel sums leave
the same bits on every rank and the embedding is replicated. Under
``ep_axis`` the experts are split and each rank holds its own batch
rows; every rank must hold as many rows as the others (the dispatch's
all_to_alls pair equal shapes).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from rlo_tpu_torch.kernels.decode import (MAX_BLOCK_T, flash_block_decode,
                                          flash_decode, write_kv_block,
                                          write_kv_row)
from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                              _local_attention, _rmsnorm,
                                              apply_layer, cast_params,
                                              embed_tokens)


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device=None, tp_axis=None):
    """Zeroed per-layer K/V cache (distinct tensors per entry) on
    ``device`` (None is the card); with ``tp_axis`` the rank's
    kv_heads/tp heads (the column-parallel K/V projections' heads)."""
    from rlo_tpu_torch.parallel.mesh import resolve_device
    dev = resolve_device(device)
    ntp = tp_axis.size if tp_axis is not None else 1
    if cfg.kv_heads % ntp:
        raise ValueError(f"tp={ntp} must divide n_kv_heads {cfg.kv_heads}")
    kvh = cfg.kv_heads // ntp
    shape = (batch, kvh, cfg.head_dim, max_len)
    if cfg.kv_cache_dtype == "int8":
        sshape = (batch, kvh, max_len)
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "ks": torch.zeros(sshape, dtype=torch.float32, device=dev),
                 "vs": torch.zeros(sshape, dtype=torch.float32, device=dev)}
                for _ in range(cfg.n_layers)]
    if cfg.kv_cache_dtype is not None:
        raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r}")
    return [{"k": torch.zeros(shape, dtype=cfg.act_dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.act_dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def kv_cache_pspecs(cfg: TransformerConfig, tp_axis: Optional[str] = None):
    """The ``PartitionSpec`` tree of ``init_kv_cache``'s output: the K/V
    head axis split over ``tp_axis`` (as the ``wkv`` projections are),
    batch and positions whole."""
    from rlo_tpu_torch.parallel.sharding import PartitionSpec as P
    spec = P(None, tp_axis, None, None)
    if cfg.kv_cache_dtype == "int8":
        sspec = P(None, tp_axis, None)
        return [{"k": spec, "v": spec, "ks": sspec, "vs": sspec}
                for _ in range(cfg.n_layers)]
    return [{"k": spec, "v": spec} for _ in range(cfg.n_layers)]


def _quantize_kv(x):
    """(..., head_dim) -> (int8 values, f32 scale over the last axis):
    symmetric, scale = amax / 127. The division by 127 is a product
    with its f32 reciprocal, as XLA compiles the JAX package's
    ``/ 127.0`` inside jit, so both quantise to the same bytes."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def _decode_cfg(cfg: TransformerConfig) -> TransformerConfig:
    """The decode-time config: MoE routing is drop-free (capacity >= the
    tokens of one step). Capacity dropping depends on the order of the
    flattened token axis, so it is not causal; decode routes every token
    to its expert, and equals the training forward exactly when that
    forward drops nothing (capacity_factor >= n_experts)."""
    if cfg.n_experts == 0:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=max(cfg.capacity_factor,
                                 float(cfg.n_experts)))


def _pos_tensor(pos, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32)
    return torch.tensor(pos, dtype=torch.int32, device=device)


def _attend_cache(q, k_cache, v_cache, pos, scale, k_scale=None,
                  v_scale=None):
    """q (b, 1, H, hd) against the cache prefix [0, pos] (pos scalar or
    (b,)): K6 at T = 1. Returns (b, 1, H, hd) f32."""
    return flash_decode(q, k_cache, v_cache, pos, scale, k_scale, v_scale)


def _attend_cache_block(q, k_cache, v_cache, pos0, scale, k_scale=None,
                        v_scale=None):
    """q (b, T, H, hd), query t of row b at pos0_b + t attending cache
    positions <= it (write-then-attend covers in-block causality): K6
    with the same tile partition as T = 1. Returns f32."""
    return flash_block_decode(q, k_cache, v_cache, pos0, scale, k_scale,
                              v_scale)


def _write_rows(lc, k_row, v_row, posv):
    """One decode step's cache write (in place, K7): the rows may be
    views (the decode step's ``k[:, 0]`` of the projection, read in
    place); k with v, and the scales, each take one launch. Returns the
    scale sidecars for the attend (None for unquantised caches)."""
    if "ks" in lc:
        k_row, ks_new = _quantize_kv(k_row)
        v_row, vs_new = _quantize_kv(v_row)
        # the sidecars ride the same kernel through the (b, kvh, 1, L)
        # view of their (b, kvh, L) storage
        write_kv_row(lc["ks"][:, :, None, :], ks_new[:, :, None], posv,
                     lc["vs"][:, :, None, :], vs_new[:, :, None])
    write_kv_row(lc["k"], k_row, posv, lc["v"], v_row)
    return lc.get("ks"), lc.get("vs")


def decode_step(params: dict, token, pos, cache, cfg: TransformerConfig,
                tp_axis=None, ep_axis=None, *, tp_algorithm: str = "psum",
                all_to_all_algorithm: str = "xla"):
    """One token (b,) at position ``pos`` (int, 0-d or (b,) int32 tensor
    on the params' device) through all layers with the cache. Returns
    (logits (b, vocab) f32, cache), the cache updated in place.

    A position at or beyond max_len writes nothing (K7 drops it), where
    the JAX package's scalar-pos path clamps the write into the last
    column; ``generate`` never reaches it (its max_len check), and the
    serving loop's retired slots rely on the drop."""
    cfg = _decode_cfg(cfg)
    dt = cfg.act_dtype
    dev = params["embed"].device
    posv = _pos_tensor(pos, dev)
    pos_arr = posv[:, None] if posv.dim() == 1 else posv[None]
    x = embed_tokens(params["embed"], token[:, None], pos_arr, cfg)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    for layer, lc in zip(params["layers"], cache):
        def attend(q, k, v, lc=lc):
            ks, vs = _write_rows(lc, k[:, 0], v[:, 0], posv)
            return _attend_cache(q, lc["k"], lc["v"], posv, scale,
                                 k_scale=ks, v_scale=vs).to(dt)

        x, _ = apply_layer(x, layer, cfg, tp_axis=tp_axis,
                           tp_algorithm=tp_algorithm, ep_axis=ep_axis,
                           all_to_all_algorithm=all_to_all_algorithm,
                           attention=attend, pos=pos_arr)
    x = _rmsnorm(x, params["ln_f"]["g"])
    logits = (x[:, 0, :] @ params["embed"].t().to(dt)).float()
    return logits, cache


def _write_block(lc, kt, vt, pos0):
    """A T-column cache write (in place, K8 in chunks of at most 128
    columns, k with v in one launch); kt, vt (b, kvh, T, hd), any
    strides (read in place). Returns the scale sidecars."""
    ks_new = vs_new = None
    if "ks" in lc:  # quantise over head_dim before the seq-minor flip
        kt, ks_new = _quantize_kv(kt)
        vt, vs_new = _quantize_kv(vt)
    kt, vt = kt.transpose(2, 3), vt.transpose(2, 3)   # (b, kvh, hd, T)
    T = kt.shape[3]
    for c0 in range(0, T, MAX_BLOCK_T):
        part = (kt, vt, ks_new, vs_new)
        if T > MAX_BLOCK_T:                     # this chunk's columns
            part = tuple(None if x is None else x[..., c0:c0 + MAX_BLOCK_T]
                         for x in part)
        k, v, ks, vs = part
        p0 = pos0 if c0 == 0 else pos0 + c0
        write_kv_block(lc["k"], k, p0, lc["v"], v)
        if ks is not None:
            write_kv_block(lc["ks"][:, :, None, :], ks[:, :, None, :], p0,
                           lc["vs"][:, :, None, :], vs[:, :, None, :])
    return lc.get("ks"), lc.get("vs")


def block_decode(params: dict, tokens, pos0, cache,
                 cfg: TransformerConfig, tp_axis=None, ep_axis=None, *,
                 tp_algorithm: str = "psum",
                 all_to_all_algorithm: str = "xla"):
    """T tokens (b, T) through the cache in one forward, row b's token i
    at pos0_b + i. Returns (logits (b, T, vocab) f32, cache), the cache
    updated in place. Write-then-attend with per-(row, i) masks."""
    cfg = _decode_cfg(cfg)
    dt = cfg.act_dtype
    dev = params["embed"].device
    b, T = tokens.shape
    pos0 = _pos_tensor(pos0, dev).reshape(-1).expand(b).contiguous()
    pos_arr = pos0[:, None] + torch.arange(T, dtype=torch.int32,
                                           device=dev)[None, :]
    x = embed_tokens(params["embed"], tokens, pos_arr, cfg)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    for layer, lc in zip(params["layers"], cache):
        def attend(q, k, v, lc=lc):
            ks, vs = _write_block(lc, k.transpose(1, 2), v.transpose(1, 2),
                                  pos0)
            return _attend_cache_block(q, lc["k"], lc["v"], pos0, scale,
                                       k_scale=ks, v_scale=vs).to(dt)

        x, _ = apply_layer(x, layer, cfg, tp_axis=tp_axis,
                           tp_algorithm=tp_algorithm, ep_axis=ep_axis,
                           all_to_all_algorithm=all_to_all_algorithm,
                           attention=attend, pos=pos_arr)
    x = _rmsnorm(x, params["ln_f"]["g"])
    logits = torch.einsum("btd,vd->btv", x,
                          params["embed"].to(dt)).float()
    return logits, cache


def prefill(params: dict, tokens, cache, cfg: TransformerConfig,
            tp_axis=None, ep_axis=None, last_index=None, *,
            tp_algorithm: str = "psum", all_to_all_algorithm: str = "xla"):
    """Fill the cache with the whole prompt in one forward. Returns
    (logits of the last prompt position, or of ``last_index`` (b,) per
    row, cache) with positions [0, plen) of the cache written in place.
    Causal attention over the prompt block runs through K2; int8 caches
    attend the dequantised block (the values decode reads back). MoE
    prompts route with the training capacity over the whole block; with
    ``last_index`` (ragged prompts) drop-free, so padding takes no
    expert's capacity."""
    if last_index is not None:
        cfg = _decode_cfg(cfg)
    b, plen = tokens.shape
    dt = cfg.act_dtype
    dev = params["embed"].device
    pos = torch.arange(plen, device=dev)
    x = embed_tokens(params["embed"], tokens, pos, cfg)
    for layer, lc in zip(params["layers"], cache):
        if plen > lc["k"].shape[3]:
            raise ValueError(f"prompt {plen} exceeds the cache's max_len "
                             f"{lc['k'].shape[3]}")

        def attend(q, k, v, lc=lc):
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # (b,kvh,plen,hd)
            if "ks" in lc:
                qk, ks = _quantize_kv(kt)
                qv, vs = _quantize_kv(vt)
                lc["k"][..., :plen].copy_(qk.transpose(2, 3))
                lc["v"][..., :plen].copy_(qv.transpose(2, 3))
                lc["ks"][..., :plen].copy_(ks)
                lc["vs"][..., :plen].copy_(vs)
                k = (qk.float() * ks[..., None]).transpose(1, 2).to(dt)
                v = (qv.float() * vs[..., None]).transpose(1, 2).to(dt)
            else:
                lc["k"][..., :plen].copy_(kt.transpose(2, 3))
                lc["v"][..., :plen].copy_(vt.transpose(2, 3))
            return _local_attention(q, k, v).to(dt)

        x, _ = apply_layer(x, layer, cfg, tp_axis=tp_axis,
                           tp_algorithm=tp_algorithm, ep_axis=ep_axis,
                           all_to_all_algorithm=all_to_all_algorithm,
                           attention=attend, pos=pos)
    x = _rmsnorm(x, params["ln_f"]["g"])
    if last_index is None:
        xl = x[:, -1, :]
    else:
        idx = _pos_tensor(last_index, dev).long()
        xl = x[torch.arange(b, device=dev), idx]
    logits = (xl @ params["embed"].t().to(dt)).float()
    return logits, cache


def prefill_scan(params: dict, tokens, cache, cfg: TransformerConfig,
                 tp_axis=None, ep_axis=None, *, tp_algorithm: str = "psum",
                 all_to_all_algorithm: str = "xla"):
    """One-token-at-a-time prefill through ``decode_step``: the parity
    oracle for ``prefill``."""
    b, plen = tokens.shape
    logits = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                         device=tokens.device)
    for t in range(plen):
        logits, cache = decode_step(
            params, tokens[:, t], t, cache, cfg, tp_axis, ep_axis,
            tp_algorithm=tp_algorithm,
            all_to_all_algorithm=all_to_all_algorithm)
    return logits, cache


def _pick_token(logits, generator: Optional[torch.Generator],
                temperature: float):
    if temperature == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


def _generate_prefill(params, prompt, cfg, *, max_new, max_len,
                      temperature, generator, prompt_lengths, **par):
    """generate()'s checks, cache and prefill: (logits, cache, pos0).
    ``par``: the axes and schedules of ``prefill``."""
    b, plen = prompt.shape
    max_len = max_len or (plen + max_new)
    if plen + max_new > max_len:
        raise ValueError(f"prompt {plen} + max_new {max_new} exceeds "
                         f"max_len {max_len}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    dev = params["embed"].device
    prompt = prompt.to(dev)
    cache = init_kv_cache(cfg, b, max_len, device=dev,
                          tp_axis=par.get("tp_axis"))
    if prompt_lengths is None:
        logits, cache = prefill(params, prompt, cache, cfg, **par)
        pos0 = torch.tensor(plen, dtype=torch.int32, device=dev)
    else:
        pos0 = _pos_tensor(prompt_lengths, dev).reshape(b)
        logits, cache = prefill(params, prompt, cache, cfg,
                                last_index=pos0 - 1, **par)
    return logits, cache, pos0


def _generate_decode(params, logits, cache, pos, cfg, max_new,
                     temperature, generator, **par):
    """generate()'s decode loop; the step after the last picked token
    is not run (its logits would go unused). ``par``: the axes and
    schedules of ``decode_step``."""
    toks = []
    for i in range(max_new):
        tok = _pick_token(logits, generator, temperature)
        toks.append(tok)
        if i + 1 < max_new:
            logits, cache = decode_step(params, tok, pos, cache, cfg, **par)
            pos = pos + 1
    if not toks:
        return torch.zeros((logits.shape[0], 0), dtype=torch.int32,
                           device=logits.device)
    return torch.stack(toks, dim=1)


def generate(params: dict, prompt, cfg: TransformerConfig, *,
             max_new: int, max_len: Optional[int] = None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             tp_axis=None, ep_axis=None, prompt_lengths=None,
             tp_algorithm: str = "psum", all_to_all_algorithm: str = "xla"):
    """Continuation of ``prompt`` (b, plen): returns (b, max_new) int32
    new tokens on the params' device. temperature 0 is greedy; > 0
    samples from softmax(logits / T) with ``generator``.
    ``prompt_lengths`` (b,) makes the prompts ragged: row i's prompt is
    prompt[i, :prompt_lengths[i]] and continues from its own end.

    Under ``tp_axis`` every rank gets the same prompt and returns the
    same tokens; sampling picks the same token on every rank when each
    rank's ``generator`` starts from the same state (the logits are the
    same bits everywhere). Under ``ep_axis`` each rank gets its own
    rows. ``tp_algorithm`` and ``all_to_all_algorithm`` are the
    schedules of ``transformer.apply_layer``."""
    par = dict(tp_axis=tp_axis, tp_algorithm=tp_algorithm, ep_axis=ep_axis,
               all_to_all_algorithm=all_to_all_algorithm)
    params = cast_params(params, cfg.act_dtype)
    logits, cache, pos0 = _generate_prefill(
        params, prompt, cfg, max_new=max_new, max_len=max_len,
        temperature=temperature, generator=generator,
        prompt_lengths=prompt_lengths, **par)
    return _generate_decode(params, logits, cache, pos0, cfg, max_new,
                            temperature, generator, **par)


def generate_timed(params: dict, prompt, cfg: TransformerConfig, *,
                   max_new: int, max_len: Optional[int] = None,
                   temperature: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   prompt_lengths=None, metrics=None):
    """``generate`` with serving telemetry: the same tokens, plus TTFT
    (call -> first token on the host, ``serve.ttft_usec``), per-token
    decode latency (``serve.tok_usec``) and ``serve.tokens_out``,
    recorded into ``metrics`` (default the port's ``SERVING``
    registry)."""
    from rlo_tpu_torch.utils.metrics import SERVING
    reg = SERVING if metrics is None else metrics
    t0 = time.perf_counter()
    params = cast_params(params, cfg.act_dtype)
    logits, cache, pos0 = _generate_prefill(
        params, prompt, cfg, max_new=max_new, max_len=max_len,
        temperature=temperature, generator=generator,
        prompt_lengths=prompt_lengths)
    if max_new > 0:
        first = _pick_token(logits, generator, temperature)
        first.cpu()                     # the first token on the host
        t1 = time.perf_counter()
        reg.histogram("serve.ttft_usec").observe((t1 - t0) * 1e6)
        toks = [first]
        pos = pos0
        for i in range(1, max_new):
            logits, cache = decode_step(params, toks[-1], pos, cache, cfg)
            pos = pos + 1
            toks.append(_pick_token(logits, generator, temperature))
        out = torch.stack(toks, dim=1)
        out.cpu()
        t2 = time.perf_counter()
        reg.histogram("serve.tok_usec").observe((t2 - t1) * 1e6 / max_new)
        reg.counter("serve.tokens_out").inc(int(out.shape[0]) * max_new)
        return out
    return torch.zeros((prompt.shape[0], 0), dtype=torch.int32,
                       device=logits.device)
