"""The flagship decoder-only transformer, as the serving path runs it.

The port of the layer math of ``rlo_tpu/models/transformer.py``:
``TransformerConfig``, ``init_params`` (the same parameter tree and
shapes, drawn from a ``torch.Generator``), ``_rmsnorm``, ``_sincos``,
``embed_tokens``, ``_rope``, ``_local_attention`` (causal attention
through the flash kernel K2, batch folded into the head axis) and
``apply_layer`` (attention + dense FFN, with the ``attention=`` hook the
KV-cache decode uses).

Parameters are a plain dict of tensors in the JAX package's layouts
(``wqkv`` (d, 3, d), ``wq`` (d, d) + ``wkv`` (d, 2, kv_heads*head_dim),
``w1`` (d, d_ff), ``w2`` (d_ff, d), ``embed`` (vocab, d) tied with the
output head), float32 as initialised. Activations run in
``cfg.act_dtype``; each weight is cast to it where it is used, so a
tree cast once up front (``cast_params``) gives the same numbers.

Sequence, tensor and expert parallelism and mixture-of-experts layers
belong to later slices of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    dtype: str = "bfloat16"  # activation dtype; params stay float32
    # mixture-of-experts FFN (0 = dense); MoE layers are a later slice
    n_experts: int = 0
    # grouped-query attention: K/V heads (None = n_heads, MHA)
    n_kv_heads: Optional[int] = None
    # 'sincos' (added at the embedding) or 'rope' (q/k rotated in every
    # layer; keys are cached rotated)
    pos_encoding: str = "sincos"
    rope_scaling: Optional[str] = None   # None, 'linear' or 'ntk'
    rope_scale: float = 1.0
    # KV-cache storage for generation: None (activation dtype) or
    # 'int8' (per-(position, head) symmetric quantisation with f32
    # scale sidecars)
    kv_cache_dtype: Optional[str] = None

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"n_heads {self.n_heads} must divide "
                             f"d_model {self.d_model}")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        if self.n_kv_heads is None:
            return self.n_heads
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_kv_heads {self.n_kv_heads} must divide "
                             f"n_heads {self.n_heads}")
        return self.n_kv_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts layers are not ported yet: they come "
            "with the MoE/TP/EP decode slice of the port")


def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> dict:
    """Scaled-normal init with the JAX package's tree, shapes and
    scales, drawn from a ``torch.Generator`` seeded with ``seed`` (the
    numbers differ from ``jax.random``'s; tests carry the JAX package's
    own params across with ``convert.params_from_numpy``). ``device``
    None is the card."""
    from rlo_tpu_torch.parallel.mesh import resolve_device
    _dense_only(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff

    def norm(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    def ones():
        return torch.ones((d,), device=dev, dtype=torch.float32)

    params = {"embed": norm((cfg.vocab, d), 0.02), "ln_f": {"g": ones()},
              "layers": []}
    for _ in range(cfg.n_layers):
        layer = {"ln1": {"g": ones()},
                 "wo": norm((d, d), (2 * d * cfg.n_layers) ** -0.5),
                 "ln2": {"g": ones()}}
        if cfg.kv_heads == cfg.n_heads:
            layer["wqkv"] = norm((d, 3, d), d ** -0.5)
        else:
            layer["wq"] = norm((d, d), d ** -0.5)
            layer["wkv"] = norm((d, 2, cfg.kv_heads * cfg.head_dim),
                                d ** -0.5)
        layer["w1"] = norm((d, f), d ** -0.5)
        layer["w2"] = norm((f, d), (2 * f * cfg.n_layers) ** -0.5)
        params["layers"].append(layer)
    return params


def cast_params(params, dtype: torch.dtype):
    """The same tree with every tensor cast to ``dtype`` (the per-use
    casts of the layer math then cost nothing)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype)


def _rmsnorm(x, g):
    # bf16 x times an f32 rsqrt promotes to f32, casts back, then the
    # gain multiplies in x's dtype: the JAX package's promotion order
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * g.to(x.dtype)


def _freqs(half: int, base: float, device) -> torch.Tensor:
    return torch.exp(-math.log(base)
                     * torch.arange(half, dtype=torch.float32,
                                    device=device) / half)


def _sincos(pos, d_model, dtype):
    """Sinusoidal encodings of global positions ``pos`` (blk,) or
    (b, blk); returns (blk, d) or (b, blk, d)."""
    ang = pos[..., None].float() * _freqs(d_model // 2, 10000.0,
                                          pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _check_pos_encoding(cfg: TransformerConfig) -> None:
    if cfg.pos_encoding not in ("sincos", "rope"):
        raise ValueError(f"unknown pos_encoding {cfg.pos_encoding!r}; "
                         f"known: 'sincos', 'rope'")
    if cfg.pos_encoding == "rope" and cfg.head_dim % 2:
        raise ValueError(f"rope needs an even head_dim; got "
                         f"{cfg.head_dim}")
    if cfg.rope_scaling is not None:
        if cfg.pos_encoding != "rope":
            raise ValueError(f"rope_scaling={cfg.rope_scaling!r} "
                             f"requires pos_encoding='rope'")
        if cfg.rope_scaling not in ("linear", "ntk"):
            raise ValueError(f"unknown rope_scaling "
                             f"{cfg.rope_scaling!r}; known: 'linear', "
                             f"'ntk'")
        if cfg.rope_scale < 1.0:
            raise ValueError(f"rope_scale must be >= 1; got "
                             f"{cfg.rope_scale}")


def embed_tokens(embed, tokens, pos, cfg: TransformerConfig):
    """Token embedding (+ the sincos encoding at ``pos``)."""
    _check_pos_encoding(cfg)
    x = embed[tokens].to(cfg.act_dtype)
    if cfg.pos_encoding == "sincos":
        x = x + _sincos(pos, cfg.d_model, cfg.act_dtype)
    return x


def _rope(t, pos, scaling: Optional[str] = None, scale: float = 1.0):
    """Rotate dim pairs (i, i + head_dim/2) of ``t`` (b, blk, heads,
    head_dim) by angles of ``pos`` (blk,) shared or (b, blk) per row."""
    hd = t.shape[-1]
    half = hd // 2
    base = 10000.0
    posf = pos.float()
    if scaling == "linear":
        posf = posf / scale
    elif scaling == "ntk":
        base = base * float(scale) ** (hd / (hd - 2))
    elif scaling is not None:
        raise ValueError(f"unknown rope_scaling {scaling!r}; known: "
                         f"'linear', 'ntk'")
    ang = posf[..., None] * _freqs(half, base, t.device)
    if ang.dim() == 2:
        cos, sin = torch.cos(ang)[None, :, None, :], \
            torch.sin(ang)[None, :, None, :]
    else:
        cos, sin = torch.cos(ang)[:, :, None, :], \
            torch.sin(ang)[:, :, None, :]
    t32 = t.float()
    t1, t2 = t32[..., :half], t32[..., half:]
    return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos],
                     dim=-1).to(t.dtype)


def _local_attention(q, k, v):
    """Unsharded causal attention: q (b, L, H, D); k/v (b, L, Hkv, D)
    with Hkv dividing H (query head h attends K/V head h // (H/Hkv)).
    The batch folds into the head axis, so the whole batch is one
    launch of the flash kernel K2 (``kernels.flash.flash_attention``);
    the fold keeps the group mapping (b*H + h -> b*Hkv + h//G)."""
    from rlo_tpu_torch.kernels.flash import flash_attention
    b, L, nh, hd = q.shape

    def fold(t):
        return t.transpose(0, 1).reshape(L, b * t.shape[2], hd)

    out = flash_attention(fold(q), fold(k), fold(v), causal=True)
    return out.reshape(L, b, nh, hd).transpose(0, 1)


def apply_layer(x, layer: dict, cfg: TransformerConfig, *,
                sp_axis=None, tp_axis=None, ep_axis=None, attention=None,
                pos=None):
    """One layer (attention + dense FFN) on ``x`` (b, blk, d); returns
    (x, aux) with aux a zero f32 scalar. ``attention(q, k, v)`` gets q
    (b, blk, heads, head_dim) and the compact k/v (b, blk, kv_heads,
    head_dim) and returns the q shape; None is causal attention over
    the block through K2."""
    for name, axis in (("sp_axis", sp_axis), ("tp_axis", tp_axis),
                       ("ep_axis", ep_axis)):
        if axis is not None:
            raise NotImplementedError(
                f"{name} is not ported yet: sequence parallelism comes "
                f"with the training slice, tensor and expert parallel "
                f"decode with the MoE/TP/EP slice")
    _dense_only(cfg)
    b, blk, _ = x.shape
    dt = x.dtype
    hd = cfg.head_dim
    h = _rmsnorm(x, layer["ln1"]["g"])
    if cfg.kv_heads == cfg.n_heads:
        w = layer["wqkv"].to(dt)
        q, k, v = torch.split(h @ w.reshape(w.shape[0], -1), cfg.d_model,
                              dim=-1)
    else:
        q = h @ layer["wq"].to(dt)
        wkv = layer["wkv"].to(dt)
        k, v = torch.split(h @ wkv.reshape(wkv.shape[0], -1),
                           cfg.kv_heads * hd, dim=-1)
    q = q.reshape(b, blk, cfg.n_heads, hd)
    k = k.reshape(b, blk, cfg.kv_heads, hd)
    v = v.reshape(b, blk, cfg.kv_heads, hd)
    if cfg.pos_encoding == "rope":
        if pos is None:
            raise ValueError("rope needs per-layer positions")
        q = _rope(q, pos, cfg.rope_scaling, cfg.rope_scale)
        k = _rope(k, pos, cfg.rope_scaling, cfg.rope_scale)
    att = attention(q, k, v) if attention is not None \
        else _local_attention(q, k, v)
    att = att.reshape(b, blk, cfg.n_heads * hd)
    x = x + att @ layer["wo"].to(dt)
    h = _rmsnorm(x, layer["ln2"]["g"])
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h @ layer["w1"].to(dt), approximate="tanh")
    x = x + h @ layer["w2"].to(dt)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)
