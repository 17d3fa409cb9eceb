"""The flagship decoder-only transformer: serving layer math and training.

The port of ``rlo_tpu/models/transformer.py``: ``TransformerConfig``,
``init_params`` (the same parameter tree and shapes, drawn from a
``torch.Generator``), ``_rmsnorm``, ``_sincos``, ``embed_tokens``,
``_rope``, ``_local_attention`` (causal attention through the flash
kernels, batch folded into the head axis) and ``apply_layer`` (attention
+ dense FFN, with the ``attention=`` hook the KV-cache decode uses); and
the single-card training half: ``next_token_targets``, ``nll_sum``,
``nll_sum_chunked``, ``forward``, ``loss_fn``, ``grads_and_loss`` (a
functional gradient), ``train_step`` (SGD) and ``train_step_optim`` (any
``torch.optim`` optimizer), with ``remat`` and ``loss_vocab_chunk`` and
the explicit data-parallel gradient combine over an ``Axis``.

Parameters are a plain dict of tensors in the JAX package's layouts
(``wqkv`` (d, 3, d), ``wq`` (d, d) + ``wkv`` (d, 2, kv_heads*head_dim),
``w1`` (d, d_ff), ``w2`` (d_ff, d), ``embed`` (vocab, d) tied with the
output head), float32 as initialised. Activations run in
``cfg.act_dtype``; each weight is cast to it where it is used, so a
tree cast once up front (``cast_params``) gives the same numbers, and
gradients come back in float32.

Sequence-, tensor- and expert-parallel training and mixture-of-experts
layers belong to later slices of the port and raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    # rematerialise each layer in the backward (torch.utils.checkpoint):
    # about one more forward of FLOPs for O(layers) less activation memory
    remat: bool = False
    # cross-entropy vocab chunking, a memory lever (None/0 = off): N > 0
    # streams the LM head's vocab axis in N-wide chunks through an online
    # logsumexp and never holds the (batch, block, vocab) logits
    loss_vocab_chunk: Optional[int] = None

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
    launch of the flash kernel K2 (``kernels.flash.flash_attention``),
    and its backward one of K4 and one of K5; the fold keeps the group
    mapping (b*H + h -> b*Hkv + h//G)."""
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
                f"{name} is not ported yet: sequence-, tensor- and "
                f"expert-parallel training need several processes on "
                f"several cards and come with the multi-card training "
                f"slice, tensor and expert parallel decode with the "
                f"MoE/TP/EP slice")
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


# ---------------------------------------------------------------------------
# Training: loss, gradients and the step
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """The tensors of a params (or grads) tree, in a fixed order (dict
    insertion order, then list order): what ``train_step_optim``'s
    optimizer is built over."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken from ``leaves`` in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def _single_card_training(sp_axis, tp_axis, ep_axis) -> None:
    for name, axis in (("sp_axis", sp_axis), ("tp_axis", tp_axis),
                       ("ep_axis", ep_axis)):
        if axis is not None:
            raise NotImplementedError(
                f"{name} training is not ported yet: sequence-, tensor- "
                f"and expert-parallel training put a collective inside "
                f"the backward, which needs several processes on several "
                f"cards (on one card's LocalMesh it would wait on the "
                f"autograd thread); it comes with a later slice of the "
                f"port")


def next_token_targets(tokens):
    """Next-token labels: shift left, zero-pad, and mask each row's
    final position. Returns (targets, valid f32)."""
    b, blk = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros((b, 1))], dim=1)
    valid = torch.ones((b, blk), dtype=torch.float32, device=tokens.device)
    valid[:, -1] = 0.0
    return targets, valid


def nll_sum(logits, targets, valid):
    """Summed masked next-token NLL and the valid-token count."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return (nll * valid).sum(), valid.sum()


def nll_sum_chunked(x, embed, targets, valid, chunk: int):
    """``nll_sum`` from the pre-head activations with the vocab axis
    streamed in ``chunk``-wide slices: nll = logsumexp(x . E^T) -
    x . E[target], the logsumexp accumulated online (a running max and
    sum of exps). The (b, blk, vocab) logits never exist; each chunk
    step runs under ``torch.utils.checkpoint``, so the backward
    recomputes a chunk's logits instead of keeping them. Products take
    the activation dtype's values and sum in f32, as the JAX package's
    einsums with an f32 result do."""
    v = embed.shape[0]
    ed = embed.to(x.dtype)
    xf = x.float()
    tgt_logit = (xf * ed[targets.long()].float()).sum(-1)
    b, blk = targets.shape
    m = torch.full((b, blk), float("-inf"), dtype=torch.float32,
                   device=x.device)
    s = torch.zeros((b, blk), dtype=torch.float32, device=x.device)

    def step(m, s, emb):
        lg = xf @ emb.float().t()
        m2 = torch.maximum(m, lg.amax(dim=-1))
        return m2, s * torch.exp(m - m2) + torch.exp(
            lg - m2[..., None]).sum(dim=-1)

    for c0 in range(0, v, chunk):
        m, s = checkpoint(step, m, s, ed[c0:c0 + chunk],
                          use_reentrant=False)
    nll = m + torch.log(s) - tgt_logit
    return (nll * valid).sum(), valid.sum()


def _features(params: dict, tokens, cfg: TransformerConfig):
    """The body up to and including the final norm: (b, blk, d) pre-head
    activations and the aux loss (0 for dense layers). ``cfg.remat``
    checkpoints each layer."""
    b, blk = tokens.shape
    pos = torch.arange(blk, device=tokens.device)
    x = embed_tokens(params["embed"], tokens, pos, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(x, layer):
        return apply_layer(x, layer, cfg, pos=pos)

    for layer in params["layers"]:
        if cfg.remat:
            x, aux = checkpoint(block, x, layer, use_reentrant=False)
        else:
            x, aux = block(x, layer)
        aux_total = aux_total + aux
    return _rmsnorm(x, params["ln_f"]["g"]), aux_total


def forward(params: dict, tokens, cfg: TransformerConfig,
            sp_axis=None, tp_axis=None, ep_axis=None,
            with_aux: bool = False):
    """Next-token logits (f32), causal; (logits, aux) with ``with_aux``.
    ``tokens`` (batch, block) integers."""
    _single_card_training(sp_axis, tp_axis, ep_axis)
    x, aux = _features(params, tokens, cfg)
    logits = (x @ params["embed"].t().to(cfg.act_dtype)).float()
    return (logits, aux) if with_aux else logits


def loss_fn(params: dict, tokens, cfg: TransformerConfig, sp_axis=None,
            tp_axis=None, ep_axis=None):
    """Mean next-token cross-entropy over the valid positions (the dense
    layers' aux term is 0). ``cfg.loss_vocab_chunk`` streams the head."""
    _single_card_training(sp_axis, tp_axis, ep_axis)
    x, _ = _features(params, tokens, cfg)
    targets, valid = next_token_targets(tokens)
    chunk = cfg.loss_vocab_chunk or 0
    if chunk:
        local, count = nll_sum_chunked(x, params["embed"], targets, valid,
                                       chunk)
    else:
        logits = (x @ params["embed"].t().to(cfg.act_dtype)).float()
        local, count = nll_sum(logits, targets, valid)
    return local / count


def grads_and_loss(params: dict, tokens, cfg: TransformerConfig,
                   sp_axis=None, dp_axis=None, tp_axis=None, ep_axis=None,
                   grad_algorithm: str = "psum", dcn_axis=None,
                   dcn_algorithm: str = "psum"):
    """(loss, grads): the gradient of ``loss_fn`` by
    ``torch.autograd.grad`` over the parameter leaves, as a tree shaped
    like ``params`` (nothing accumulates into ``.grad``, so ranks may
    run this on threads at once).

    ``dp_axis`` (an ``Axis``: a ``LocalMesh`` axis or a ``DistAxis``)
    combines each rank's grads explicitly after the backward:
    ``allreduce(g, dp_axis, algorithm=grad_algorithm) / n``, or with
    ``dcn_axis`` (a second, slower data-parallel tier)
    ``hierarchical_allreduce(g, dp_axis, dcn_axis,
    dcn_algorithm=dcn_algorithm) / n``, n the product of the sizes; the
    loss is averaged over the same axes."""
    _single_card_training(sp_axis, tp_axis, ep_axis)
    if dcn_axis is not None and dp_axis is None:
        raise ValueError("dcn_axis requires dp_axis (it is the second, "
                         "cross-slice tier of data parallelism)")
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = loss_fn(_rebuild(params, iter(live)), tokens, cfg)
    grads = list(torch.autograd.grad(loss, live))
    loss = loss.detach()
    if dp_axis is not None:
        from rlo_tpu_torch.ops import device_collectives as dc
        n = dp_axis.size * (1 if dcn_axis is None else dcn_axis.size)
        if dcn_axis is not None:
            grads = [dc.hierarchical_allreduce(
                g, dp_axis, dcn_axis, dcn_algorithm=dcn_algorithm) / n
                for g in grads]
        else:
            grads = [dc.allreduce(g, dp_axis, algorithm=grad_algorithm) / n
                     for g in grads]
        loss = dc.allreduce(loss, dp_axis, algorithm="psum") / dp_axis.size
        if dcn_axis is not None:
            loss = dc.allreduce(loss, dcn_axis, algorithm="psum") \
                / dcn_axis.size
    return loss, _rebuild(params, iter(grads))


def train_step(params: dict, tokens, cfg: TransformerConfig,
               lr: float = 1e-2, sp_axis=None, dp_axis=None, tp_axis=None,
               ep_axis=None, grad_algorithm: str = "psum", dcn_axis=None,
               dcn_algorithm: str = "psum"):
    """One SGD step; returns (new_params, loss). ``params`` is left as
    it was."""
    loss, grads = grads_and_loss(params, tokens, cfg, sp_axis=sp_axis,
                                 dp_axis=dp_axis, tp_axis=tp_axis,
                                 ep_axis=ep_axis,
                                 grad_algorithm=grad_algorithm,
                                 dcn_axis=dcn_axis,
                                 dcn_algorithm=dcn_algorithm)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(tree_leaves(params),
                                          tree_leaves(grads))]
    return _rebuild(params, iter(new)), loss


def train_step_optim(params: dict, optimizer, tokens,
                     cfg: TransformerConfig, sp_axis=None, dp_axis=None,
                     tp_axis=None, ep_axis=None,
                     grad_algorithm: str = "psum", dcn_axis=None,
                     dcn_algorithm: str = "psum"):
    """One step of ``optimizer``, a ``torch.optim`` optimizer built over
    ``tree_leaves(params)`` (its state is the counterpart of the JAX
    package's optax state). The grads of ``grads_and_loss`` are handed
    to it as each leaf's ``.grad``, it steps, and the ``.grad`` fields
    are cleared again. Updates ``params`` in place; returns
    (params, loss)."""
    loss, grads = grads_and_loss(params, tokens, cfg, sp_axis=sp_axis,
                                 dp_axis=dp_axis, tp_axis=tp_axis,
                                 ep_axis=ep_axis,
                                 grad_algorithm=grad_algorithm,
                                 dcn_axis=dcn_axis,
                                 dcn_algorithm=dcn_algorithm)
    leaves = tree_leaves(params)
    for p, g in zip(leaves, tree_leaves(grads)):
        p.grad = g
    optimizer.step()
    for p in leaves:
        p.grad = None
    return params, loss
