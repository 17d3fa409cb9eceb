"""The flagship decoder-only transformer: serving layer math and training.

The port of ``rlo_tpu/models/transformer.py``: ``TransformerConfig``,
``init_params`` (the same parameter tree and shapes, drawn from a
``torch.Generator``), ``_rmsnorm``, ``_sincos``, ``embed_tokens``,
``_rope``, ``_local_attention`` (causal attention through the flash
kernels, batch folded into the head axis) and ``apply_layer`` (attention
+ dense or mixture-of-experts FFN (``models.moe``), with the
``attention=`` hook the KV-cache decode uses); and
the single-card training half: ``next_token_targets``, ``nll_sum``,
``nll_sum_chunked``, ``forward``, ``loss_fn``, ``grads_and_loss`` (a
functional gradient), ``train_step`` (SGD) and ``train_step_optim`` (any
``torch.optim`` optimizer), with ``remat`` and ``loss_vocab_chunk`` and
the explicit data-parallel gradient combine over an ``Axis``.

Parameters are a plain dict of tensors in the JAX package's layouts
(``wqkv`` (d, 3, d), ``wq`` (d, d) + ``wkv`` (d, 2, kv_heads*head_dim),
``w1`` (d, d_ff), ``w2`` (d_ff, d), or for MoE configs ``moe`` {``wr``
(d, E), ``w1`` (E, d, d_ff), ``w2`` (E, d_ff, d)}, ``embed`` (vocab, d)
tied with the output head), float32 as initialised. Activations run in
``cfg.act_dtype``; each weight is cast to it where it is used (the MoE
router ``wr`` stays f32), so a tree cast once up front
(``cast_params``) gives the same numbers, and gradients come back in
float32.

Model parallelism: ``tp_axis`` (heads and hidden units split per
``param_pspecs``, the row-parallel sums through
``ops.device_collectives.allreduce``), ``ep_axis`` (experts split,
tokens crossing ranks in ``models.moe``'s two all_to_alls) and
``sp_axis`` (the sequence split, attention through
``ops.ring_attention`` or ``ops.ulysses``), for inference and training.
An axis is an ``Axis`` of ``parallel.mesh``: a ``LocalMesh`` rank (a
thread) or a ``DistAxis`` process. Training puts collectives inside the
backward, which JAX's autodiff transposes under ``shard_map``'s vma
typing; here ``parallel.autodiff`` gives each its transpose: the
row-parallel psum passes the cotangent on, the tp-invariant activation
entering a tp-split product sums its cotangent over tp, ppermutes and
all_to_alls send theirs back, and ``grads_and_loss`` sums each
parameter's gradient over every data-carrying axis (sp, ep, dp, dcn)
that its spec does not split it over. A collective inside a backward
runs on a CPU ``LocalMesh`` (each rank's backward on its own thread);
on a card the ranks are processes.

Spans (``utils.tracing.annotate``, named for a profile; a flag test and
an NVTX range otherwise): ``rlo.train.step`` around
``train_step_optim``, inside it ``rlo.train.forward`` (the loss),
``rlo.train.backward`` (``torch.autograd.grad``) and
``rlo.train.optimizer``; ``rlo.layer.attention`` and ``rlo.layer.ffn``
in each layer of the training forward (``apply_layer(spans=True)``, as
``_features`` calls it; the decode paths open none),
``rlo.train.head`` around the head and its NLL, and
``rlo.train.recompute`` around each of remat's recomputations, which
autograd runs inside the backward.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rlo_tpu_torch.models.moe import init_moe_params, moe_ffn
from rlo_tpu_torch.parallel.autodiff import psum_invariant, pvary
from rlo_tpu_torch.utils.tracing import annotate

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
    # mixture-of-experts FFN (0 = dense): top-1 routing with capacity
    # capacity_factor * tokens / n_experts per expert (models.moe), and
    # the load-balancing aux term weighted by moe_aux_coef in the loss
    n_experts: int = 0
    capacity_factor: float = 2.0
    moe_aux_coef: float = 1e-2
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
    # sequence-parallel attention under sp_axis: 'ring' (K/V rotate over
    # the ring, ops.ring_attention) or 'ulysses' (all_to_all head
    # scatter, ops.ulysses)
    sp_attention: str = "ring"
    # how the sequence is split over sp_axis: 'contiguous' (rank r holds
    # tokens [r*blk, (r+1)*blk)) or 'striped' (rank r holds tokens r,
    # r+sp, ...: ring_attention.stripe_sequence; ring only). The JAX
    # package's forward is contiguous only
    sp_layout: str = "contiguous"

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


def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> dict:
    """Scaled-normal init with the JAX package's tree, shapes and
    scales, drawn from a ``torch.Generator`` seeded with ``seed`` (the
    numbers differ from ``jax.random``'s; tests carry the JAX package's
    own params across with ``convert.params_from_numpy``). ``device``
    None is the card."""
    from rlo_tpu_torch.parallel.mesh import resolve_device
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
        if cfg.n_experts > 0:
            layer["moe"] = init_moe_params(gen, d, f, cfg.n_experts)
        else:
            layer["w1"] = norm((d, f), d ** -0.5)
            layer["w2"] = norm((f, d), (2 * f * cfg.n_layers) ** -0.5)
        params["layers"].append(layer)
    return params


def param_pspecs(cfg: TransformerConfig, tp_axis: Optional[str] = None,
                 ep_axis: Optional[str] = None) -> dict:
    """The ``PartitionSpec`` tree of ``init_params``' output, leaf for
    leaf the JAX package's: with ``tp_axis`` ``wqkv`` and ``w1`` are
    column-parallel (split by head and hidden unit), ``wo`` and ``w2``
    row-parallel; GQA's ``wq``/``wkv`` split by (kv-)head; with
    ``ep_axis`` the expert axis of ``moe.w1``/``moe.w2`` is split and the
    router ``wr`` replicated. Everything else is replicated. Give it to
    ``parallel.sharding.shard_tree`` with the rank's axes."""
    from rlo_tpu_torch.parallel.sharding import PartitionSpec as P
    t = tp_axis

    def layer():
        out = {"ln1": {"g": P()}, "wo": P(t, None), "ln2": {"g": P()}}
        if cfg.kv_heads == cfg.n_heads:
            out["wqkv"] = P(None, None, t)
        else:
            out["wq"] = P(None, t)
            out["wkv"] = P(None, None, t)
        if cfg.n_experts > 0:
            out["moe"] = {"wr": P(), "w1": P(ep_axis, None, None),
                          "w2": P(ep_axis, None, None)}
        else:
            out["w1"] = P(None, t)
            out["w2"] = P(t, None)
        return out

    return {"embed": P(), "ln_f": {"g": P()},
            "layers": [layer() for _ in range(cfg.n_layers)]}


def cast_params(params, dtype: torch.dtype):
    """The same tree with every tensor but the MoE router ``wr`` cast to
    ``dtype`` (the per-use casts of the layer math then cost nothing;
    the router computes in f32)."""
    if isinstance(params, dict):
        return {k: v if k == "wr" else cast_params(v, dtype)
                for k, v in params.items()}
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


def _sp_attention(q, k, v, cfg: TransformerConfig, sp_axis):
    """Causal attention over the sequence split on ``sp_axis``: q (b,
    blk, H, D), compact k/v (b, blk, Hkv, D). The batch folds into the
    head axis (b*H + h -> b*Hkv + h//G keeps the GQA grouping), so one
    ring or Ulysses call carries every row."""
    b, blk, nh, hd = q.shape

    def fold(t):
        return t.transpose(0, 1).reshape(blk, b * t.shape[2], hd)

    if cfg.sp_attention == "ulysses":
        from rlo_tpu_torch.ops.ulysses import ulysses_attention
        if cfg.sp_layout != "contiguous":
            raise ValueError("ulysses attends a contiguous split only")
        # per row, as the JAX package asks (the batch fold could hide it)
        if nh % sp_axis.size:
            raise ValueError(f"ulysses needs the axis size ({sp_axis.size}) "
                             f"to divide the head count ({nh}); use ring "
                             f"attention for few-head configs")
        att = ulysses_attention(fold(q), fold(k), fold(v), sp_axis,
                                causal=True)
    elif cfg.sp_attention == "ring":
        from rlo_tpu_torch.ops.ring_attention import ring_attention
        att = ring_attention(fold(q), fold(k), fold(v), sp_axis, causal=True,
                             layout=cfg.sp_layout)
    else:
        raise ValueError(f"unknown sp_attention {cfg.sp_attention!r}; "
                         f"known: 'ring', 'ulysses'")
    return att.reshape(blk, b, nh, hd).transpose(0, 1)


def apply_layer(x, layer: dict, cfg: TransformerConfig, *,
                sp_axis=None, tp_axis=None, tp_algorithm: str = "psum",
                ep_axis=None, all_to_all_algorithm: str = "xla",
                attention=None, pos=None, spans: bool = False):
    """One layer (attention + dense or MoE FFN) on ``x`` (b, blk, d);
    returns (x, aux), aux the MoE load-balancing term (a zero f32 scalar
    for dense layers). ``attention(q, k, v)`` gets q
    (b, blk, heads, head_dim) and the compact k/v (b, blk, kv_heads,
    head_dim) and returns the q shape; None is causal attention over
    the block through K2, or over the sequence split on ``sp_axis``.

    With ``tp_axis`` the weights are this rank's slices (``param_pspecs``):
    it computes n_heads/tp heads (kv_heads/tp K/V heads; the hook sees
    these local heads) and d_ff/tp hidden units, and the row-parallel
    products of ``wo`` and ``w2`` are summed over the axis by
    ``allreduce(algorithm=tp_algorithm)`` (K1 on the manual schedules)
    and cast back to the activation dtype. Under autograd the sums over
    tp sit where JAX's vma typing inserts them (``autodiff.pvary``, whose
    backward sums the cotangent over tp): with 'psum' the residual is
    tp-invariant and the normed activation enters the column-parallel
    products through ``pvary``; with a manual schedule the residual
    varies over tp (``x`` must already: ``forward`` passes the
    embedding's output through ``pvary``) and each tp-replicated
    parameter (the norm gains, an MoE layer's weights) goes through
    ``pvary`` at its use instead, the activations through none.
    ``ep_axis`` splits the experts (``models.moe``; its two all_to_alls
    take ``all_to_all_algorithm``: 'xla', 'direct' or 'ring'). Every rank
    must call this with the same shapes (the collectives pair up across
    ranks). ``spans`` opens the ``rlo.layer.attention`` and
    ``rlo.layer.ffn`` ranges (the training forward's); the host-bound
    decode step leaves them out."""
    b, blk, _ = x.shape
    dt = x.dtype
    hd = cfg.head_dim
    ntp = tp_axis.size if tp_axis is not None else 1
    if cfg.n_heads % ntp or cfg.d_ff % ntp:
        raise ValueError(f"tp={ntp} must divide n_heads {cfg.n_heads} and "
                         f"d_ff {cfg.d_ff}")
    if cfg.kv_heads % ntp:
        raise ValueError(f"tp={ntp} must divide n_kv_heads {cfg.kv_heads}")
    nh, nkv = cfg.n_heads // ntp, cfg.kv_heads // ntp
    varies = _tp_varies(tp_axis, tp_algorithm)

    def shared(t):      # a tp-replicated leaf where it meets x
        return pvary(t, tp_axis) if varies else t

    def act(t):         # an activation meeting a tp-split weight
        return t if varies else pvary(t, tp_axis)

    def tp_sum(t):
        if tp_axis is None:
            return t
        from rlo_tpu_torch.ops.device_collectives import allreduce
        return allreduce(t, tp_axis, algorithm=tp_algorithm).to(t.dtype)

    span = annotate if spans else _no_span
    with span("rlo.layer.attention"):
        h = act(_rmsnorm(x, shared(layer["ln1"]["g"])))
        if cfg.kv_heads == cfg.n_heads:
            w = layer["wqkv"].to(dt)           # (d, 3, local heads x hd)
            q, k, v = torch.split(h @ w.reshape(w.shape[0], -1), nh * hd,
                                  dim=-1)
        else:
            q = h @ layer["wq"].to(dt)
            wkv = layer["wkv"].to(dt)
            k, v = torch.split(h @ wkv.reshape(wkv.shape[0], -1), nkv * hd,
                               dim=-1)
        q = q.reshape(b, blk, nh, hd)
        k = k.reshape(b, blk, nkv, hd)
        v = v.reshape(b, blk, nkv, hd)
        if cfg.pos_encoding == "rope":
            if pos is None:
                raise ValueError("rope needs per-layer positions")
            q = _rope(q, pos, cfg.rope_scaling, cfg.rope_scale)
            k = _rope(k, pos, cfg.rope_scaling, cfg.rope_scale)
        if attention is not None:
            att = attention(q, k, v)
        elif sp_axis is not None:
            att = _sp_attention(q, k, v, cfg, sp_axis)
        else:
            att = _local_attention(q, k, v)
        att = att.reshape(b, blk, nh * hd)
        x = x + tp_sum(att @ layer["wo"].to(dt))
    with span("rlo.layer.ffn"):
        h = _rmsnorm(x, shared(layer["ln2"]["g"]))
        if cfg.n_experts > 0:
            moe = {k: shared(v) for k, v in layer["moe"].items()}
            ffn, aux = moe_ffn(moe, h, cfg.n_experts,
                               capacity_factor=cfg.capacity_factor,
                               ep_axis=ep_axis,
                               all_to_all_algorithm=all_to_all_algorithm)
            return x + ffn, aux
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(act(h) @ layer["w1"].to(dt), approximate="tanh")
        x = x + tp_sum(h @ layer["w2"].to(dt))
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


def _no_span(name: str):
    """``annotate``'s stand-in where a layer opens no span."""
    return contextlib.nullcontext()


def _recompute_span():
    """``checkpoint``'s ``context_fn``: nothing around the first forward,
    the ``rlo.train.recompute`` range around autograd's recomputation
    (on whatever thread runs the backward)."""
    return contextlib.nullcontext(), annotate("rlo.train.recompute")


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
                          use_reentrant=False, context_fn=_recompute_span)
    nll = m + torch.log(s) - tgt_logit
    return (nll * valid).sum(), valid.sum()


def _positions(blk: int, cfg: TransformerConfig, sp_axis, device):
    """The global positions of this rank's ``blk`` tokens: 0..blk-1, or
    under ``sp_axis`` the rank's block of the split sequence
    (``cfg.sp_layout``)."""
    ar = torch.arange(blk, device=device)
    if sp_axis is None:
        return ar
    if cfg.sp_layout == "contiguous":
        return sp_axis.index * blk + ar
    if cfg.sp_layout == "striped":
        return sp_axis.index + sp_axis.size * ar
    raise ValueError(f"unknown sp_layout {cfg.sp_layout!r}; known: "
                     f"'contiguous', 'striped'")


def _tp_varies(tp_axis, tp_algorithm: str) -> bool:
    """Whether the residual varies over tp: a manual schedule's sum does
    (JAX's vma typing), psum's does not."""
    return tp_axis is not None and tp_algorithm != "psum"


def _features(params: dict, tokens, cfg: TransformerConfig, sp_axis=None,
              tp_axis=None, tp_algorithm: str = "psum", ep_axis=None,
              all_to_all_algorithm: str = "xla"):
    """The body up to and including the final norm: (b, blk, d) pre-head
    activations and the aux loss (0 for dense layers). ``cfg.remat``
    checkpoints each layer. Under a manual ``tp_algorithm`` the
    embedding's output enters the layers through ``pvary`` (JAX sums its
    cotangent over tp at the first layer's normed activation and at its
    first residual add: the same sum, moved before a map linear in the
    cotangent) and ``ln_f``'s gain through ``pvary`` at its use."""
    b, blk = tokens.shape
    pos = _positions(blk, cfg, sp_axis, tokens.device)
    x = embed_tokens(params["embed"], tokens, pos, cfg)
    varies = _tp_varies(tp_axis, tp_algorithm)
    if varies:
        x = pvary(x, tp_axis)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(x, layer):
        return apply_layer(x, layer, cfg, sp_axis=sp_axis, tp_axis=tp_axis,
                           tp_algorithm=tp_algorithm, ep_axis=ep_axis,
                           all_to_all_algorithm=all_to_all_algorithm,
                           pos=pos, spans=True)

    for layer in params["layers"]:
        if cfg.remat:
            x, aux = checkpoint(block, x, layer, use_reentrant=False,
                                context_fn=_recompute_span)
        else:
            x, aux = block(x, layer)
        aux_total = aux_total + aux
    ln_f = params["ln_f"]["g"]
    return _rmsnorm(x, pvary(ln_f, tp_axis) if varies else ln_f), aux_total


def forward(params: dict, tokens, cfg: TransformerConfig,
            sp_axis=None, tp_axis=None, tp_algorithm: str = "psum",
            ep_axis=None, all_to_all_algorithm: str = "xla",
            with_aux: bool = False):
    """Next-token logits (f32), causal; (logits, aux) with ``with_aux``.
    ``tokens`` (batch, block) integers: under ``sp_axis`` this rank's
    block of the sequence (``cfg.sp_layout``), under ``ep_axis`` this
    rank's rows. With ``tp_axis``/``ep_axis`` the params are this rank's
    slices (``param_pspecs``); ``tp_algorithm`` picks the row-parallel
    sum's schedule (psum / ring / bidir_ring / recursive_doubling /
    halving_doubling) and ``all_to_all_algorithm`` the MoE dispatch's
    (xla / direct / ring). Every rank ends with the logits of its tokens
    (under tp the same bits on every rank); aux is the rank's own
    tokens' term.

    Differentiable under every axis and every ``tp_algorithm`` (the JAX
    package's transposes, ``parallel.autodiff``). With 'psum' the logits
    are tp-invariant; with a manual schedule they vary over tp, as in the
    JAX package, so each rank's gradient is that of the sum of every
    rank's loss (tp times psum's for a loss every rank computes alike):
    the head's ``embed`` enters through ``pvary``."""
    x, aux = _features(params, tokens, cfg, sp_axis, tp_axis, tp_algorithm,
                       ep_axis, all_to_all_algorithm)
    embed = params["embed"]
    if _tp_varies(tp_axis, tp_algorithm):
        embed = pvary(embed, tp_axis)
    logits = (x @ embed.t().to(cfg.act_dtype)).float()
    return (logits, aux) if with_aux else logits


def _sp_targets(tokens, sp_axis):
    """Next-token labels of this rank's contiguous block: shard r takes
    shard r+1's first token by one ppermute, and the last shard masks
    its final position (the sequence's last)."""
    from rlo_tpu_torch import topology
    ws = sp_axis.size
    nxt = sp_axis.ppermute(tokens[:, :1].contiguous(),
                           topology.ring_perm(ws, -1))
    targets = torch.cat([tokens[:, 1:], nxt], dim=1)
    valid = torch.ones(tokens.shape, dtype=torch.float32,
                       device=tokens.device)
    if sp_axis.index == ws - 1:
        valid[:, -1] = 0.0
    return targets, valid


def loss_fn(params: dict, tokens, cfg: TransformerConfig, sp_axis=None,
            tp_axis=None, ep_axis=None):
    """Mean next-token cross-entropy over the valid positions, plus
    ``cfg.moe_aux_coef`` times the summed aux term for MoE configs.
    ``cfg.loss_vocab_chunk`` streams the head. Under ``sp_axis`` (a
    contiguous split only, as in the JAX package) the masked NLL and the
    count are summed over the axis and the aux term averaged over it, so
    every rank holds the loss of the whole sequence; under ``ep_axis``
    each rank's loss is its own rows'."""
    if sp_axis is not None and cfg.sp_layout != "contiguous":
        raise ValueError(f"the sequence-parallel loss takes a contiguous "
                         f"split, as the JAX package's does; got "
                         f"sp_layout={cfg.sp_layout!r}")
    x, aux = _features(params, tokens, cfg, sp_axis, tp_axis,
                       ep_axis=ep_axis)
    if sp_axis is None:
        targets, valid = next_token_targets(tokens)
    else:
        targets, valid = _sp_targets(tokens, sp_axis)
    chunk = cfg.loss_vocab_chunk or 0
    with annotate("rlo.train.head"):
        if chunk:
            local, count = nll_sum_chunked(x, params["embed"], targets,
                                           valid, chunk)
        else:
            logits = (x @ params["embed"].t().to(cfg.act_dtype)).float()
            local, count = nll_sum(logits, targets, valid)
    if sp_axis is not None:
        local = psum_invariant(local, sp_axis)
        count = sp_axis.all_reduce(count, "sum")
    loss = local / count
    if cfg.n_experts > 0:
        if sp_axis is not None:
            aux = psum_invariant(aux, sp_axis) / sp_axis.size
        loss = loss + cfg.moe_aux_coef * aux
    return loss


def _model_parallel_combine(grads, loss, params, cfg, sp_axis, ep_axis,
                            dp_axis, dcn_axis):
    """The gradient sums JAX's vma typing inserts, after the backward:
    each leaf's gradient summed over sp, over ep unless its spec splits
    it there (the experts), and over dp and dcn; then divided by the dp
    x dcn size and, under ep, by the ep size (ep carries rows, a second
    data axis). tp-replicated leaves need no sum over tp: every tp rank
    computed the same gradient. The loss is averaged over dp, dcn and
    ep."""
    from rlo_tpu_torch.parallel.sharding import leaf_specs
    specs = leaf_specs(params, param_pspecs(
        cfg, ep_axis="ep" if ep_axis is not None else None))
    out = []
    for g, spec in zip(grads, specs):
        for axis in (sp_axis, None if "ep" in spec else ep_axis, dp_axis,
                     dcn_axis):
            if axis is not None:
                g = axis.all_reduce(g, "sum")
        out.append(g)
    for axis in (dp_axis, dcn_axis, ep_axis):
        if axis is not None:
            out = [g / axis.size for g in out]
            loss = axis.all_reduce(loss, "sum") / axis.size
    return loss, out


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
    loss is averaged over the same axes.

    With ``sp_axis``, ``tp_axis`` or ``ep_axis`` (``params`` this rank's
    slices per ``param_pspecs``) the sums are those of the JAX package's
    vma path (``_model_parallel_combine``): dp and dcn are plain sums
    whatever ``grad_algorithm`` says, and ``dcn_algorithm`` other than
    'psum' raises, as there."""
    if dcn_axis is not None and dp_axis is None:
        raise ValueError("dcn_axis requires dp_axis (it is the second, "
                         "cross-slice tier of data parallelism)")
    model_parallel = any(a is not None for a in (sp_axis, tp_axis, ep_axis))
    if model_parallel and dcn_axis is not None and dcn_algorithm != "psum":
        raise ValueError(
            f"dcn_algorithm={dcn_algorithm!r} needs the explicit combine of "
            f"pure data parallelism; with an sp, tp or ep axis the dp and "
            f"dcn sums are plain sums (the JAX package's vma path), which "
            f"cannot be compressed")
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with annotate("rlo.train.forward"):
        loss = loss_fn(_rebuild(params, iter(live)), tokens, cfg, sp_axis,
                       tp_axis, ep_axis)
    with annotate("rlo.train.backward"):
        grads = list(torch.autograd.grad(loss, live))
    loss = loss.detach()
    if model_parallel:
        loss, grads = _model_parallel_combine(grads, loss, params, cfg,
                                              sp_axis, ep_axis, dp_axis,
                                              dcn_axis)
    elif dp_axis is not None:
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
    it was (this rank's slices under tp/ep)."""
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
    with annotate("rlo.train.step"):
        loss, grads = grads_and_loss(params, tokens, cfg, sp_axis=sp_axis,
                                     dp_axis=dp_axis, tp_axis=tp_axis,
                                     ep_axis=ep_axis,
                                     grad_algorithm=grad_algorithm,
                                     dcn_axis=dcn_axis,
                                     dcn_algorithm=dcn_algorithm)
        with annotate("rlo.train.optimizer"):
            leaves = tree_leaves(params)
            for p, g in zip(leaves, tree_leaves(grads)):
                p.grad = g
            optimizer.step()
            for p in leaves:
                p.grad = None
    return params, loss


def opt_state_pspecs(optimizer_or_state, params: dict, param_specs) -> dict:
    """The ``PartitionSpec`` trees of a ``torch.optim`` optimizer's state
    over ``params`` (the optimizer, or its ``state`` mapping from each
    parameter tensor to its state dict): one tree shaped like ``params``
    per state name. A state tensor shaped like its parameter (Adam's
    ``exp_avg``, ``exp_avg_sq``) takes the parameter's spec from
    ``param_specs``, so tp/ep-split weights get split moments; anything
    else (``step``) is ``PartitionSpec()``. The counterpart of the JAX
    package's ``opt_state_pspecs`` over an optax state (its ``mu``,
    ``nu`` and ``count``); give a tree to ``parallel.sharding.shard_tree``
    with the rank's axes."""
    from rlo_tpu_torch.parallel.sharding import PartitionSpec, leaf_specs
    state = getattr(optimizer_or_state, "state", optimizer_or_state)
    leaves = tree_leaves(params)
    specs = leaf_specs(params, param_specs)
    names: list = []
    for p in leaves:
        for name in state.get(p, {}):
            if name not in names:
                names.append(name)
    out = {}
    for name in names:
        per = []
        for p, spec in zip(leaves, specs):
            t = state.get(p, {}).get(name)
            like = torch.is_tensor(t) and tuple(t.shape) == tuple(p.shape)
            per.append(spec if like else PartitionSpec())
        out[name] = _rebuild(params, iter(per))
    return out
