"""The model as plain PyTorch in float32: forward, loss and AdamW.

Equations (the port's, with the departures the configuration files
list): x = E[tokens]; per layer h = rmsnorm(x) * g1 (eps 1e-6);
q = h Wq, (k, v) = h Wkv; RoPE on q and k, dimension pairs (i, i + 64),
base 10000; causal softmax(q k^T / sqrt(hd)) v with query head j
reading K/V head j // (H / Hkv); x += att Wo; h = rmsnorm(x) * g2;
x += gelu_tanh(h W1) W2; logits = rmsnorm(x) * gf E^T. Loss: the mean
next-token NLL over every position but each row's last.

Every product goes through ``mm``: ``f32_mm`` (TF32 off) for the
reference, ``fp8_mm`` for the control, which rounds both operands to
float8 e4m3 (a per-tensor scale, amax / 448) and multiplies in f32.
Weights may come in any dtype; each layer's are cast to f32 where used.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6
ROPE_BASE = 10000.0
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
        False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def f32_mm(a, b):
    return a @ b


def _fp8(t):
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())   # the rounded values, gradient passed on


def fp8_mm(a, b):
    return _fp8(a) @ _fp8(b)


def rmsnorm(x, g):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * g


def rope(t, pos):
    """t (n, L, heads, hd) rotated by positions ``pos`` (L,)."""
    hd = t.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(ROPE_BASE)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    t1, t2 = t[..., :half], t[..., half:]
    return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], -1)


def _attend_row(q, k, v, mm):
    """One sequence: q (L, H, hd), k/v (L, Hkv, hd); causal, GQA."""
    L, H, hd = q.shape
    g = H // k.shape[1]
    qh = q.permute(1, 0, 2)                                 # (H, L, hd)
    kh = k.permute(1, 0, 2).repeat_interleave(g, 0)
    vh = v.permute(1, 0, 2).repeat_interleave(g, 0)
    s = mm(qh, kh.transpose(1, 2)) / math.sqrt(hd)
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return mm(p, vh).permute(1, 0, 2)                       # (L, H, hd)


def layer(x, W, m, pos, mm, grad_blocks: bool):
    """One layer on x (n, L, d) f32; W the layer's leaves (any dtype)."""
    n, L, d = x.shape
    H = m["n_heads"]
    hd = d // H
    kvh = m.get("n_kv_heads") or H
    h = rmsnorm(x, W["ln1"]["g"].float())
    q = mm(h, W["wq"].float()).reshape(n, L, H, hd)
    kv = mm(h, W["wkv"].float().reshape(d, -1))
    k, v = kv.split(kvh * hd, dim=-1)
    k = rope(k.reshape(n, L, kvh, hd), pos)
    v = v.reshape(n, L, kvh, hd)
    q = rope(q, pos)
    rows = []
    for i in range(n):
        if grad_blocks:
            rows.append(checkpoint(_attend_row, q[i], k[i], v[i], mm,
                                   use_reentrant=False))
        else:
            rows.append(_attend_row(q[i], k[i], v[i], mm))
    att = torch.stack(rows).reshape(n, L, H * hd)
    x = x + mm(att, W["wo"].float())
    h = rmsnorm(x, W["ln2"]["g"].float())
    return x + mm(F.gelu(mm(h, W["w1"].float()), approximate="tanh"),
                  W["w2"].float())


def features(W, tokens, m, mm, grad_blocks: bool = False):
    """(n, L, d) f32 activations after the final norm."""
    L = tokens.shape[1]
    pos = torch.arange(L, device=tokens.device)
    x = W["embed"][tokens.long()].float()
    for Wl in W["layers"]:
        if grad_blocks:
            x = checkpoint(layer, x, Wl, m, pos, mm, True,
                           use_reentrant=False)
        else:
            x = layer(x, Wl, m, pos, mm, False)
    return rmsnorm(x, W["ln_f"]["g"].float())


@torch.no_grad()
def logits(W, tokens, m, mm=f32_mm, from_pos: int = 0, rows: int = 1024):
    """(n, L - from_pos, vocab) f32 logits of ``tokens`` (n, L) at
    positions from ``from_pos`` on, the head in blocks of ``rows``."""
    x = features(W, tokens, m, mm)[:, from_pos:]
    E = W["embed"].float()
    return torch.cat([mm(x[:, i:i + rows], E.t())
                      for i in range(0, x.shape[1], rows)], 1)


def _nll_block(x, E, tgt, mm):
    lg = mm(x, E.t())
    return (torch.logsumexp(lg, -1)
            - lg.gather(-1, tgt[..., None])[..., 0]).sum()


def loss_backward(W, tokens, m, mm=f32_mm, rows_per_block: int = 1,
                  head_rows: int = 2048):
    """Mean next-token NLL (every position but each row's last), its
    gradient accumulated into the leaves' ``.grad``, ``rows_per_block``
    sequences at a time with each layer and head block checkpointed, so
    it fits beside the f32 weights and AdamW state. Returns the loss."""
    n, L = tokens.shape
    count = n * (L - 1)
    E = W["embed"].float()
    total = 0.0
    for r0 in range(0, n, rows_per_block):
        tok = tokens[r0:r0 + rows_per_block]
        x = features(W, tok, m, mm, grad_blocks=True)
        xs = x[:, :-1].reshape(-1, x.shape[-1])
        tg = tok[:, 1:].reshape(-1).long()
        part = x.new_zeros(())
        for i in range(0, xs.shape[0], head_rows):
            part = part + checkpoint(_nll_block, xs[i:i + head_rows], E,
                                     tg[i:i + head_rows], mm,
                                     use_reentrant=False)
        (part / count).backward()
        total += float(part.detach())
        del x, xs, part
    return total / count


class AdamW:
    """torch.optim.AdamW's update written out: p *= 1 - lr * wd; then
    p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)."""

    def __init__(self, params, lr, betas, eps, weight_decay):
        self.params = params
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd = eps, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = v.sqrt().div_(math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)
            p.grad = None
