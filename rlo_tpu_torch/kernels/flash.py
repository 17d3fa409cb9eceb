"""K2-K5: the flash-attention block update, its backward, and whole attention.

The port of ``rlo_tpu/pallas/flash.py``: the forward kernel ``_kernel``
(K2), the backward kernels ``_rowstats_kernel`` (K3), ``_bwd_dq_kernel``
(K4) and ``_bwd_dkv_kernel`` (K5), their glue ``_pallas_bwd`` and the
custom VJP ``_vjp_block_update``, reached through
``flash_block_update_hld``, ``flash_block_update`` and
``flash_attention``. Each kernel wrapper launches its CUDA kernel in
``csrc/flash.cu`` for CUDA tensors and takes its plain PyTorch version
only for CPU tensors.

The kernel is a block *update*: it takes the carried online-softmax
state (m, l, o) and returns it updated with one K/V block, so a ring of
blocks (or one whole sequence, ``flash_attention``) is a chain of calls.
Layouts are head-leading as in the JAX package: q (H, Lq, D); k, v
(Hkv, Lk, D) with Hkv dividing H (query head h attends K/V head
h // (H/Hkv)); m, l (H, 1, Lq) f32; o (H, Lq, D) f32; q_pos (1, Lq),
k_pos (1, Lk) int32 global positions, masking ``k_pos <= q_pos`` when
causal. q, k, v may be f32 or bf16; everything is computed in f32.
``flash_block_update_hld`` folds a GQA group into the query axis on the
host, as the JAX package does, so the kernels see one head count.

Gradients: ``FlashBlockUpdate`` (a ``torch.autograd.Function``) runs K2
forward and, in backward, ``bwd='pallas'`` (K3 tie counts, then K4 and
K5: the exact max-cotangent routing), ``'pallas_fast'`` (K4 and K5 with
the routing dropped, exact when the consumer normalises by l' and
discards m', as ``flash_attention`` does) or ``'xla'`` (autograd through
the plain version, the oracle). Positions get no gradient.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

#: the masked score (finite, so exp/max stay NaN-free)
NEG = -1e30

_DT_CODE = {torch.float32: 1, torch.bfloat16: 2}
_HEAD_DIMS = (16, 32, 64, 128)

#: the backward implementations (``bwd=``), as in the JAX package
BWD_MODES = ("pallas", "pallas_fast", "xla")

_count_lock = threading.Lock()
_fn = None
_bwd_fns: dict = {}


def _check(q, k, v, m, l, o, q_pos, k_pos) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q must be (H, Lq, D) and k, v (Hkv, Lk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    h, lq, d = q.shape
    hk, lk = k.shape[0], k.shape[1]
    if k.shape[2] != d:
        raise ValueError(f"head_dim mismatch: q {d}, k {k.shape[2]}")
    if hk == 0 or h % hk:
        raise ValueError(f"query heads {h} must be a multiple of K/V "
                         f"heads {hk}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    want = {"m": ((h, 1, lq), m), "l": ((h, 1, lq), l),
            "o": ((h, lq, d), o)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if tuple(q_pos.shape) != (1, lq) or tuple(k_pos.shape) != (1, lk):
        raise ValueError(f"q_pos must be (1, {lq}) and k_pos (1, {lk}); "
                         f"got {tuple(q_pos.shape)}, "
                         f"{tuple(k_pos.shape)}")
    devs = {t.device for t in (q, k, v, m, l, o, q_pos, k_pos)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def _scores_plain(q, k, q_pos, k_pos, causal: bool, scale: float):
    """The masked score block s~ (H, Lq, Lk) f32 and its mask (None when
    not causal): the JAX package's ``_scores`` over the whole block."""
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    if not causal:
        return s, None
    mask = (k_pos[0][None, :] <= q_pos[0][:, None])[None]
    return torch.where(mask, s, NEG), mask


def flash_block_update_hld_plain(q, k, v, m, l, o, q_pos, k_pos, *,
                                 causal: bool = False,
                                 scale: float = 1.0):
    """Plain PyTorch version of K2: a restatement of the JAX package's
    ``_ref_block_update_hld`` (one pass over the whole K block). The CPU
    path, the version the kernel is held against on the card, and (under
    autograd) the ``bwd='xla'`` oracle."""
    _check(q, k, v, m, l, o, q_pos, k_pos)
    g = q.shape[0] // k.shape[0]
    if g > 1:
        k = k.repeat_interleave(g, dim=0)
        v = v.repeat_interleave(g, dim=0)
    s, mask = _scores_plain(q, k, q_pos, k_pos, causal, scale)
    m_in = m[:, 0, :]
    m_new = torch.maximum(m_in, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.exp(m_in - m_new)
    l_new = l[:, 0, :] * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("hqk,hkd->hqd", p, v.float())
    return m_new[:, None, :], l_new[:, None, :], o_new


def _kernel():
    global _fn
    if _fn is None:
        from rlo_tpu_torch.kernels import build
        f = build.load("flash").rlo_flash_fwd
        f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                      + [ctypes.c_int] * 5 + [ctypes.c_float,
                                              ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _staged(name: str, q) -> bool:
    """Whether the kernels copy operand ``name`` in 16-byte chunks: on
    the bf16 (tensor-core) route, q, k, v and do'."""
    return q.dtype == torch.bfloat16 and name in ("q", "k", "v", "do2")


def _cuda_checks(name: str, tensors: dict, d: int) -> None:
    """What every kernel of this module takes on the card: q, k, v in
    f32 or bf16, head_dim 16/32/64/128, contiguous operands, int32
    positions; on the bf16 route q, k, v and do' start on 16 bytes (the
    tensor-core kernels copy 16-byte chunks)."""
    q = tensors["q"]
    if q.dtype not in _DT_CODE:
        raise TypeError(f"{name} takes float32 and bfloat16, not {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {_HEAD_DIMS}, not {d}")
    for tname, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors ({tname} is "
                             f"not)")
        if _staged(tname, q) and t.data_ptr() % 16:
            raise ValueError(f"{name} needs its 16-byte-staged operands "
                             f"aligned to 16 bytes ({tname} is not)")
    if tensors["q_pos"].dtype != torch.int32 or \
            tensors["k_pos"].dtype != torch.int32:
        raise TypeError("q_pos and k_pos must be int32")


def _launch_operands(name: str, tensors: dict, d: int) -> dict:
    """The operands as the kernel takes them: each one that is not
    contiguous, or is staged in 16-byte chunks and does not start on 16
    bytes, replaced by a fresh contiguous copy (the reference takes any
    array). ``.contiguous()`` alone would return a contiguous but
    misaligned view unchanged. ``_cuda_checks`` then guards the result."""
    q = tensors["q"]
    out = {}
    for tname, t in tensors.items():
        if not t.is_contiguous() or (_staged(tname, q) and t.data_ptr() % 16):
            t = t.clone(memory_format=torch.contiguous_format)
        out[tname] = t
    _cuda_checks(name, out, d)
    return out


def _on_device(name: str, t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return True


def _forward(q, k, v, m, l, o, q_pos, k_pos, causal: bool, scale: float):
    """K2 on CUDA tensors (folded: one head count), its plain version on
    CPU tensors."""
    if not _on_device("flash_block_update_hld", q):
        return flash_block_update_hld_plain(q, k, v, m, l, o, q_pos, k_pos,
                                            causal=causal, scale=scale)
    h, lq, d = q.shape
    lk = k.shape[1]
    if k.shape[0] != h:
        raise ValueError(f"K2 takes q and k, v of one head count (GQA "
                         f"folded); got {h} and {k.shape[0]}")
    ops = _launch_operands("K2", dict(q=q, k=k, v=v, m=m, l=l, o=o,
                                      q_pos=q_pos, k_pos=k_pos), d)
    # like the contiguous operands: the kernel writes dense rows
    m2, l2, o2 = (torch.empty_like(ops[n]) for n in "mlo")
    if lq == 0 or h == 0:
        return m2, l2, o2
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(_DT_CODE[q.dtype],
                       *[t.data_ptr() for t in ops.values()],
                       m2.data_ptr(), l2.data_ptr(), o2.data_ptr(),
                       h, lq, lk, d, int(bool(causal)), float(scale),
                       stream)
    if rc != 0:
        raise RuntimeError(f"K2 flash kernel launch failed: CUDA error "
                           f"{rc} (H={h}, Lq={lq}, Lk={lk}, D={d}, "
                           f"{q.dtype})")
    with _count_lock:
        flash_block_update_hld.launches += 1
    return m2, l2, o2


# ---------------------------------------------------------------------------
# K3-K5: the backward kernels and their plain versions. Operands are the
# folded ones: q (H, Lq, D), k and v (H, Lk, D) of the same head count.
# ---------------------------------------------------------------------------

def _check_bwd(q, k, v, q_pos, k_pos, **rows) -> None:
    """Shapes of the backward operands: ``rows`` are m2, dl2, route
    (H, 1, Lq) and do2 (H, Lq, D), all float32."""
    if q.dim() != 3 or k.dim() != 3 or k.shape[0] != q.shape[0] or \
            k.shape[2] != q.shape[2] or (v is not None and
                                         v.shape != k.shape):
        raise ValueError(f"the backward kernels take q (H, Lq, D) and k, v "
                         f"(H, Lk, D) of one head count (GQA folded); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}"
                         + ("" if v is None else f", {tuple(v.shape)}"))
    if k.dtype != q.dtype or (v is not None and v.dtype != q.dtype):
        raise TypeError(f"q, k and v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}" + ("" if v is None else f", {v.dtype}"))
    operands = [q, k, q_pos, k_pos, *rows.values()] + \
        ([] if v is None else [v])
    if len({t.device for t in operands}) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{ {t.device for t in operands} }")
    h, lq, d = q.shape
    for name, t in rows.items():
        shape = (h, lq, d) if name == "do2" else (h, 1, lq)
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if tuple(q_pos.shape) != (1, lq) or tuple(k_pos.shape) != (1,
                                                              k.shape[1]):
        raise ValueError("q_pos must be (1, Lq) and k_pos (1, Lk)")


def _ds_plain(s, mask, v, m2, dl2, do2, route):
    """The score cotangent ds~ and u = exp(s~ - m') over the whole block:
    the JAX package's ``_ds_tile``."""
    mrow = m2[:, 0, :, None]
    u = torch.exp(s - mrow)
    dp = dl2[:, 0, :, None] + torch.einsum("hqd,hkd->hqk", do2, v.float())
    tie = s == mrow
    if mask is not None:
        dp = torch.where(mask, dp, 0.0)
        tie = tie & mask
    routed = torch.where(tie, route[:, 0, :, None], 0.0)
    return u * dp + routed, u


def rowstats_plain(q, k, m2, q_pos, k_pos, *, causal: bool = False,
                   scale: float = 1.0):
    """Plain version of K3: per row, the count of positions whose masked
    score equals m' (masked positions tie too when m' is -1e30), f32
    (H, 1, Lq)."""
    _check_bwd(q, k, None, q_pos, k_pos, m2=m2)
    s, _ = _scores_plain(q, k, q_pos, k_pos, causal, scale)
    return (s == m2[:, 0, :, None]).sum(dim=-1, dtype=torch.float32)[
        :, None, :]


def bwd_dq_plain(q, k, v, m2, dl2, do2, route, q_pos, k_pos, *,
                 causal: bool = False, scale: float = 1.0):
    """Plain version of K4: dq = scale * ds~ @ k, f32 (H, Lq, D)."""
    _check_bwd(q, k, v, q_pos, k_pos, m2=m2, dl2=dl2, do2=do2,
               route=route)
    s, mask = _scores_plain(q, k, q_pos, k_pos, causal, scale)
    ds, _ = _ds_plain(s, mask, v, m2, dl2, do2, route)
    return scale * torch.einsum("hqk,hkd->hqd", ds, k.float())


def bwd_dkv_plain(q, k, v, m2, dl2, do2, route, q_pos, k_pos, *,
                  causal: bool = False, scale: float = 1.0):
    """Plain version of K5: (dk, dv) = (scale * ds~^T @ q, p^T @ do'),
    f32 (H, Lk, D) each."""
    _check_bwd(q, k, v, q_pos, k_pos, m2=m2, dl2=dl2, do2=do2,
               route=route)
    s, mask = _scores_plain(q, k, q_pos, k_pos, causal, scale)
    ds, u = _ds_plain(s, mask, v, m2, dl2, do2, route)
    p = u if mask is None else torch.where(mask, u, 0.0)
    dk = scale * torch.einsum("hqk,hqd->hkd", ds, q.float())
    return dk, torch.einsum("hqk,hqd->hkd", p, do2)


_BWD_ARGTYPES = {
    "rlo_flash_rowstats": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    "rlo_flash_bwd_dq": [ctypes.c_int] + [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    "rlo_flash_bwd_dkv": [ctypes.c_int] + [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
}


def _bwd_kernel(symbol: str):
    f = _bwd_fns.get(symbol)
    if f is None:
        from rlo_tpu_torch.kernels import build
        f = getattr(build.load("flash"), symbol)
        f.argtypes = _BWD_ARGTYPES[symbol]
        f.restype = ctypes.c_int
        _bwd_fns[symbol] = f
    return f


def _launch_bwd(wrapper, symbol: str, label: str, ops: dict, outs,
                causal: bool, scale: float) -> None:
    """Launch one backward kernel on q's stream and count it; raises on
    a refused launch. Empty shapes launch nothing (the caller's outputs
    are zeros then)."""
    q, k = ops["q"], ops["k"]
    h, lq, d = q.shape
    lk = k.shape[1]
    if h == 0 or lq == 0 or lk == 0:
        return
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_kernel(symbol)(
            _DT_CODE[q.dtype], *[t.data_ptr() for t in ops.values()],
            *[t.data_ptr() for t in outs], h, lq, lk, d, int(bool(causal)),
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"{label} launch failed: CUDA error {rc} (H={h}, "
                           f"Lq={lq}, Lk={lk}, D={d}, {q.dtype})")
    with _count_lock:
        wrapper.launches += 1


def _grad_out(shape, ops: dict):
    """An f32 output of K3-K5: uninitialised when the kernel launches
    (it writes every element), zeros for the empty shapes that launch
    nothing."""
    h, lq, _ = ops["q"].shape
    dev = ops["q"].device
    if h == 0 or lq == 0 or ops["k"].shape[1] == 0:
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return torch.empty(shape, dtype=torch.float32, device=dev)


def rowstats(q, k, m2, q_pos, k_pos, *, causal: bool = False,
             scale: float = 1.0):
    """K3: the per-row tie counts of ``rowstats_plain``, f32 (H, 1, Lq).
    CPU tensors take the plain version; CUDA tensors launch K3 or
    raise."""
    if not _on_device("rowstats", q):
        return rowstats_plain(q, k, m2, q_pos, k_pos, causal=causal,
                              scale=scale)
    _check_bwd(q, k, None, q_pos, k_pos, m2=m2)
    ops = _launch_operands("K3", dict(q=q, k=k, m2=m2, q_pos=q_pos,
                                      k_pos=k_pos), q.shape[2])
    cnt = _grad_out(ops["m2"].shape, ops)
    _launch_bwd(rowstats, "rlo_flash_rowstats", "K3 rowstats", ops, (cnt,),
                causal, scale)
    return cnt


def bwd_dq(q, k, v, m2, dl2, do2, route, q_pos, k_pos, *,
           causal: bool = False, scale: float = 1.0):
    """K4: dq of ``bwd_dq_plain``, f32 (H, Lq, D). CPU tensors take the
    plain version; CUDA tensors launch K4 or raise."""
    if not _on_device("bwd_dq", q):
        return bwd_dq_plain(q, k, v, m2, dl2, do2, route, q_pos, k_pos,
                            causal=causal, scale=scale)
    _check_bwd(q, k, v, q_pos, k_pos, m2=m2, dl2=dl2, do2=do2,
               route=route)
    ops = _launch_operands("K4", dict(q=q, k=k, v=v, m2=m2, dl2=dl2,
                                      do2=do2, route=route, q_pos=q_pos,
                                      k_pos=k_pos), q.shape[2])
    dq = _grad_out(q.shape, ops)
    _launch_bwd(bwd_dq, "rlo_flash_bwd_dq", "K4 bwd_dq", ops, (dq,), causal,
                scale)
    return dq


def bwd_dkv(q, k, v, m2, dl2, do2, route, q_pos, k_pos, *,
            causal: bool = False, scale: float = 1.0):
    """K5: (dk, dv) of ``bwd_dkv_plain``, f32 (H, Lk, D) each. CPU
    tensors take the plain version; CUDA tensors launch K5 or raise."""
    if not _on_device("bwd_dkv", q):
        return bwd_dkv_plain(q, k, v, m2, dl2, do2, route, q_pos, k_pos,
                             causal=causal, scale=scale)
    _check_bwd(q, k, v, q_pos, k_pos, m2=m2, dl2=dl2, do2=do2,
               route=route)
    ops = _launch_operands("K5", dict(q=q, k=k, v=v, m2=m2, dl2=dl2,
                                      do2=do2, route=route, q_pos=q_pos,
                                      k_pos=k_pos), q.shape[2])
    dk, dv = _grad_out(k.shape, ops), _grad_out(k.shape, ops)
    _launch_bwd(bwd_dkv, "rlo_flash_bwd_dkv", "K5 bwd_dkv", ops, (dk, dv),
                causal, scale)
    return dk, dv


#: kernel launches so far (CPU tensors never count)
rowstats.launches = 0
bwd_dq.launches = 0
bwd_dkv.launches = 0


def flash_backward(q, k, v, m, l, o, q_pos, k_pos, m2, l2, o2, dm2, dl2,
                   do2, *, causal: bool, scale: float, exact_max: bool):
    """The hand-written VJP of one (folded) block update: the JAX
    package's ``_pallas_bwd``. The per-row pieces are plain torch ops on
    the (H, 1, Lq) rows:
      corr = exp(m - m'); dl = dl' * corr; do = do' * corr
      dcorr = dl' * l + sum_d do' * o       (the cotangent of corr)
      dmacc = dm' - dl' * l' - sum_d do' * o'
    dmacc, the m' cotangent after all its uses, routes through
    m' = max(m, rowmax(s~)) with autodiff's tie semantics (maximum splits
    0.5/0.5 at equality, the row max divides its share among the tied
    positions): ``exact_max`` counts the ties with K3 and hands each tied
    position its share (``route``) inside K4/K5; without it the share is
    dropped and dmacc goes wholly to dm where m won (exact when the
    consumer normalises by l' and discards m'). The quadratic pieces are
    K4 (dq) and K5 (dk, dv), or their plain versions on CPU tensors.
    Returns (dq, dk, dv, dm, dl, do) with dq, dk, dv in q's, k's and v's
    dtypes."""
    corr = torch.exp(m - m2)
    dl_in = dl2 * corr
    do_in = do2 * corr.transpose(1, 2)
    dcorr = dl2 * l + (do2 * o).sum(-1)[:, None, :]
    dmacc = dm2 - dl2 * l2 - (do2 * o2).sum(-1)[:, None, :]
    m_won = m == m2
    if exact_max:
        cnt = rowstats(q, k, m2, q_pos, k_pos, causal=causal, scale=scale)
        max_hit = cnt > 0
        w_m = torch.where(m_won, torch.where(max_hit, 0.5, 1.0), 0.0)
        w_s = torch.where(max_hit, torch.where(m_won, 0.5, 1.0), 0.0)
        dm_in = dcorr * corr + w_m * dmacc
        route = w_s * dmacc / torch.clamp_min(cnt, 1.0)
    else:
        dm_in = dcorr * corr + torch.where(m_won, dmacc, 0.0)
        route = torch.zeros_like(dmacc)
    # cotangents may arrive as expanded or strided views
    dl2c, do2c = dl2.contiguous(), do2.contiguous()
    dq = bwd_dq(q, k, v, m2, dl2c, do2c, route, q_pos, k_pos, causal=causal,
                scale=scale)
    dk, dv = bwd_dkv(q, k, v, m2, dl2c, do2c, route, q_pos, k_pos,
                     causal=causal, scale=scale)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dm_in, dl_in,
            do_in)


class FlashBlockUpdate(torch.autograd.Function):
    """The differentiable block update on folded operands (one head
    count): the counterpart of the JAX package's ``_vjp_block_update``.
    Forward is K2 (saving q, k, v, m, l, o, the positions and m', l',
    o'); backward is ``flash_backward`` (``bwd`` 'pallas' or
    'pallas_fast') or autograd through ``flash_block_update_hld_plain``
    ('xla'). Positions get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, m, l, o, q_pos, k_pos, causal: bool,
                scale: float, bwd: str):
        m2, l2, o2 = _forward(q, k, v, m, l, o, q_pos, k_pos, causal, scale)
        ctx.save_for_backward(q, k, v, m, l, o, q_pos, k_pos, m2, l2, o2)
        ctx.causal, ctx.scale, ctx.bwd = causal, scale, bwd
        return m2, l2, o2

    @staticmethod
    def backward(ctx, dm2, dl2, do2):
        q, k, v, m, l, o, qp, kp, m2, l2, o2 = ctx.saved_tensors
        if ctx.bwd == "xla":
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True)
                       for t in (q, k, v, m, l, o)]
                outs = flash_block_update_hld_plain(
                    *ins, qp, kp, causal=ctx.causal, scale=ctx.scale)
                grads = torch.autograd.grad(outs, ins, (dm2, dl2, do2))
        else:
            grads = flash_backward(q, k, v, m, l, o, qp, kp, m2, l2, o2,
                                   dm2, dl2, do2, causal=ctx.causal,
                                   scale=ctx.scale,
                                   exact_max=ctx.bwd == "pallas")
        return (*grads, None, None, None, None, None)


def flash_block_update_hld(q, k, v, m, l, o, q_pos, k_pos, *,
                           causal: bool = False, scale: float = 1.0,
                           bwd: str = "pallas"):
    """One fused online-softmax update of (m, l, o) with the K/V block;
    returns new (m', l', o') tensors in the input layouts. CPU tensors
    take the plain versions; CUDA tensors launch K2 (and K3-K5 in
    backward) or raise.

    A GQA group (Hkv < H) folds into the query axis first, as in the JAX
    package: q, m, l, o are viewed as (Hkv, G*Lq, ...) with q_pos tiled
    G times, so the kernels never see a group and dk/dv sum a K/V head's
    G query heads inside one block. Differentiable when an operand
    requires grad (``FlashBlockUpdate``); ``bwd`` picks the backward:
    'pallas' (exact tie routing, the default), 'pallas_fast' or 'xla'."""
    _check(q, k, v, m, l, o, q_pos, k_pos)
    if bwd not in BWD_MODES:
        raise ValueError(f"unknown bwd implementation {bwd!r}; known: "
                         f"{BWD_MODES}")
    h, lq, d = q.shape
    hk = k.shape[0]
    if hk != h:
        g = h // hk
        m2, l2, o2 = flash_block_update_hld(
            q.reshape(hk, g * lq, d), k, v, m.reshape(hk, 1, g * lq),
            l.reshape(hk, 1, g * lq), o.reshape(hk, g * lq, d),
            q_pos.repeat(1, g), k_pos, causal=causal, scale=scale, bwd=bwd)
        return (m2.reshape(h, 1, lq), l2.reshape(h, 1, lq),
                o2.reshape(h, lq, d))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, m, l, o)):
        return FlashBlockUpdate.apply(q, k, v, m, l, o, q_pos, k_pos,
                                      bool(causal), float(scale), bwd)
    return _forward(q, k, v, m, l, o, q_pos, k_pos, causal, scale)


#: kernel launches so far (CPU tensors never count)
flash_block_update_hld.launches = 0


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Whole attention as one block update from the initial state
    (m = -1e30, l = 0, o = 0), then o / l where l > 0. q (Lq, H, D);
    k, v (Lk, Hkv, D); positions are 0..L-1. Returns q's shape and
    dtype. Its backward is 'pallas_fast': the division by l makes the
    dropped max-routing term exactly zero analytically."""
    lq, h, d = q.shape
    lk = k.shape[0]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dev = q.device
    m0 = torch.full((h, 1, lq), NEG, dtype=torch.float32, device=dev)
    l0 = torch.zeros((h, 1, lq), dtype=torch.float32, device=dev)
    o0 = torch.zeros((h, lq, d), dtype=torch.float32, device=dev)
    qp = torch.arange(lq, dtype=torch.int32, device=dev).reshape(1, lq)
    kp = torch.arange(lk, dtype=torch.int32, device=dev).reshape(1, lk)
    _, l, o = flash_block_update_hld(
        q.transpose(0, 1).contiguous(), k.transpose(0, 1).contiguous(),
        v.transpose(0, 1).contiguous(), m0, l0, o0, qp, kp,
        causal=causal, scale=scale, bwd="pallas_fast")
    lt = l.transpose(1, 2)
    denom = torch.where(lt > 0, lt, torch.ones_like(lt))
    return (o / denom).transpose(0, 1).to(q.dtype)


def flash_block_update(q, k, v, m, l, o, q_pos, k_pos, *,
                       causal: bool = False, scale: float = 1.0,
                       bwd: str = "pallas"):
    """One block update in ring attention's caller layout: q, o
    (Lq, H, D); k, v (Lk, Hkv, D); m, l (H, Lq); q_pos (Lq,), k_pos
    (Lk,). Returns (m', l', o') in those layouts."""
    lq, h, d = q.shape
    lk = k.shape[0]
    m2, l2, o2 = flash_block_update_hld(
        q.transpose(0, 1).contiguous(), k.transpose(0, 1).contiguous(),
        v.transpose(0, 1).contiguous(), m.reshape(h, 1, lq),
        l.reshape(h, 1, lq), o.float().transpose(0, 1).contiguous(),
        q_pos.to(torch.int32).reshape(1, lq),
        k_pos.to(torch.int32).reshape(1, lk), causal=causal, scale=scale,
        bwd=bwd)
    return m2.reshape(h, lq), l2.reshape(h, lq), o2.transpose(0, 1)
