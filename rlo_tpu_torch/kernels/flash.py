"""K2, the flash-attention block update (forward), and whole attention.

The port of ``rlo_tpu/pallas/flash.py`` forward (Pallas kernel
``_kernel``, reached through ``flash_block_update_hld`` and
``flash_attention``). ``flash_block_update_hld`` launches the CUDA
kernel in ``csrc/flash.cu`` for CUDA tensors and takes
``flash_block_update_hld_plain`` only for CPU tensors.

The kernel is a block *update*: it takes the carried online-softmax
state (m, l, o) and returns it updated with one K/V block, so a ring of
blocks (or one whole sequence, ``flash_attention``) is a chain of calls.
Layouts are head-leading as in the JAX package: q (H, Lq, D); k, v
(Hkv, Lk, D) with Hkv dividing H (query head h attends K/V head
h // (H/Hkv), the GQA fold of the JAX package); m, l (H, 1, Lq) f32;
o (H, Lq, D) f32; q_pos (1, Lq), k_pos (1, Lk) int32 global positions,
masking ``k_pos <= q_pos`` when causal. q, k, v may be f32 or bf16;
everything is computed in f32.

Forward only: the backward kernels (K3-K5) belong to the training slice,
and a tensor that requires grad raises.
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

_count_lock = threading.Lock()
_fn = None


def _check(q, k, v, m, l, o, q_pos, k_pos) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("m", m), ("l", l),
                    ("o", o)):
        if t.requires_grad:
            raise NotImplementedError(
                f"flash_block_update_hld is forward only ({name} "
                f"requires grad): its backward (K3-K5) comes with the "
                f"training slice of the port")
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


def flash_block_update_hld_plain(q, k, v, m, l, o, q_pos, k_pos, *,
                                 causal: bool = False,
                                 scale: float = 1.0):
    """Plain PyTorch version of K2: a restatement of the JAX package's
    ``_ref_block_update_hld`` (one pass over the whole K block). The CPU
    path, and the version the kernel is held against on the card."""
    _check(q, k, v, m, l, o, q_pos, k_pos)
    g = q.shape[0] // k.shape[0]
    kf, vf = k.float(), v.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=0)
        vf = vf.repeat_interleave(g, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), kf) * scale
    mask = None
    if causal:
        mask = (k_pos[0][None, :] <= q_pos[0][:, None])[None]
        s = torch.where(mask, s, torch.full_like(s, NEG))
    m_in = m[:, 0, :]
    m_new = torch.maximum(m_in, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.exp(m_in - m_new)
    l_new = l[:, 0, :] * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("hqk,hkd->hqd", p, vf)
    return m_new[:, None, :], l_new[:, None, :], o_new


def _kernel():
    global _fn
    if _fn is None:
        from rlo_tpu_torch.kernels import build
        f = build.load("flash").rlo_flash_fwd
        f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                      + [ctypes.c_int] * 6 + [ctypes.c_float,
                                              ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def flash_block_update_hld(q, k, v, m, l, o, q_pos, k_pos, *,
                           causal: bool = False, scale: float = 1.0):
    """One fused online-softmax update of (m, l, o) with the K/V block;
    returns new (m', l', o') tensors in the input layouts. CPU tensors
    take the plain version; CUDA tensors launch K2 or raise."""
    _check(q, k, v, m, l, o, q_pos, k_pos)
    if q.device.type == "cpu":
        return flash_block_update_hld_plain(q, k, v, m, l, o, q_pos,
                                            k_pos, causal=causal,
                                            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_block_update_hld runs on cpu or cuda, "
                         f"not {q.device}")
    if q.dtype not in _DT_CODE:
        raise TypeError(f"K2 takes float32 and bfloat16, not {q.dtype}")
    h, lq, d = q.shape
    hk, lk = k.shape[0], k.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"K2 takes head_dim in {_HEAD_DIMS}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v), ("m", m), ("l", l),
                    ("o", o), ("q_pos", q_pos), ("k_pos", k_pos)):
        if not t.is_contiguous():
            raise ValueError(f"K2 needs contiguous tensors ({name} is "
                             f"not)")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("q_pos and k_pos must be int32")
    m2, l2, o2 = torch.empty_like(m), torch.empty_like(l), \
        torch.empty_like(o)
    if lq == 0 or h == 0:
        return m2, l2, o2
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(_DT_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), m.data_ptr(), l.data_ptr(),
                       o.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                       m2.data_ptr(), l2.data_ptr(), o2.data_ptr(),
                       h, hk, lq, lk, d, int(bool(causal)),
                       float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"K2 flash kernel launch failed: CUDA error "
                           f"{rc} (H={h}, Hkv={hk}, Lq={lq}, Lk={lk}, "
                           f"D={d}, {q.dtype})")
    with _count_lock:
        flash_block_update_hld.launches += 1
    return m2, l2, o2


#: kernel launches so far (CPU tensors never count)
flash_block_update_hld.launches = 0


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Whole attention as one block update from the initial state
    (m = -1e30, l = 0, o = 0), then o / l where l > 0. q (Lq, H, D);
    k, v (Lk, Hkv, D); positions are 0..L-1. Returns q's shape and
    dtype."""
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
        causal=causal, scale=scale)
    lt = l.transpose(1, 2)
    denom = torch.where(lt > 0, lt, torch.ones_like(lt))
    return (o / denom).transpose(0, 1).to(q.dtype)
