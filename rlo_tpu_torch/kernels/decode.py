"""K6 (flash decode attention) and the in-place cache writes K7 and K8.

The port of ``rlo_tpu/pallas/decode.py``'s dense kernels:

  - ``flash_block_decode`` / ``flash_decode`` (Pallas ``_decode_kernel``):
    T queries per batch row against the seq-minor KV cache, query t of
    row b at position ``pos0_b + t`` attending cache positions <= it;
    bf16 or f32 caches, or int8 caches with f32 scale sidecars;
  - ``write_kv_row`` (Pallas ``_write_row_kernel``): one (kv_heads,
    head_dim) column per batch row at ``pos_b``;
  - ``write_kv_block`` (Pallas ``_write_block_kernel``): T <= 128
    consecutive columns from ``pos0_b``.

Each launches its CUDA kernel in ``csrc/decode.cu`` for CUDA tensors and
takes its ``*_plain`` twin only for CPU tensors. Layouts are the JAX
package's: cache (b, kv_heads, head_dim, max_len), scales (b, kv_heads,
max_len), q (b, T, n_heads, head_dim), out f32 like q. ``pos`` is a
Python int, a 0-d int32 tensor (every row at the same position) or a
(b,) int32 tensor; the kernels read it on the device.

Where JAX returns a new cache, the port's writes update the cache
**in place** (and return it). A position outside [0, max_len) matches
no column and that write is dropped, as the TPU kernels drop it: the
serving loop keeps advancing retired slots past max_len.

K6's numerics follow the TPU kernel: dots in bf16 with f32 accumulation
(f32 for f32 caches), the probabilities rounded to the dot dtype before
P.V, for int8 the k scale multiplying the scores and the v scale the
probabilities after l is accumulated, V zeroed under the mask, out =
o / l. The cache axis is cut into ``BLOCK_K``-wide tiles for every T, so
T = 1 and T > 1 share one partition (and one accumulation order).
"""

from __future__ import annotations

import ctypes
import threading

import torch

NEG = -1e30
#: K6's cache-axis tile, the same for every T (the plain twin mirrors it)
BLOCK_K = 128
#: K8's widest block, as on the TPU
MAX_BLOCK_T = 128

_CACHE_CODE = {torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}
_HEAD_DIMS = (16, 32, 64, 128)

_count_lock = threading.Lock()
_fns = {}


def _lib_fn(name, argtypes):
    f = _fns.get(name)
    if f is None:
        from rlo_tpu_torch.kernels import build
        f = getattr(build.load("decode"), name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """``pos`` as an int32 tensor on ``device``: 0-d (shared) or (b,)."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32)
    if pos.dim() not in (0, 1) or (pos.dim() == 1 and pos.numel() != b):
        raise ValueError(f"pos must be a scalar or ({b},); got "
                         f"{tuple(pos.shape)}")
    return pos.to(device=device, dtype=torch.int32)


def _positions(pos: torch.Tensor, b: int) -> torch.Tensor:
    return pos.expand(b) if pos.dim() == 0 else pos


def _on(kind: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{kind} runs on cpu or cuda, not {t.device}")
    return False


# ---------------------------------------------------------------------------
# K6: flash decode attention
# ---------------------------------------------------------------------------

def _check_decode(q, k_cache, v_cache, k_scale, v_scale):
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"q must be (b, T, nh, hd) and the caches (b, kvh, "
                         f"hd, L); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, T, nh, d = q.shape
    kb, nkv, kd, L = k_cache.shape
    if kb != b or kd != d or nkv == 0 or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k_cache.shape)}")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError("k and v caches must share a dtype")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if quant != (k_cache.dtype == torch.int8):
        raise ValueError("int8 caches need scales, and only they take "
                         "them")
    if quant:
        for t in (k_scale, v_scale):
            if tuple(t.shape) != (b, nkv, L) or t.dtype != torch.float32:
                raise ValueError(f"scales must be float32 ({b}, {nkv}, "
                                 f"{L}); got {t.dtype} {tuple(t.shape)}")
    if q.requires_grad:
        raise NotImplementedError("K6 is inference only")


def _dot_dtype(cache_dtype):
    return torch.float32 if cache_dtype == torch.float32 else torch.bfloat16


def _group_queries(q, nkv):
    """(b, T, nh, d) -> (b, nkv, T*r, d), rows t-major (row t*r + rr is
    token t, group member rr)."""
    b, T, nh, d = q.shape
    r = nh // nkv
    return (q.reshape(b, T, nkv, r, d).permute(0, 2, 1, 3, 4)
            .reshape(b, nkv, T * r, d))


def _ungroup(out, T, nh):
    b, nkv, R, d = out.shape
    return (out.reshape(b, nkv, T, nh // nkv, d).permute(0, 2, 1, 3, 4)
            .reshape(b, T, nh, d))


def flash_block_decode_plain(q, k_cache, v_cache, pos0, scale,
                             k_scale=None, v_scale=None, *,
                             block_k: int = BLOCK_K):
    """Plain PyTorch version of K6: the TPU kernel's tile loop over the
    cache axis (``block_k`` wide) with its online softmax and its
    roundings. The CPU path, and the version the kernel is held against
    on the card."""
    _check_decode(q, k_cache, v_cache, k_scale, v_scale)
    b, T, nh, d = q.shape
    nkv, L = k_cache.shape[1], k_cache.shape[3]
    r = nh // nkv
    R = T * r
    quant = k_scale is not None
    dot = _dot_dtype(k_cache.dtype)
    dev = q.device
    qg = _group_queries(q, nkv).to(dot).float()
    posv = _positions(_pos_vector(pos0, b, dev), b).long()
    qoff = torch.arange(R, device=dev) // r
    qlim = (posv[:, None] + qoff[None, :])[:, None, :, None]  # (b,1,R,1)
    clim = (posv + (T - 1))[:, None, None, None]              # (b,1,1,1)
    m = torch.full((b, nkv, R), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nkv, R), dtype=torch.float32, device=dev)
    o = torch.zeros((b, nkv, R, d), dtype=torch.float32, device=dev)
    for k0 in range(0, L, block_k):
        k1 = min(L, k0 + block_k)
        row = torch.arange(k0, k1, device=dev)[None, None, None, :]
        mask_row = row <= qlim                                 # (b,1,R,bk)
        mask_col = row <= clim                                 # (b,1,1,bk)
        kt = k_cache[..., k0:k1].float()
        vt = torch.where(mask_col, v_cache[..., k0:k1].float(),
                         torch.zeros((), device=dev))
        s = torch.matmul(qg, kt) * scale
        if quant:
            s = s * k_scale[:, :, None, k0:k1]
        s = torch.where(mask_row, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask_row, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=dev))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = (torch.where(mask_row, p * v_scale[:, :, None, k0:k1],
                          torch.zeros((), device=dev)) if quant else p)
        pv = pv.to(dot).float()
        o = o * corr[..., None] + torch.matmul(pv, vt.transpose(-1, -2))
        m = m_new
    return _ungroup(o / l[..., None], T, nh)


def flash_block_decode(q, k_cache, v_cache, pos0, scale, k_scale=None,
                       v_scale=None):
    """Fused T-query decode attention (T = 1 is single-token decode):
    ``q`` (b, T, n_heads, head_dim), row b's query t at ``pos0_b + t``.
    Returns (b, T, n_heads, head_dim) f32. CPU tensors take the plain
    version; CUDA tensors launch K6 or raise."""
    _check_decode(q, k_cache, v_cache, k_scale, v_scale)
    if _on("flash_block_decode", q):
        return flash_block_decode_plain(q, k_cache, v_cache, pos0, scale,
                                        k_scale, v_scale)
    b, T, nh, d = q.shape
    nkv, L = k_cache.shape[1], k_cache.shape[3]
    if d not in _HEAD_DIMS:
        raise ValueError(f"K6 takes head_dim in {_HEAD_DIMS}, not {d}")
    if k_cache.dtype not in _CACHE_CODE:
        raise TypeError(f"K6 takes f32, bf16 and int8 caches, not "
                        f"{k_cache.dtype}")
    quant = k_scale is not None
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and (not t.is_contiguous()
                              or t.device != q.device):
            raise ValueError(f"K6 needs {name} contiguous on {q.device}")
    dev = q.device
    qg = _group_queries(q, nkv).to(_dot_dtype(k_cache.dtype)).float() \
        .contiguous()
    pos = _pos_vector(pos0, b, dev)
    R = qg.shape[2]
    out = torch.empty((b, nkv, R, d), dtype=torch.float32, device=dev)
    if b * nkv * R == 0:
        return _ungroup(out, T, nh)
    fn = _lib_fn("rlo_flash_decode",
                 [ctypes.c_int] + [ctypes.c_void_p] * 7
                 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(_CACHE_CODE[k_cache.dtype], qg.data_ptr(),
                k_cache.data_ptr(), v_cache.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None, pos.data_ptr(),
                out.data_ptr(), b, nkv, R, nh // nkv, T, d, L,
                1 if pos.dim() else 0, float(scale), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"K6 decode kernel launch failed: CUDA error "
                           f"{rc} (b={b}, kvh={nkv}, R={R}, hd={d}, L={L}, "
                           f"{k_cache.dtype})")
    _count(flash_block_decode)
    return _ungroup(out, T, nh)


flash_block_decode.launches = 0


def flash_decode(q, k_cache, v_cache, pos, scale, k_scale=None,
                 v_scale=None):
    """Single-query decode attention: ``q`` (b, 1, n_heads, head_dim);
    the T = 1 case of ``flash_block_decode`` (one kernel, one
    partition). Returns (b, 1, n_heads, head_dim) f32."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode takes one query per row; got "
                         f"{tuple(q.shape)} (flash_block_decode for T>1)")
    return flash_block_decode(q, k_cache, v_cache, pos, scale, k_scale,
                              v_scale)


# ---------------------------------------------------------------------------
# K7 / K8: in-place cache writes
# ---------------------------------------------------------------------------

def _check_write(cache, rows, want_rows, kind):
    if cache.dim() != 4 or tuple(rows.shape) != want_rows:
        raise ValueError(f"{kind}: cache must be (b, kvh, hd, L) and rows "
                         f"{want_rows}; got {tuple(cache.shape)}, "
                         f"{tuple(rows.shape)}")
    if rows.device != cache.device:
        raise ValueError(f"{kind}: rows and cache on different devices")


def write_kv_row_plain(cache, row, pos):
    """Plain version of K7: ``cache[b, :, :, pos_b] = row[b]`` in place,
    dropping rows whose position lies outside [0, L)."""
    b, L = cache.shape[0], cache.shape[3]
    _check_write(cache, row, tuple(cache.shape[:3]), "write_kv_row")
    posv = _positions(_pos_vector(pos, b, cache.device), b).long()
    ok = (posv >= 0) & (posv < L)
    idx = torch.nonzero(ok).flatten()
    if idx.numel():
        cache[idx, :, :, posv[idx]] = row[idx].to(cache.dtype)
    return cache


def write_kv_row(cache, row, pos):
    """K7: write ``row`` (b, kvh, hd) into column ``pos_b`` of ``cache``
    (b, kvh, hd, L) in place and return the cache. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    b, nkv, d, L = cache.shape
    _check_write(cache, row, (b, nkv, d), "write_kv_row")
    if _on("write_kv_row", cache):
        return write_kv_row_plain(cache, row, pos)
    if not cache.is_contiguous():
        raise ValueError("K7 needs a contiguous cache")
    row = row.to(cache.dtype).contiguous()
    pos = _pos_vector(pos, b, cache.device)
    if cache.numel() == 0:
        return cache
    fn = _lib_fn("rlo_write_kv_row",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
    with torch.cuda.device(cache.device):
        rc = fn(cache.data_ptr(), row.data_ptr(), pos.data_ptr(), b,
                nkv * d, L, cache.element_size(), 1 if pos.dim() else 0,
                _stream(cache.device))
    if rc != 0:
        raise RuntimeError(f"K7 row-write launch failed: CUDA error {rc}")
    _count(write_kv_row)
    return cache


write_kv_row.launches = 0


def write_kv_block_plain(cache, rows, pos0):
    """Plain version of K8: ``cache[b, :, :, pos0_b + t] = rows[b, ...,
    t]`` in place, dropping columns outside [0, L)."""
    b, nkv, d, L = cache.shape
    T = rows.shape[3] if rows.dim() == 4 else -1
    _check_write(cache, rows, (b, nkv, d, T), "write_kv_block")
    posv = _positions(_pos_vector(pos0, b, cache.device), b).long()
    cols = posv[:, None] + torch.arange(T, device=cache.device)[None, :]
    bi, ti = torch.nonzero((cols >= 0) & (cols < L), as_tuple=True)
    if bi.numel():
        cache[bi, :, :, cols[bi, ti]] = rows[bi, :, :, ti].to(cache.dtype)
    return cache


def write_kv_block(cache, rows, pos0):
    """K8: write ``rows`` (b, kvh, hd, T), T <= 128, into columns
    ``pos0_b .. pos0_b + T - 1`` of ``cache`` in place and return the
    cache. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    b, nkv, d, L = cache.shape
    if rows.dim() != 4:
        raise ValueError(f"rows must be (b, kvh, hd, T); got "
                         f"{tuple(rows.shape)}")
    T = rows.shape[3]
    _check_write(cache, rows, (b, nkv, d, T), "write_kv_block")
    if T > MAX_BLOCK_T:
        raise ValueError(f"write_kv_block supports T <= {MAX_BLOCK_T}, "
                         f"got {T}")
    if _on("write_kv_block", cache):
        return write_kv_block_plain(cache, rows, pos0)
    if not cache.is_contiguous():
        raise ValueError("K8 needs a contiguous cache")
    rows = rows.to(cache.dtype).contiguous()
    pos = _pos_vector(pos0, b, cache.device)
    if rows.numel() == 0:
        return cache
    fn = _lib_fn("rlo_write_kv_block",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
    with torch.cuda.device(cache.device):
        rc = fn(cache.data_ptr(), rows.data_ptr(), pos.data_ptr(), b,
                nkv * d, T, L, cache.element_size(), 1 if pos.dim() else 0,
                _stream(cache.device))
    if rc != 0:
        raise RuntimeError(f"K8 block-write launch failed: CUDA error "
                           f"{rc}")
    _count(write_kv_block)
    return cache


write_kv_block.launches = 0
