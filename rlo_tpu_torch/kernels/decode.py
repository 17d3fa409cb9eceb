"""Decode attention and the in-place cache writes, dense (K6, K7, K8)
and paged (K9, K10, K11).

The port of ``rlo_tpu/pallas/decode.py``'s kernels:

  - ``flash_block_decode`` / ``flash_decode`` (Pallas ``_decode_kernel``):
    T queries per batch row against the seq-minor KV cache, query t of
    row b at position ``pos0_b + t`` attending cache positions <= it;
    bf16 or f32 caches, or int8 caches with f32 scale sidecars;
  - ``write_kv_row`` (Pallas ``_write_row_kernel``): one (kv_heads,
    head_dim) column per batch row at ``pos_b``;
  - ``write_kv_block`` (Pallas ``_write_block_kernel``): T <= 128
    consecutive columns from ``pos0_b``, up to two (cache, rows) pairs in
    one launch;
  - ``paged_flash_decode`` (Pallas ``_paged_decode_kernel``): K6 through
    a page table over pools (P, kv_heads, head_dim, page_size);
  - ``write_kv_page_row`` (Pallas ``_write_page_row_kernel``): one row per
    batch row into lane ``off_b`` of page ``page_b``, up to two (pool, row)
    pairs in one launch;
  - ``write_kv_page_block`` (Pallas ``_write_page_block_kernel``): one
    prefill chunk of T <= page_size tokens into one page, up to two (pool,
    rows) pairs in one launch.

K8, K10 and K11 read their rows in place through the rows' strides (the
callers pass the projection's (.., T, kv_heads, head_dim) output as a
view; only a dtype other than the cache's is converted first), and a k/v
pair (or the int8 scale pair) costs one launch.

Each launches its CUDA kernel in ``csrc/decode.cu`` for CUDA tensors and
takes its ``*_plain`` twin only for CPU tensors. Layouts are the JAX
package's: cache (b, kv_heads, head_dim, max_len), scales (b, kv_heads,
max_len), q (b, T, n_heads, head_dim), out f32 like q. ``pos`` is a
Python int, a 0-d int32 tensor (every row at the same position) or a
(b,) int32 tensor; the kernels read it on the device.

Where JAX returns a new cache or pool, the port's writes update it
**in place** (and return it). A position outside [0, max_len) matches
no column and that write is dropped, as the TPU kernels drop it: the
serving loop keeps advancing retired slots past max_len. The page
writes drop a lane offset outside [0, page_size) (the serving loop's
``off = page_size`` sentinel for inactive slots) and clamp a page index
into [0, P - 1], as the TPU wrappers clamp it.

K6's numerics follow the TPU kernel: dots in bf16 with f32 accumulation
(f32 for f32 caches), the probabilities rounded to the dot dtype before
P.V, for int8 the k scale multiplying the scores and the v scale the
probabilities after l is accumulated, V zeroed under the mask, out =
o / l. The cache axis is cut into ``BLOCK_K``-wide tiles for every T, so
T = 1 and T > 1 share one partition (and one accumulation order). K9
cuts the LOGICAL cache axis the same way whatever the page size, so
pages that hold a dense cache's columns give K6's result bit for bit.
"""

from __future__ import annotations

import ctypes
import operator
import struct
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


def _stream(dev) -> int:
    """The raw handle of the current stream of CUDA device ``dev`` (a
    device or its index): what Triton's launcher reads, and cheaper than
    ``torch.cuda.current_stream(dev).cuda_stream``, which builds a Stream
    object on every call."""
    return torch._C._cuda_getCurrentRawStream(
        dev if isinstance(dev, int) else dev.index)


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """``pos`` as an int32 tensor on ``device``: 0-d (shared) or (b,); one
    that already is passes through as it is."""
    if (isinstance(pos, torch.Tensor) and pos.dtype == torch.int32
            and pos.get_device() == device.index
            and (pos.dim() == 0 or tuple(pos.shape) == (b,))):
        return pos
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32)
    if pos.dim() not in (0, 1) or (pos.dim() == 1 and pos.numel() != b):
        raise ValueError(f"pos must be a scalar or ({b},); got "
                         f"{tuple(pos.shape)}")
    return pos.to(device=device, dtype=torch.int32)


def _positions(pos: torch.Tensor, b: int) -> torch.Tensor:
    return pos.expand(b) if pos.dim() == 0 else pos


def _on(kind: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    one (the kernel launches); raises for any other device."""
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{kind} runs on cpu or cuda, not {t.device}")
    return True


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


def _prepare_launch(kind, q, pos0, nkv, cache_dtype, tensors):
    """What K6 and K9 launch on: checks the head dim, the cache type and
    that every tensor of ``tensors`` ((name, tensor or None) pairs) is
    contiguous on q's device; returns (q grouped (b, nkv, T*r, hd) f32 in
    the dot dtype's values, the positions, the (b, nkv, T*r, hd) f32
    output)."""
    b, T, nh, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"{kind} takes head_dim in {_HEAD_DIMS}, not {d}")
    if cache_dtype not in _CACHE_CODE:
        raise TypeError(f"{kind} takes f32, bf16 and int8 caches, not "
                        f"{cache_dtype}")
    for name, t in tensors:
        if t is not None and (not t.is_contiguous()
                              or t.device != q.device):
            raise ValueError(f"{kind} needs {name} contiguous on "
                             f"{q.device}")
    qg = _group_queries(q, nkv).to(_dot_dtype(cache_dtype)).float() \
        .contiguous()
    out = torch.empty(qg.shape, dtype=torch.float32, device=q.device)
    return qg, _pos_vector(pos0, b, q.device), out


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
    quant = k_scale is not None
    dev = q.device
    qg, pos, out = _prepare_launch(
        "K6", q, pos0, nkv, k_cache.dtype,
        (("k_cache", k_cache), ("v_cache", v_cache), ("k_scale", k_scale),
         ("v_scale", v_scale)))
    R = qg.shape[2]
    if out.numel() == 0:
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

def _check_write(cache, rows, want_rows, kind,
                 layout="cache (b, kvh, hd, L)"):
    if cache.dim() != 4 or tuple(rows.shape) != want_rows:
        raise ValueError(f"{kind}: {layout} and rows {want_rows} expected; "
                         f"got {tuple(cache.shape)}, {tuple(rows.shape)}")
    if rows.get_device() != cache.get_device():
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


# ---------------------------------------------------------------------------
# K8 / K11: the block writes' one launch, read in place, up to two pairs
# ---------------------------------------------------------------------------

def _pairs(dst, src, dst2, src2):
    return ((dst, src),) if dst2 is None else ((dst, src), (dst2, src2))


def _span(t):
    """The [first, last) bytes ``t``'s elements lie in (t not empty)."""
    st = t.stride()
    last = sum(map(operator.mul, t.shape, st)) - sum(st)
    p0 = t.data_ptr()
    return p0, p0 + (last + 1) * t.element_size()


def _check_pair(kind, dst, src, dst2, src2) -> None:
    """The second (destination, rows) pair: both or neither, with the
    first pair's shapes, dtype and device."""
    if dst2 is None and src2 is None:
        return
    if dst2 is None or src2 is None:
        raise ValueError(f"{kind}: pass both tensors of the second pair, "
                         f"or neither")
    dev = dst.get_device()
    if (dst2.shape != dst.shape or src2.shape != src.shape
            or dst2.dtype != dst.dtype or dst2.get_device() != dev
            or src2.get_device() != dev):
        raise ValueError(f"{kind}: the second pair must match the first's "
                         f"shapes, dtype and device; got "
                         f"{tuple(dst2.shape)} {dst2.dtype}, "
                         f"{tuple(src2.shape)}")


def _alias_error(kind) -> ValueError:
    return ValueError(f"{kind}: the two pairs alias (a destination overlaps "
                      f"the other pair's destination or rows)")


def _check_alias(kind, dst, src, dst2, src2) -> None:
    """No write of one pair lands on the other pair's destination or rows
    (the plain versions' check; the kernel's entry makes the same one)."""
    if dst2 is None or dst.numel() == 0 or src.numel() == 0:
        return
    (a0, a1), (b0, b1) = _span(dst), _span(dst2)
    for (x0, x1), (y0, y1) in (((a0, a1), (b0, b1)),
                               ((a0, a1), _span(src2)),
                               ((b0, b1), _span(src))):
        if x0 < y1 and y0 < x1:
            raise _alias_error(kind)


#: the parameter block of ``rlo_write_kv_block_cols`` (csrc/decode.cu):
#: dst0, src0, dst1, src1; the two sources' (batch, head, d, token)
#: strides; row, col0, n_valid; col0_stride, nb, H, D, T, Lc, nrow,
#: element size
_BLOCK_PARAMS = struct.Struct("<4Q8q3Q8i")
_BLOCK_ARGTYPES = [ctypes.c_char_p, ctypes.c_void_p]


def _row_strides(rows):
    """(batch, head, d, token) element strides of K8's (b, kvh, hd, T) or
    K11's (kvh, hd, T) rows."""
    st = rows.stride()
    return st if len(st) == 4 else (0,) + st


def _launch_block(kind, counted, dst, src, dst2, src2, row, col0,
                  col0_stride, n_valid, nb) -> None:
    """One K8/K11 launch over one or two (dst, rows) pairs; the rows are
    read in place through their strides."""
    if src.numel() == 0:
        return
    if not dst.is_contiguous() or not (dst2 is None
                                       or dst2.is_contiguous()):
        raise ValueError(f"{kind} needs contiguous destinations")
    if src.dtype != dst.dtype:
        src = src.to(dst.dtype)
    p1, s1 = (0, 0), (0, 0, 0, 0)
    if dst2 is not None:
        if src2.dtype != dst.dtype:
            src2 = src2.to(dst.dtype)
        p1, s1 = (dst2.data_ptr(), src2.data_ptr()), _row_strides(src2)
    nrow, H, D, Lc = dst.shape
    T = src.shape[-1]
    params = _BLOCK_PARAMS.pack(
        dst.data_ptr(), src.data_ptr(), *p1, *_row_strides(src), *s1,
        0 if row is None else row.data_ptr(), col0.data_ptr(),
        0 if n_valid is None else n_valid.data_ptr(), col0_stride, nb, H,
        D, T, Lc, nrow, dst.element_size())
    fn = _lib_fn("rlo_write_kv_block_cols", _BLOCK_ARGTYPES)
    index = dst.get_device()
    if torch._C._cuda_getDevice() == index:
        rc = fn(params, _stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(params, _stream(index))
    if rc == -2:
        raise _alias_error(kind)
    if rc != 0:
        raise RuntimeError(f"{kind} block-write launch failed: CUDA error "
                           f"{rc} ({nb} x {H} x {D} x T {T}, {dst.dtype})")
    _count(counted)


def _check_block(cache, rows, cache2, rows2) -> int:
    """K8's shapes (and the pair's); returns T."""
    b, nkv, d, L = cache.shape
    if rows.dim() != 4:
        raise ValueError(f"rows must be (b, kvh, hd, T); got "
                         f"{tuple(rows.shape)}")
    T = rows.shape[3]
    _check_write(cache, rows, (b, nkv, d, T), "write_kv_block")
    if T > MAX_BLOCK_T:
        raise ValueError(f"write_kv_block supports T <= {MAX_BLOCK_T}, "
                         f"got {T}")
    _check_pair("write_kv_block", cache, rows, cache2, rows2)
    return T


def write_kv_block_plain(cache, rows, pos0, cache2=None, rows2=None):
    """Plain version of K8: ``cache[b, :, :, pos0_b + t] = rows[b, ...,
    t]`` in place, dropping columns outside [0, L); the same for
    (``cache2``, ``rows2``) when given."""
    T = _check_block(cache, rows, cache2, rows2)
    _check_alias("write_kv_block", cache, rows, cache2, rows2)
    b, L = cache.shape[0], cache.shape[3]
    posv = _positions(_pos_vector(pos0, b, cache.device), b).long()
    cols = posv[:, None] + torch.arange(T, device=cache.device)[None, :]
    bi, ti = torch.nonzero((cols >= 0) & (cols < L), as_tuple=True)
    if bi.numel():
        for c, r in _pairs(cache, rows, cache2, rows2):
            c[bi, :, :, cols[bi, ti]] = r[bi, :, :, ti].to(c.dtype)
    return cache


def write_kv_block(cache, rows, pos0, cache2=None, rows2=None):
    """K8: write ``rows`` (b, kvh, hd, T), T <= 128, any strides, into
    columns ``pos0_b .. pos0_b + T - 1`` of ``cache`` in place and return
    the cache; ``cache2``/``rows2`` (the same shapes and dtype, aliasing
    neither of the first pair) are written by the same launch. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    _check_block(cache, rows, cache2, rows2)
    if _on("write_kv_block", cache):
        return write_kv_block_plain(cache, rows, pos0, cache2, rows2)
    b = cache.shape[0]
    pos = _pos_vector(pos0, b, cache.device)
    _launch_block("K8", write_kv_block, cache, rows, cache2, rows2, None,
                  pos, 1 if pos.dim() else 0, None, b)
    return cache


write_kv_block.launches = 0


# ---------------------------------------------------------------------------
# K9: paged flash decode attention
# ---------------------------------------------------------------------------

def _check_paged(q, k_pool, v_pool, table, ks_pool, vs_pool):
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"q must be (b, T, nh, hd) and the pools (P, kvh, "
                         f"hd, ps); got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, T, nh, d = q.shape
    P, nkv, kd, ps = k_pool.shape
    if kd != d or nkv == 0 or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit the pools "
                         f"{tuple(k_pool.shape)}")
    if table.dim() != 2 or table.shape[0] != b or table.shape[1] == 0:
        raise ValueError(f"table must be ({b}, max_pages); got "
                         f"{tuple(table.shape)}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("k and v pools must share a dtype")
    quant = ks_pool is not None
    if quant != (vs_pool is not None):
        raise ValueError("pass both ks_pool and vs_pool, or neither")
    if quant != (k_pool.dtype == torch.int8):
        raise ValueError("int8 pools need scale pools, and only they take "
                         "them")
    if quant:
        for t in (ks_pool, vs_pool):
            if tuple(t.shape) != (P, nkv, ps) or t.dtype != torch.float32:
                raise ValueError(f"scale pools must be float32 ({P}, {nkv}, "
                                 f"{ps}); got {t.dtype} {tuple(t.shape)}")
    if q.requires_grad:
        raise NotImplementedError("K9 is inference only")


def gather_pages(pool, table):
    """The logical per-row cache a page table maps out of ``pool``:
    (P, kvh, hd, ps) -> (b, kvh, hd, mp * ps), or a scale pool (P, kvh,
    ps) -> (b, kvh, mp * ps); logical page i of row b is physical page
    ``table[b, i]``."""
    b, mp = table.shape
    got = pool[table.long()]                 # (b, mp, kvh, [hd,] ps)
    if pool.dim() == 4:
        return got.permute(0, 2, 3, 1, 4).reshape(
            b, pool.shape[1], pool.shape[2], mp * pool.shape[3])
    return got.permute(0, 2, 1, 3).reshape(b, pool.shape[1],
                                           mp * pool.shape[2])


def paged_flash_decode_plain(q, k_pool, v_pool, table, pos0, scale,
                             ks_pool=None, vs_pool=None, *,
                             block_k: int = BLOCK_K):
    """Plain PyTorch version of K9: the table (clamped into [0, P - 1])
    gathers each row's logical cache out of the pools, and K6's plain
    tile loop (``block_k`` wide) attends it. The CPU path, and the
    version the kernel is held against on the card."""
    _check_paged(q, k_pool, v_pool, table, ks_pool, vs_pool)
    tab = table.clamp(0, k_pool.shape[0] - 1)
    kg, vg = gather_pages(k_pool, tab), gather_pages(v_pool, tab)
    ksg = vsg = None
    if ks_pool is not None:
        ksg, vsg = gather_pages(ks_pool, tab), gather_pages(vs_pool, tab)
    return flash_block_decode_plain(q, kg, vg, pos0, scale, ksg, vsg,
                                    block_k=block_k)


def paged_flash_decode(q, k_pool, v_pool, table, pos0, scale, ks_pool=None,
                       vs_pool=None):
    """Fused paged decode attention (K9): ``q`` (b, T, n_heads,
    head_dim), row b's query t at position ``pos0_b + t`` attending the
    positions <= it of its logical cache, whose page i is physical page
    ``table[b, i]`` of the pools (P, kv_heads, head_dim, page_size)
    (int8 pools take f32 scale pools (P, kv_heads, page_size)). ``table``
    is (b, max_pages) int32; table entries are clamped into [0, P - 1].
    Returns (b, T, n_heads, head_dim) f32. CPU tensors take the plain
    version; CUDA tensors launch K9 or raise."""
    _check_paged(q, k_pool, v_pool, table, ks_pool, vs_pool)
    if _on("paged_flash_decode", q):
        return paged_flash_decode_plain(q, k_pool, v_pool, table, pos0,
                                        scale, ks_pool, vs_pool)
    b, T, nh, d = q.shape
    P, nkv, _, ps = k_pool.shape
    mp = table.shape[1]
    if table.dtype != torch.int32:
        raise TypeError(f"K9 takes an int32 table, not {table.dtype}")
    quant = ks_pool is not None
    dev = q.device
    qg, pos, out = _prepare_launch(
        "K9", q, pos0, nkv, k_pool.dtype,
        (("k_pool", k_pool), ("v_pool", v_pool), ("ks_pool", ks_pool),
         ("vs_pool", vs_pool), ("table", table)))
    R = qg.shape[2]
    if out.numel() == 0:
        return _ungroup(out, T, nh)
    fn = _lib_fn("rlo_paged_flash_decode",
                 [ctypes.c_int] + [ctypes.c_void_p] * 8
                 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(_CACHE_CODE[k_pool.dtype], qg.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(),
                ks_pool.data_ptr() if quant else None,
                vs_pool.data_ptr() if quant else None, table.data_ptr(),
                pos.data_ptr(), out.data_ptr(), b, nkv, R, nh // nkv, T, d,
                P, ps, mp, 1 if pos.dim() else 0, float(scale),
                _stream(dev))
    if rc != 0:
        raise RuntimeError(f"K9 paged decode kernel launch failed: CUDA "
                           f"error {rc} (b={b}, kvh={nkv}, R={R}, hd={d}, "
                           f"P={P}, ps={ps}, mp={mp}, {k_pool.dtype})")
    _count(paged_flash_decode)
    return _ungroup(out, T, nh)


paged_flash_decode.launches = 0


# ---------------------------------------------------------------------------
# K10 / K11: in-place page writes
# ---------------------------------------------------------------------------

_POOL = "pool (P, kvh, hd, ps)"


def _scalar_i32(x, device) -> torch.Tensor:
    """A Python int or a one-element int tensor as a (1,) int32 tensor on
    ``device`` (device tensors stay there: nothing is read back); a (1,)
    int32 tensor already there passes through as it is."""
    if (isinstance(x, torch.Tensor) and x.dtype == torch.int32
            and x.get_device() == device.index and x.shape == (1,)):
        return x
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.int32)
    if x.numel() != 1:
        raise ValueError(f"expected one value; got shape {tuple(x.shape)}")
    return x.reshape(1).to(device=device, dtype=torch.int32)


def _check_page_row(pool, row, pool2, row2) -> int:
    """K10's shapes (and the pair's); returns b."""
    P, nkv, d, ps = pool.shape
    b = row.shape[0] if row.dim() == 3 else -1
    _check_write(pool, row, (b, nkv, d), "write_kv_page_row", _POOL)
    _check_pair("write_kv_page_row", pool, row, pool2, row2)
    return b


def write_kv_page_row_plain(pool, row, page, off, pool2=None, row2=None):
    """Plain version of K10: ``pool[page_b, :, :, off_b] = row[b]`` in
    place, page clamped into [0, P - 1], rows whose off lies outside
    [0, ps) dropped; the same for (``pool2``, ``row2``) when given."""
    b = _check_page_row(pool, row, pool2, row2)
    _check_alias("write_kv_page_row", pool, row, pool2, row2)
    P, ps = pool.shape[0], pool.shape[3]
    pg = _pos_vector(page, b, pool.device).expand(b).long().clamp(0, P - 1)
    of = _pos_vector(off, b, pool.device).expand(b).long()
    idx = torch.nonzero((of >= 0) & (of < ps)).flatten()
    if idx.numel():
        for p, r in _pairs(pool, row, pool2, row2):
            p[pg[idx], :, :, of[idx]] = r[idx].to(p.dtype)
    return pool


#: the parameter block of ``rlo_write_kv_page_rows`` (csrc/decode.cu):
#: dst0, src0, dst1, src1; the two rows' (batch, head, d) strides; page,
#: off; page_stride, off_stride, nb, H, D, P, ps, element size
_PAGE_ROW_PARAMS = struct.Struct("<4Q6q2Q8i")


def write_kv_page_row(pool, row, page, off, pool2=None, row2=None):
    """K10: write ``row`` (b, kvh, hd), any strides, into lane ``off_b``
    of page ``page_b`` of ``pool`` (P, kvh, hd, ps) in place and return the
    pool; ``page``/``off`` are (b,) int32 (or one shared value), read on
    the device. ``pool2``/``row2`` (the same shapes and dtype, aliasing
    neither of the first pair) are written by the same launch. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    b = _check_page_row(pool, row, pool2, row2)
    if _on("write_kv_page_row", pool):
        return write_kv_page_row_plain(pool, row, page, off, pool2, row2)
    if not pool.is_contiguous() or not (pool2 is None
                                        or pool2.is_contiguous()):
        raise ValueError("K10 needs contiguous pools")
    if row.numel() == 0:
        return pool
    if row.dtype != pool.dtype:
        row = row.to(pool.dtype)
    p1, s1 = (0, 0), (0, 0, 0)
    if pool2 is not None:
        if row2.dtype != pool.dtype:
            row2 = row2.to(pool.dtype)
        p1, s1 = (pool2.data_ptr(), row2.data_ptr()), row2.stride()
    dev = pool.device
    page, off = _pos_vector(page, b, dev), _pos_vector(off, b, dev)
    P, nkv, d, ps = pool.shape
    params = _PAGE_ROW_PARAMS.pack(
        pool.data_ptr(), row.data_ptr(), *p1, *row.stride(), *s1,
        page.data_ptr(), off.data_ptr(), page.stride(0) if page.dim() else 0,
        off.stride(0) if off.dim() else 0, b, nkv, d, P, ps,
        pool.element_size())
    fn = _lib_fn("rlo_write_kv_page_rows", _BLOCK_ARGTYPES)
    index = dev.index
    if torch._C._cuda_getDevice() == index:
        rc = fn(params, _stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(params, _stream(index))
    if rc == -2:
        raise _alias_error("write_kv_page_row")
    if rc != 0:
        raise RuntimeError(f"K10 page-row write launch failed: CUDA error "
                           f"{rc} ({b} x {nkv} x {d}, {pool.dtype})")
    _count(write_kv_page_row)
    return pool


write_kv_page_row.launches = 0


def _check_page_block(pool, rows, pool2, rows2) -> int:
    """K11's shapes (and the pair's); returns T."""
    P, nkv, d, ps = pool.shape
    if rows.dim() != 3:
        raise ValueError(f"rows must be (kvh, hd, T); got "
                         f"{tuple(rows.shape)}")
    T = rows.shape[2]
    _check_write(pool, rows, (nkv, d, T), "write_kv_page_block", _POOL)
    if T > ps:
        raise ValueError(f"chunk T={T} exceeds page size {ps}")
    _check_pair("write_kv_page_block", pool, rows, pool2, rows2)
    return T


def write_kv_page_block_plain(pool, rows, page, off0, n_valid, pool2=None,
                              rows2=None):
    """Plain version of K11: ``pool[page, :, :, off0 + t] = rows[..., t]``
    in place for t < n_valid and 0 <= off0 + t < ps, page clamped into
    [0, P - 1]; the same for (``pool2``, ``rows2``) when given."""
    T = _check_page_block(pool, rows, pool2, rows2)
    _check_alias("write_kv_page_block", pool, rows, pool2, rows2)
    P, ps = pool.shape[0], pool.shape[3]
    dev = pool.device
    pg = _scalar_i32(page, dev).long().clamp(0, P - 1)
    t = torch.arange(T, device=dev)
    cols = _scalar_i32(off0, dev).long() + t
    keep = torch.nonzero((t < _scalar_i32(n_valid, dev).long())
                         & (cols >= 0) & (cols < ps)).flatten()
    if keep.numel():
        for p, r in _pairs(pool, rows, pool2, rows2):
            p[pg, :, :, cols[keep]] = r[:, :, keep].to(p.dtype) \
                .permute(2, 0, 1)
    return pool


def write_kv_page_block(pool, rows, page, off0, n_valid, pool2=None,
                        rows2=None):
    """K11: write the first ``n_valid`` tokens of the chunk ``rows``
    (kvh, hd, T), T <= ps, any strides, into lanes ``off0 ..`` of page
    ``page`` of ``pool`` (P, kvh, hd, ps) in place and return the pool;
    pads never touch it. ``pool2``/``rows2`` (the same shapes and dtype,
    aliasing neither of the first pair) are written by the same launch.
    ``page``, ``off0`` and ``n_valid`` are ints or one-element int32
    tensors, read on the device. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    _check_page_block(pool, rows, pool2, rows2)
    if _on("write_kv_page_block", pool):
        return write_kv_page_block_plain(pool, rows, page, off0, n_valid,
                                         pool2, rows2)
    dev = pool.device
    _launch_block("K11", write_kv_page_block, pool, rows, pool2, rows2,
                  _scalar_i32(page, dev), _scalar_i32(off0, dev), 0,
                  _scalar_i32(n_valid, dev), 1)
    return pool


write_kv_page_block.launches = 0
