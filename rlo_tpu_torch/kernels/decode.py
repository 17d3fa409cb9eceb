"""Decode attention and the in-place cache writes, dense (K6, K7, K8)
and paged (K9, K10, K11).

The port of ``rlo_tpu/pallas/decode.py``'s kernels:

  - ``flash_block_decode`` / ``flash_decode`` (Pallas ``_decode_kernel``):
    T queries per batch row against the seq-minor KV cache, query t of
    row b at position ``pos0_b + t`` attending cache positions <= it;
    bf16 or f32 caches, or int8 caches with f32 scale sidecars;
  - ``write_kv_row`` (Pallas ``_write_row_kernel``): one (kv_heads,
    head_dim) column per batch row at ``pos_b``, up to two (cache, row)
    pairs in one launch (K10's kernel, the page being the batch row);
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

The writes (K7, K8, K10, K11) read their rows in place through the
rows' strides (the callers pass the projection's (.., T, kv_heads,
head_dim) output as a view; only a dtype other than the cache's is
converted first), and a k/v pair (or the int8 scale pair) costs one
launch.

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
o / l. The cache axis is cut into ``BLOCK_K``-wide tiles, and the tiles
into splits of ``SPLIT_K`` positions fixed in absolute positions (split
s is [s * SPLIT_K, (s + 1) * SPLIT_K)), the same for every T, batch,
length and dtype: each split runs the online softmax over its tiles, and
the splits' (m, l, o) merge in split order (M = max m_s, l = sum l_s *
e^(m_s - M), o = sum o_s * e^(m_s - M), out = o / l). A split wholly
past a row's last position adds exactly 0, so T = 1 and T > 1 give a
row the same bits. K9 cuts the LOGICAL cache axis the same way whatever
the page size, so pages that hold a dense cache's columns give K6's
result bit for bit. q is read in place through its strides (the decode
step passes a view of the projection) and rounded to the dot dtype by
the kernel.
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
#: K6/K9's split of the cache axis across blocks, a multiple of BLOCK_K,
#: fixed in absolute positions and the same for every call (the plain
#: twins compute the same partition and merge)
SPLIT_K = 256
#: K8's widest block, as on the TPU
MAX_BLOCK_T = 128

_CACHE_CODE = {torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}
_Q_CODE = {torch.float32: 1, torch.bfloat16: 2}
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


def _check_split(split_k, block_k) -> None:
    if split_k is not None and (not isinstance(split_k, int) or split_k <= 0
                                or split_k % block_k):
        raise ValueError(f"split_k must be None or a positive multiple of "
                         f"the tile width {block_k}; got {split_k!r}")


def _sweep(qg, k_cache, v_cache, k_scale, v_scale, c0, c1, block_k, scale,
           qlim, clim):
    """The online softmax over the tiles of cache positions [c0, c1),
    ``block_k`` wide, from m = NEG, l = 0, o = 0: (m, l, o)."""
    b, nkv, R, d = qg.shape
    quant = k_scale is not None
    dot = _dot_dtype(k_cache.dtype)
    dev = qg.device
    m = torch.full((b, nkv, R), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nkv, R), dtype=torch.float32, device=dev)
    o = torch.zeros((b, nkv, R, d), dtype=torch.float32, device=dev)
    for k0 in range(c0, c1, block_k):
        k1 = min(c1, k0 + block_k)
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
    return m, l, o


def flash_block_decode_plain(q, k_cache, v_cache, pos0, scale,
                             k_scale=None, v_scale=None, *,
                             block_k: int = BLOCK_K, split_k=SPLIT_K):
    """Plain PyTorch version of K6: the TPU kernel's tile loop over the
    cache axis (``block_k`` wide) with its online softmax and its
    roundings, run over each split of ``split_k`` positions (a multiple
    of ``block_k``; None: one split over the whole cache, the TPU
    kernel's single sweep), the splits merged in split order as the
    kernel merges them. The CPU path, and the version the kernel is held
    against on the card."""
    _check_decode(q, k_cache, v_cache, k_scale, v_scale)
    _check_split(split_k, block_k)
    b, T, nh, d = q.shape
    nkv, L = k_cache.shape[1], k_cache.shape[3]
    r = nh // nkv
    R = T * r
    dev = q.device
    qg = _group_queries(q, nkv).to(_dot_dtype(k_cache.dtype)).float() \
        .contiguous()
    posv = _positions(_pos_vector(pos0, b, dev), b).long()
    qoff = torch.arange(R, device=dev) // r
    qlim = (posv[:, None] + qoff[None, :])[:, None, :, None]  # (b,1,R,1)
    clim = (posv + (T - 1))[:, None, None, None]              # (b,1,1,1)
    step = max(L, 1) if split_k is None else split_k
    parts = [_sweep(qg, k_cache, v_cache, k_scale, v_scale, c0,
                    min(L, c0 + step), block_k, scale, qlim, clim)
             for c0 in range(0, max(L, 1), step)]
    m, l, o = parts[0]
    if len(parts) > 1:
        big_m = torch.stack([p[0] for p in parts]).amax(dim=0)
        l, o = torch.zeros_like(l), torch.zeros_like(o)
        for m_s, l_s, o_s in parts:
            e = torch.exp(m_s - big_m)
            l = l + l_s * e
            o = o + o_s * e[..., None]
    return _ungroup(o / l[..., None], T, nh)


#: the parameter block of ``rlo_decode_attend`` (csrc/decode.cu): q, k,
#: v, ks, vs, pos, out, table, workspace, counters; q's (batch, token,
#: head, d) strides, the workspace's and counters' sizes; cache code, q
#: code, b, nkv, T, r, hd, L, pos_per_row, P, ps, mp, split_k, paged;
#: scale, pad
_ATTEND_PARAMS = struct.Struct("<10Q6q14ifi")

#: per (device index, stream): the f32 workspace of the splits' (m, l, o)
#: and the int32 arrival counters of K6/K9, grown as needed and never
#: cleared by a call (each launch leaves its counters at 0)
_scratch = {}


def _scratch_for(dev, stream: int, n_ws: int, n_cnt: int):
    key = (dev.index, stream)
    with _count_lock:
        ws, cnt = _scratch.get(key, (None, None))
        if ws is None or ws.numel() < n_ws:
            ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
        if cnt is None or cnt.numel() < n_cnt:
            cnt = torch.zeros(n_cnt, dtype=torch.int32, device=dev)
        _scratch[key] = (ws, cnt)
    return ws, cnt


def _launch_attend(kind, counted, q, k, v, ks, vs, pos0, scale, L,
                   table=None):
    """One K6 (``table`` None: caches (b, kvh, hd, L)) or K9 (pools (P,
    kvh, hd, ps) through ``table``) launch, split at ``SPLIT_K``; q is
    read in place. Checks the head dim, the cache type and that the
    caches (pools), scales and table are contiguous on q's device.
    Returns out (b, T, nh, hd) f32."""
    b, T, nh, d = q.shape
    nkv = k.shape[1]
    dev = q.device
    if d not in _HEAD_DIMS:
        raise ValueError(f"{kind} takes head_dim in {_HEAD_DIMS}, not {d}")
    if k.dtype not in _CACHE_CODE:
        raise TypeError(f"{kind} takes f32, bf16 and int8 caches, not "
                        f"{k.dtype}")
    for name, t in (("k", k), ("v", v), ("k scales", ks), ("v scales", vs),
                    ("table", table)):
        if t is not None and (not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{kind} needs its {name} contiguous on {dev}")
    out = torch.empty((b, T, nh, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if q.dtype not in _Q_CODE:
        q = q.float()
    pos = _pos_vector(pos0, b, dev)
    nsplit = -(-L // SPLIT_K)
    stream = _stream(dev)
    R = T * (nh // nkv)
    n_ws, n_cnt = (b * nkv * R * nsplit * (d + 2), b * nkv * R) \
        if nsplit > 1 else (0, 0)
    ws, cnt = _scratch_for(dev, stream, n_ws, n_cnt)
    P, _, _, ps = k.shape if table is not None else (0, 0, 0, 0)
    params = _ATTEND_PARAMS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        0 if ks is None else ks.data_ptr(),
        0 if vs is None else vs.data_ptr(), pos.data_ptr(), out.data_ptr(),
        0 if table is None else table.data_ptr(), ws.data_ptr(),
        cnt.data_ptr(), *q.stride(), ws.numel(), cnt.numel(),
        _CACHE_CODE[k.dtype], _Q_CODE[q.dtype], b, nkv, T, nh // nkv, d,
        L if table is None else 0, 1 if pos.dim() else 0, P, ps,
        0 if table is None else table.shape[1], SPLIT_K,
        0 if table is None else 1, float(scale), 0)
    fn = _lib_fn("rlo_decode_attend", _BLOCK_ARGTYPES)
    if torch._C._cuda_getDevice() == dev.index:
        rc = fn(params, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(params, stream)
    if rc != 0:
        raise RuntimeError(f"{kind} decode attention launch failed: CUDA "
                           f"error {rc} (b={b}, kvh={nkv}, T={T}, nh={nh}, "
                           f"hd={d}, L={L}, {k.dtype})")
    _count(counted)
    return out


def flash_block_decode(q, k_cache, v_cache, pos0, scale, k_scale=None,
                       v_scale=None):
    """Fused T-query decode attention (T = 1 is single-token decode):
    ``q`` (b, T, n_heads, head_dim), any strides, row b's query t at
    ``pos0_b + t``, the cache axis split at ``SPLIT_K``. Returns (b, T,
    n_heads, head_dim) f32. CPU tensors take the plain version; CUDA
    tensors launch K6 or raise."""
    _check_decode(q, k_cache, v_cache, k_scale, v_scale)
    if _on("flash_block_decode", q):
        return flash_block_decode_plain(q, k_cache, v_cache, pos0, scale,
                                        k_scale, v_scale)
    return _launch_attend("K6", flash_block_decode, q, k_cache, v_cache,
                          k_scale, v_scale, pos0, scale, k_cache.shape[3])


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
# The in-place cache writes (K7 with K10 below, K8 with K11)
# ---------------------------------------------------------------------------

def _check_write(cache, rows, want_rows, kind,
                 layout="cache (b, kvh, hd, L)"):
    if cache.dim() != 4 or tuple(rows.shape) != want_rows:
        raise ValueError(f"{kind}: {layout} and rows {want_rows} expected; "
                         f"got {tuple(cache.shape)}, {tuple(rows.shape)}")
    if rows.get_device() != cache.get_device():
        raise ValueError(f"{kind}: rows and cache on different devices")


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
                             block_k: int = BLOCK_K, split_k=SPLIT_K):
    """Plain PyTorch version of K9: the table (clamped into [0, P - 1])
    gathers each row's logical cache out of the pools, and K6's plain
    tile loop (``block_k`` wide, split and merged at ``split_k``)
    attends it. The CPU path, and the version the kernel is held against
    on the card."""
    _check_paged(q, k_pool, v_pool, table, ks_pool, vs_pool)
    tab = table.clamp(0, k_pool.shape[0] - 1)
    kg, vg = gather_pages(k_pool, tab), gather_pages(v_pool, tab)
    ksg = vsg = None
    if ks_pool is not None:
        ksg, vsg = gather_pages(ks_pool, tab), gather_pages(vs_pool, tab)
    return flash_block_decode_plain(q, kg, vg, pos0, scale, ksg, vsg,
                                    block_k=block_k, split_k=split_k)


def paged_flash_decode(q, k_pool, v_pool, table, pos0, scale, ks_pool=None,
                       vs_pool=None):
    """Fused paged decode attention (K9): ``q`` (b, T, n_heads,
    head_dim), any strides, row b's query t at position ``pos0_b + t``
    attending the positions <= it of its logical cache, whose page i is
    physical page ``table[b, i]`` of the pools (P, kv_heads, head_dim,
    page_size) (int8 pools take f32 scale pools (P, kv_heads,
    page_size)). ``table`` is (b, max_pages) int32; table entries are
    clamped into [0, P - 1]. The logical cache axis is split at
    ``SPLIT_K``. Returns (b, T, n_heads, head_dim) f32. CPU tensors take
    the plain version; CUDA tensors launch K9 or raise."""
    _check_paged(q, k_pool, v_pool, table, ks_pool, vs_pool)
    if _on("paged_flash_decode", q):
        return paged_flash_decode_plain(q, k_pool, v_pool, table, pos0,
                                        scale, ks_pool, vs_pool)
    if table.dtype != torch.int32:
        raise TypeError(f"K9 takes an int32 table, not {table.dtype}")
    return _launch_attend("K9", paged_flash_decode, q, k_pool, v_pool,
                          ks_pool, vs_pool, pos0, scale,
                          table.shape[1] * k_pool.shape[3], table)


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


#: the parameter block of ``rlo_write_kv_rows`` (csrc/decode.cu): dst0,
#: src0, dst1, src1; the two rows' (batch, head, d) strides; page (0: the
#: batch row), off; page_stride, off_stride, nb, H, D, P, ps, element size
_ROW_PARAMS = struct.Struct("<4Q6q2Q8i")


def _launch_rows(kind, counted, dst, row, dst2, row2, page, off) -> None:
    """One K7/K10 launch over one or two (destination, rows) pairs, the
    rows read in place through their strides; ``page`` None is K7's
    dense cache (page = batch row), else K10's (b,) or shared page."""
    if not dst.is_contiguous() or not (dst2 is None or dst2.is_contiguous()):
        raise ValueError(f"{kind} needs contiguous destinations")
    if row.numel() == 0 or dst.numel() == 0:
        return
    if row.dtype != dst.dtype:
        row = row.to(dst.dtype)
    p1, s1 = (0, 0), (0, 0, 0)
    if dst2 is not None:
        if row2.dtype != dst.dtype:
            row2 = row2.to(dst.dtype)
        p1, s1 = (dst2.data_ptr(), row2.data_ptr()), row2.stride()
    b = row.shape[0]
    dev = dst.device
    off = _pos_vector(off, b, dev)
    pg, pg_stride = 0, 0
    if page is not None:
        page = _pos_vector(page, b, dev)
        pg, pg_stride = page.data_ptr(), page.stride(0) if page.dim() else 0
    P, nkv, d, ps = dst.shape
    params = _ROW_PARAMS.pack(
        dst.data_ptr(), row.data_ptr(), *p1, *row.stride(), *s1, pg,
        off.data_ptr(), pg_stride, off.stride(0) if off.dim() else 0, b,
        nkv, d, P, ps, dst.element_size())
    fn = _lib_fn("rlo_write_kv_rows", _BLOCK_ARGTYPES)
    index = dev.index
    if torch._C._cuda_getDevice() == index:
        rc = fn(params, _stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(params, _stream(index))
    if rc == -2:
        raise _alias_error(counted.__name__)
    if rc != 0:
        raise RuntimeError(f"{kind} row write launch failed: CUDA error {rc} "
                           f"({b} x {nkv} x {d}, {dst.dtype})")
    _count(counted)


def write_kv_page_row(pool, row, page, off, pool2=None, row2=None):
    """K10: write ``row`` (b, kvh, hd), any strides, into lane ``off_b``
    of page ``page_b`` of ``pool`` (P, kvh, hd, ps) in place and return the
    pool; ``page``/``off`` are (b,) int32 (or one shared value), read on
    the device. ``pool2``/``row2`` (the same shapes and dtype, aliasing
    neither of the first pair) are written by the same launch. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    _check_page_row(pool, row, pool2, row2)
    if _on("write_kv_page_row", pool):
        return write_kv_page_row_plain(pool, row, page, off, pool2, row2)
    _launch_rows("K10", write_kv_page_row, pool, row, pool2, row2, page, off)
    return pool


write_kv_page_row.launches = 0


def _check_row(cache, row, cache2, row2) -> None:
    """K7's shapes (and the pair's)."""
    _check_write(cache, row, tuple(cache.shape[:3]), "write_kv_row")
    _check_pair("write_kv_row", cache, row, cache2, row2)


def write_kv_row_plain(cache, row, pos, cache2=None, row2=None):
    """Plain version of K7: ``cache[b, :, :, pos_b] = row[b]`` in place,
    dropping rows whose position lies outside [0, L); the same for
    (``cache2``, ``row2``) when given."""
    _check_row(cache, row, cache2, row2)
    _check_alias("write_kv_row", cache, row, cache2, row2)
    b, L = cache.shape[0], cache.shape[3]
    posv = _positions(_pos_vector(pos, b, cache.device), b).long()
    idx = torch.nonzero((posv >= 0) & (posv < L)).flatten()
    if idx.numel():
        for c, r in _pairs(cache, row, cache2, row2):
            c[idx, :, :, posv[idx]] = r[idx].to(c.dtype)
    return cache


def write_kv_row(cache, row, pos, cache2=None, row2=None):
    """K7: write ``row`` (b, kvh, hd), any strides, into column ``pos_b``
    of ``cache`` (b, kvh, hd, L) in place and return the cache; ``pos``
    is (b,) int32 or one shared value, read on the device. ``cache2``/
    ``row2`` (the same shapes and dtype, aliasing neither of the first
    pair) are written by the same launch. K10's kernel, the cache a pool
    whose page is the batch row. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    _check_row(cache, row, cache2, row2)
    if _on("write_kv_row", cache):
        return write_kv_row_plain(cache, row, pos, cache2, row2)
    _launch_rows("K7", write_kv_row, cache, row, cache2, row2, None, pos)
    return cache


write_kv_row.launches = 0


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
