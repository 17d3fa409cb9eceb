"""Device side of the paged KV cache.

The port of ``rlo_tpu/models/paged.py``. The dense serving cache
(``models.generate.init_kv_cache``) holds one max_len-long seq-minor row
per slot; the paged cache is a GLOBAL pool of ``page_size``-token pages
per layer plus a per-slot int32 page table, so a slot pins only the
pages its live prefix spans, and identical prompt prefixes can map the
same physical pages (``rlo_tpu_torch.serving.pages`` decides who maps
what; this module only moves bytes).

Layout, as in the JAX package: each layer's pool is (n_pages, kv_heads,
head_dim, page_size) in the activation dtype, a page being a slice of
the dense seq-minor cache; logical page i of slot b is physical page
``table[b, i]``. int8 caches carry (n_pages, kv_heads, page_size) f32
scale pools at the same page indexes. Pools have the dense cache's
structure (a list of {"k", "v"[, "ks", "vs"]} per layer), so they cross
from and to the JAX package with ``convert.cache_from_numpy`` and
``cache_to_numpy``.

Where the JAX functions return new pools, the port updates the pools it
is given **in place** (and returns that same list): decode writes one
row per slot through K10 (``kernels.decode.write_kv_page_row``), a
prefill chunk writes one page through K11 (``write_kv_page_block``),
``copy_page`` copies a page in place. Every attend runs through K9
(``paged_flash_decode``). On CPU tensors each kernel wrapper takes its
plain twin; on the card they launch the kernels. The layer math is
``apply_layer`` with the ``attention=`` hook, as in dense decode, so
paged cannot drift from dense. MoE configs route drop-free in both
functions, as dense decode does (``generate._decode_cfg``).
"""

from __future__ import annotations

import torch

from rlo_tpu_torch.kernels.decode import (gather_pages, paged_flash_decode,
                                          write_kv_page_block,
                                          write_kv_page_row)
from rlo_tpu_torch.models.generate import (_decode_cfg, _pos_tensor,
                                           _quantize_kv)
from rlo_tpu_torch.models.transformer import (TransformerConfig, _rmsnorm,
                                              apply_layer, embed_tokens)
from rlo_tpu_torch.serving.pages import NULL_PAGE


def init_page_pool(cfg: TransformerConfig, n_pages: int, page_size: int,
                   device=None):
    """Zeroed per-layer page pools on ``device`` (None is the card): a
    list of {"k", "v"} tensors (n_pages, kv_heads, head_dim, page_size),
    the dense cache's seq-minor layout with the sequence axis cut into
    pages. Page 0 is the reserved null page (``pages.NULL_PAGE``).
    ``cfg.kv_cache_dtype == 'int8'`` adds (n_pages, kv_heads, page_size)
    f32 scale pools "ks", "vs". Any page size is legal off a TPU."""
    from rlo_tpu_torch.parallel.mesh import resolve_device
    dev = resolve_device(device)
    shape = (n_pages, cfg.kv_heads, cfg.head_dim, page_size)
    if cfg.kv_cache_dtype == "int8":
        sshape = (n_pages, cfg.kv_heads, page_size)
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


def paged_view(entry, table):
    """A layer's logical per-slot caches gathered out of its pool:
    ``table`` (b, mp) int32 -> (k, v, ks, vs), k/v (b, kv_heads,
    head_dim, mp * page_size) in the dense layout, ks/vs the matching
    scale views (None for plain caches). Unmapped entries point at the
    null page."""
    ks = gather_pages(entry["ks"], table) if "ks" in entry else None
    vs = gather_pages(entry["vs"], table) if "vs" in entry else None
    return (gather_pages(entry["k"], table), gather_pages(entry["v"], table),
            ks, vs)


def pages_from_dense(cache, table, n_pages: int, page_size: int):
    """Page pools holding a dense cache's columns: row b's columns
    [i * page_size, (i + 1) * page_size) go to page ``table[b, i]`` of
    zeroed pools of ``n_pages`` (columns past the cache's max_len are
    zero). ``table`` (b, mp) int32 lists distinct pages other than the
    null page; mp * page_size must cover max_len. Returns new pools with
    the cache's keys (``paged_view`` through ``table`` gives the cache
    back)."""
    b, mp = table.shape
    flat = table.reshape(-1).long()
    pools = []
    for lc in cache:
        entry = {}
        for key, t in lc.items():
            L = t.shape[-1]
            if mp * page_size < L or t.shape[0] != b:
                raise ValueError(f"a ({b}, {mp}) table of {page_size}-token "
                                 f"pages cannot hold a cache of "
                                 f"{tuple(t.shape)}")
            inner = tuple(t.shape[1:-1])
            cols = torch.zeros((b,) + inner + (mp * page_size,),
                               dtype=t.dtype, device=t.device)
            cols[..., :L] = t
            cols = cols.reshape((b,) + inner + (mp, page_size)) \
                .movedim(-2, 1).reshape((b * mp,) + inner + (page_size,))
            pool = torch.zeros((n_pages,) + inner + (page_size,),
                               dtype=t.dtype, device=t.device)
            pool[flat] = cols
            entry[key] = pool
        pools.append(entry)
    return pools


def paged_write_rows(entry, k_row, v_row, ks_new, vs_new, page, off):
    """Write one (kvh, hd) K/V row per slot into its page, in place
    (K10): ``page``/``off`` (b,) int32, row b lands at [page_b, :, :,
    off_b]; an off outside [0, page_size) (the server's ``page_size``
    sentinel for inactive slots) drops the write. Slots never share a
    writable page (the copy-on-write invariant). The rows may be views
    (the decode step's ``k[:, 0]`` of the projection, read in place); k
    with v, and the scales, each take one launch. Returns ``entry``."""
    write_kv_page_row(entry["k"], k_row, page, off, entry["v"], v_row)
    if ks_new is not None:
        # the scale pools (P, kvh, ps) ride the same kernel through their
        # (P, kvh, 1, ps) view
        write_kv_page_row(entry["ks"][:, :, None, :], ks_new[:, :, None],
                          page, off, entry["vs"][:, :, None, :],
                          vs_new[:, :, None])
    return entry


def paged_write_chunk(entry, kt, vt, ks_new, vs_new, page, off0, n_valid):
    """Write one slot's prefill chunk into one page, in place (K11):
    ``kt``/``vt`` (kvh, hd, T) seq-minor, any strides (the projection's
    output permuted, read in place), token t landing at [page, :, :, off0
    + t] for t < n_valid (pads dropped); ``ks_new``/``vs_new`` (kvh, T)
    for int8 pools. k with v, and the scales, each take one launch. The
    chunk never crosses a page boundary (off0 + n_valid <= page_size,
    scheduled by the server). Returns ``entry``."""
    write_kv_page_block(entry["k"], kt, page, off0, n_valid, entry["v"], vt)
    if ks_new is not None:
        # the scale pools (P, kvh, ps) ride the same kernel through their
        # (P, kvh, 1, ps) view
        write_kv_page_block(entry["ks"][:, :, None, :], ks_new[:, None, :],
                            page, off0, n_valid, entry["vs"][:, :, None, :],
                            vs_new[:, None, :])
    return entry


def _paged_attend(q, entry, table, pos0, scale):
    """q (b, T, nh, hd), row b's query t at pos0_b + t, against the
    table-mapped pages: positions <= it (write-then-attend), through
    K9. Returns f32."""
    return paged_flash_decode(q, entry["k"], entry["v"], table, pos0, scale,
                              entry.get("ks"), entry.get("vs"))


def paged_decode_step(params: dict, token, pos, pools, table, active,
                      cfg: TransformerConfig):
    """One token (b,) int32 per slot at per-slot positions ``pos`` (b,)
    through all layers over the paged pools. ``table`` (b, mp) int32
    maps logical page i of slot b to its physical page; ``active`` (b,)
    bool gates the cache writes (inactive slots, mid-prefill, retired or
    idle, compute values that are never written or read). A position
    whose table entry is the null page is not written either (the JAX
    package writes it into page 0, where no live position ever reads
    it); page 0 stays zero. All on the params' device; nothing is read
    back to the host. Returns (logits (b, vocab) f32, pools), the pools
    updated in place."""
    cfg = _decode_cfg(cfg)
    dt = cfg.act_dtype
    dev = params["embed"].device
    posv = _pos_tensor(pos, dev).reshape(-1)
    ps = pools[0]["k"].shape[3]
    mp = table.shape[1]
    page_i = torch.clamp(torch.div(posv, ps, rounding_mode="floor"), 0,
                         mp - 1)
    page = table.gather(1, page_i[:, None].long())[:, 0]
    # a row that decodes past its reserved pages (an unclipped round's
    # tail) reads an unmapped entry: its write is dropped too, so the
    # null page stays zero
    ok = active & (posv >= 0) & (posv < mp * ps) & (page != NULL_PAGE)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    page = torch.where(ok, page, zero)
    off = torch.where(ok, torch.remainder(posv, ps),
                      torch.full((), ps, dtype=torch.int32, device=dev))
    pos_arr = posv[:, None]
    x = embed_tokens(params["embed"], token[:, None], pos_arr, cfg)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    for layer, lc in zip(params["layers"], pools):
        def attend(q, k, v, lc=lc):
            k_row, v_row = k[:, 0], v[:, 0]          # (b, kvh, hd)
            ks_new = vs_new = None
            if "ks" in lc:
                k_row, ks_new = _quantize_kv(k_row)
                v_row, vs_new = _quantize_kv(v_row)
            paged_write_rows(lc, k_row, v_row, ks_new, vs_new, page, off)
            return _paged_attend(q, lc, table, posv, scale).to(dt)

        x, _ = apply_layer(x, layer, cfg, attention=attend, pos=pos_arr)
    x = _rmsnorm(x, params["ln_f"]["g"])
    logits = (x[:, 0, :] @ params["embed"].t().to(dt)).float()
    return logits, pools


def paged_prefill_chunk(params: dict, tokens, pos0, n_valid, pools, table,
                        cfg: TransformerConfig):
    """One slot's prompt chunk in one forward: ``tokens`` (1, T) int32
    (padded past ``n_valid`` with any valid id), token i at position
    pos0 + i, K/V of the first ``n_valid`` tokens written to page
    ``table[0, pos0 // page_size]`` (read on the device). ``pos0`` and
    ``n_valid`` are ints or one-element int32 tensors. The chunk must not
    cross a page boundary: pos0 % page_size + n_valid <= page_size.
    Returns (logits (1, vocab) f32 at position pos0 + n_valid - 1, pools),
    the pools updated in place; the final chunk's logits seed the first
    generated token.

    Queries attend the table-mapped prefix [0, pos0 + i]: earlier
    chunks' pages (shared prefix pages included) plus this chunk's own
    just-written rows (write-then-attend, the mask of block decode)."""
    cfg = _decode_cfg(cfg)
    dt = cfg.act_dtype
    dev = params["embed"].device
    b, T = tokens.shape
    ps = pools[0]["k"].shape[3]
    mp = table.shape[1]
    pos0 = _pos_tensor(pos0, dev).reshape(1)
    n_valid = _pos_tensor(n_valid, dev).reshape(1)
    lp = torch.clamp(torch.div(pos0, ps, rounding_mode="floor"), 0, mp - 1)
    page = table[0].gather(0, lp.long())
    off0 = torch.remainder(pos0, ps)
    pos_arr = pos0[:, None] + torch.arange(T, dtype=torch.int32,
                                           device=dev)[None, :]  # (1, T)
    x = embed_tokens(params["embed"], tokens, pos_arr, cfg)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    for layer, lc in zip(params["layers"], pools):
        def attend(q, k, v, lc=lc):
            ks_new = vs_new = None
            if "ks" in lc:
                # quantise over hd per position before the seq-minor flip
                k, ks_new = _quantize_kv(k)          # (1, T, kvh, hd)
                v, vs_new = _quantize_kv(v)
                ks_new, vs_new = ks_new[0].t(), vs_new[0].t()  # (kvh, T)
            kt = k[0].permute(1, 2, 0)               # (kvh, hd, T)
            vt = v[0].permute(1, 2, 0)
            paged_write_chunk(lc, kt, vt, ks_new, vs_new, page, off0,
                              n_valid)
            return _paged_attend(q, lc, table, pos0, scale).to(dt)

        x, _ = apply_layer(x, layer, cfg, attention=attend, pos=pos_arr)
    x = _rmsnorm(x, params["ln_f"]["g"])
    idx = torch.clamp(n_valid - 1, 0, T - 1).long()
    xl = x.index_select(1, idx)[:, 0]
    logits = (xl @ params["embed"].t().to(dt)).float()
    return logits, pools


def copy_page(pools, src: int, dst: int):
    """The copy-on-write primitive: page ``dst`` := page ``src`` across
    every layer's pools (K, V and the int8 scale pools), in place.
    Returns ``pools``."""
    for entry in pools:
        for t in entry.values():
            t[dst].copy_(t[src])
    return pools
