"""K9 (paged decode), K10 and K11 (page writes) against their plain
versions on the card.

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py`` says);
the inputs are those of ``tests/test_torch_paged.py``, made with numpy
from the same seeds, bf16 rounded by torch (round to nearest even, as
``jnp.asarray(x, jnp.bfloat16)`` rounds there).
"""

import numpy as np
import pytest
import torch

from rlo_tpu_torch.convert import from_numpy
from rlo_tpu_torch.kernels import decode as kd


def _on(x, dev, kind):
    """A numpy array on ``dev``; f32 rounded to bf16 for ``kind`` bf16."""
    t = from_numpy([x], dev)[0]
    return t.to(torch.bfloat16) if kind == "bf16" and t.is_floating_point() \
        else t


def _values(shape, kind, rng):
    """Random values of ``kind`` (f32 values for bf16: ``_on`` rounds)."""
    if kind == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


def _quant_pool(x):
    """(P, g, d, ps) f32 -> int8 pool + (P, g, ps) scales, per position."""
    xf = np.moveaxis(x, 2, 3)
    s = np.maximum(np.abs(xf).max(-1), 1e-30).astype(np.float32) / 127
    q = np.round(xf / s[..., None]).astype(np.int8)
    return np.ascontiguousarray(np.moveaxis(q, 3, 2)), s.astype(np.float32)


def _paged_case(kind, ps, T, nkv, seed, dev, P=7, b=3, mp=5, nh=4, d=16):
    """(q, k pool, v pool, page table, pos0, k scales, v scales) on
    ``dev``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, T, nh, d)).astype(np.float32)
    kp = rng.standard_normal((P, nkv, d, ps)).astype(np.float32)
    vp = rng.standard_normal((P, nkv, d, ps)).astype(np.float32)
    ks = vs = None
    if kind == "int8":
        kp, ks = _quant_pool(kp)
        vp, vs = _quant_pool(vp)
    table = rng.integers(1, P, (b, mp)).astype(np.int32)
    table[1, 2:] = 0                      # unmapped tail: the null page
    L = mp * ps
    pos0 = np.array([L - T, 2 * ps - T + 1, ps // 2], np.int32)[:b]
    return [_on(q, dev, kind), _on(kp, dev, kind), _on(vp, dev, kind),
            from_numpy([table], dev)[0], from_numpy([pos0], dev)[0]] + \
        [None if a is None else from_numpy([a], dev)[0] for a in (ks, vs)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4, 128])
def test_paged_kernel_matches_plain_on_card(cuda, kind, T):
    """Against the twin at SPLIT_K, over 9 pages of 32 (two splits) and
    26 (four), and pages of 16 (the smallest whose runs are whole 16-byte
    chunks for every dtype)."""
    for ps, mp in ((32, 9), (32, 26), (16, 52)):
        args = _paged_case(kind, ps, T, 2, seed=T, dev=cuda, d=64, mp=mp)
        L = ps * mp
        args[4] = torch.tensor([L - T, L // 2, 3], dtype=torch.int32,
                               device=cuda)
        got = kd.paged_flash_decode(*args[:5], 0.125, args[5], args[6])
        torch.cuda.synchronize()
        want = kd.paged_flash_decode_plain(*args[:5], 0.125, args[5],
                                           args[6])
        torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_kernel_bits_on_card(cuda, kind):
    """Row t of a T = 4 call at pos p equals a T = 1 call at p + t bit for
    bit, 50 repeat launches give the first launch's bits, and K9 on pages
    holding a dense cache's columns equals K6 on that cache."""
    ps, mp = 32, 26
    S = kd.SPLIT_K
    q, kp, vp, table, _, ks, vs = _paged_case(kind, ps, 4, 2, seed=5,
                                              dev=cuda, d=64, mp=mp)
    q = q.to(torch.bfloat16)
    pos = torch.tensor([S - 2, 2 * S - 1, ps * mp - 4], dtype=torch.int32,
                       device=cuda)
    block = kd.paged_flash_decode(q, kp, vp, table, pos, 0.125, ks, vs)
    for t in range(4):
        one = kd.paged_flash_decode(q[:, t:t + 1], kp, vp, table, pos + t,
                                    0.125, ks, vs)
        assert torch.equal(one[:, 0], block[:, t]), t
    for _ in range(50):
        assert torch.equal(kd.paged_flash_decode(q, kp, vp, table, pos,
                                                 0.125, ks, vs), block)
    tab = table.clamp(0, kp.shape[0] - 1)
    dense = [None if x is None else kd.gather_pages(x, tab).contiguous()
             for x in (kp, vp, ks, vs)]
    assert torch.equal(kd.flash_block_decode(q, dense[0], dense[1], pos,
                                             0.125, dense[2], dense[3]),
                       block)


@pytest.mark.gpu
def test_page_writes_match_plain_on_card(cuda):
    rng = np.random.default_rng(0)
    for kind in ("f32", "bf16", "int8"):
        pool = _on(_values((6, 2, 64, 128), kind, rng), cuda, kind)
        row = _on(_values((4, 2, 64), kind, rng), cuda, kind)
        rows = _on(_values((2, 64, 32), kind, rng), cuda, kind)
        page = torch.tensor([1, 5, 9, 2], dtype=torch.int32, device=cuda)
        off = torch.tensor([0, 127, 128, -1], dtype=torch.int32, device=cuda)
        a, b = pool.clone(), pool.clone()
        kd.write_kv_page_row(a, row, page, off)
        kd.write_kv_page_row_plain(b, row, page, off)
        for p, o0, nv in ((3, 100, 28), (9, 0, 7), (2, -4, 32)):
            kd.write_kv_page_block(a, rows, p, o0, nv)
            kd.write_kv_page_block_plain(b, rows, p, o0, nv)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


#: rows layouts: the callers' permuted view of the k slice of a (T, 3 *
#: kvh * hd) projection output (hd contiguous, tokens 16-byte aligned:
#: the kernel's 16-byte loads along hd), that slice one element off in a
#: (T, 3 * kvh * hd + 1) tensor (scalar loads), and a contiguous (kvh,
#: hd, T) copy (scalar loads)
LAYOUTS = ["view", "misaligned", "contiguous"]


def _vector_loads(rows):
    """Whether ``rows`` (.., hd, T) meet the kernel's test for 16-byte
    loads along hd: hd contiguous, a multiple of 16 bytes, and every
    token's start 16-byte aligned."""
    e = rows.element_size()
    return (rows.stride(-2) == 1 and rows.shape[-2] * e % 16 == 0
            and rows.stride(-1) * e % 16 == 0 and rows.data_ptr() % 16 == 0)


def _chunk_rows(nkv, hd, T, kind, rng, dev, layout):
    """(kvh, hd, T) rows in ``layout``, from a projection-like tensor (see
    ``LAYOUTS``)."""
    w = nkv * hd
    pad = 1 if layout == "misaligned" else 0
    t = _on(_values((T, 3 * w + pad), kind, rng), dev, kind)
    first = w + pad
    view = t[:, first:first + w].reshape(T, nkv, hd).permute(1, 2, 0)
    rows = view.contiguous() if layout == "contiguous" else view
    assert _vector_loads(rows) == (layout == "view" and hd > 1)
    return rows


def _chunk_pool(P, nkv, hd, ps, kind, rng, dev):
    """A (P, kvh, hd, ps) pool; hd = 1 as the (P, kvh, 1, ps) view of a
    (P, kvh, ps) scale pool, the route the int8 scales take."""
    if hd == 1:
        return _on(_values((P, nkv, ps), kind, rng), dev, kind)[:, :, None, :]
    return _on(_values((P, nkv, hd, ps), kind, rng), dev, kind)


def _same(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [1, 16, 32, 64, 128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_page_block_write_kernel_matches_plain_on_card(cuda, kind, hd,
                                                       layout):
    """K11, single and pair form, bit for bit against its plain version:
    element sizes 4/2/1, hd 16-128 and the scale pools' hd = 1 view, rows
    as the callers' views or not; a whole page (T = ps), off0 off the
    16-byte lanes, a negative start, n_valid 0, a chunk ending at the page
    edge (off0 + n_valid = ps), pads past n_valid, a page past the pool
    (clamped). A pair costs one launch."""
    rng = np.random.default_rng(hd)
    P, nkv, ps = 5, 2, 128
    pool = _chunk_pool(P, nkv, hd, ps, kind, rng, cuda)
    pool2 = _chunk_pool(P, nkv, hd, ps, kind, rng, cuda)
    for T, page, off0, nv in ((ps, 2, 0, ps), (64, 3, 5, 64),
                              (32, 1, -7, 32), (16, 4, 0, 0),
                              (40, P + 4, ps - 24, 24), (128, 0, 3, 100),
                              (24, 2, 8, 24)):
        rows = _chunk_rows(nkv, hd, T, kind, rng, cuda, layout)
        rows2 = _chunk_rows(nkv, hd, T, kind, rng, cuda, layout)
        a, c = pool.clone(), pool.clone()
        kd.write_kv_page_block(a, rows, page, off0, nv)
        kd.write_kv_page_block_plain(c, rows, page, off0, nv)
        torch.cuda.synchronize()
        assert _same(a, c), (T, page, off0, nv, "single")
        a2, c2 = pool2.clone(), pool2.clone()
        before = kd.write_kv_page_block.launches
        kd.write_kv_page_block(a, rows, page, off0, nv, a2, rows2)
        assert kd.write_kv_page_block.launches == before + 1
        kd.write_kv_page_block_plain(c, rows, page, off0, nv, c2, rows2)
        torch.cuda.synchronize()
        assert _same(a, c) and _same(a2, c2), (T, page, off0, nv, "pair")


@pytest.mark.gpu
def test_page_block_write_repeats_the_same_bits_on_card(cuda):
    """50 launches of the bf16 pair from the projection's views give the
    first launch's bits; aliasing pairs raise."""
    rng = np.random.default_rng(4)
    pool = _chunk_pool(9, 16, 64, 128, "bf16", rng, cuda)
    pool2 = _chunk_pool(9, 16, 64, 128, "bf16", rng, cuda)
    rows = _chunk_rows(16, 64, 100, "bf16", rng, cuda, "view")
    rows2 = _chunk_rows(16, 64, 100, "bf16", rng, cuda, "view")
    args = [torch.tensor([x], dtype=torch.int32, device=cuda)
            for x in (6, 11, 100)]
    first = None
    for _ in range(50):
        a, a2 = pool.clone(), pool2.clone()
        kd.write_kv_page_block(a, rows, *args, a2, rows2)
        torch.cuda.synchronize()
        if first is None:
            first = (a, a2)
        assert _same(a, first[0]) and _same(a2, first[1])
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_page_block(pool, rows, *args, pool, rows2)


def _row_rows(b, nkv, hd, kind, rng, dev, layout):
    """(b, kvh, hd) rows in ``layout`` (see ``LAYOUTS``): the decode step's
    ``k[:, 0]`` of the k slice of a (b, 1, 3 * kvh * hd) projection output
    (hd contiguous, 16-byte aligned: the kernel's 16-byte loads), that
    slice one element off (scalar loads), or a contiguous copy."""
    w = nkv * hd
    pad = 1 if layout == "misaligned" else 0
    t = _on(_values((b, 1, 3 * w + pad), kind, rng), dev, kind)
    view = t[..., w + pad:2 * w + pad].reshape(b, 1, nkv, hd)[:, 0]
    return view.contiguous() if layout == "contiguous" else view


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [1, 16, 32, 64, 128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_page_row_write_kernel_matches_plain_on_card(cuda, kind, hd, layout):
    """K10, single and pair form, bit for bit against its plain version:
    element sizes 4/2/1, hd 16-128 and the scale pools' hd = 1 view, rows
    as the decode step's views or not; lanes at both page edges, off = ps
    and off = -1 (dropped), a page past the pool (clamped), two rows on one
    page (both land), shared and per-row page/off. A pair costs one
    launch."""
    rng = np.random.default_rng(100 + hd)
    P, nkv, ps, b = 7, 2, 128, 6
    pool = _chunk_pool(P, nkv, hd, ps, kind, rng, cuda)
    pool2 = _chunk_pool(P, nkv, hd, ps, kind, rng, cuda)
    vec = torch.tensor
    # rows 3 and 4 share page 2; row 2's page clamps to P - 1 = 6, whose
    # own row writes nothing (off = ps); one page shared by every row (0-d),
    # each in its own lane; one lane shared by rows on distinct pages
    for page, off in ((vec([1, 5, P + 3, 2, 2, 6]), vec([0, 127, 4, 9, 10,
                                                          ps])),
                      (vec([3, 0, 4, 6, 1, 2]), vec([-1, 64, 1, 2, 3, 5])),
                      (vec(4), vec([0, 3, 17, 64, 100, 127])),
                      (vec([1, 2, 3, 4, 5, 6]), vec(77))):
        page, off = (x.to(torch.int32).to(cuda) for x in (page, off))
        row = _row_rows(b, nkv, hd, kind, rng, cuda, layout)
        row2 = _row_rows(b, nkv, hd, kind, rng, cuda, layout)
        a, c = pool.clone(), pool.clone()
        kd.write_kv_page_row(a, row, page, off)
        kd.write_kv_page_row_plain(c, row, page, off)
        torch.cuda.synchronize()
        assert _same(a, c), (page, off, "single")
        a2, c2 = pool2.clone(), pool2.clone()
        before = kd.write_kv_page_row.launches
        kd.write_kv_page_row(a, row, page, off, a2, row2)
        assert kd.write_kv_page_row.launches == before + 1
        kd.write_kv_page_row_plain(c, row, page, off, c2, row2)
        torch.cuda.synchronize()
        assert _same(a, c) and _same(a2, c2), (page, off, "pair")


@pytest.mark.gpu
def test_page_row_write_repeats_the_same_bits_on_card(cuda):
    """50 launches of the bf16 k/v pair from the decode step's views (32
    rows x 16 kv heads x 64 into 289 pages of 128) give the first launch's
    bits, and the rows' other-page neighbours stay as they were; aliasing
    pairs raise."""
    rng = np.random.default_rng(5)
    P, ps, b = 289, 128, 32
    pool = _chunk_pool(P, 16, 64, ps, "bf16", rng, cuda)
    pool2 = _chunk_pool(P, 16, 64, ps, "bf16", rng, cuda)
    row = _row_rows(b, 16, 64, "bf16", rng, cuda, "view")
    row2 = _row_rows(b, 16, 64, "bf16", rng, cuda, "view")
    page = torch.tensor(rng.permutation(P - 1)[:b] + 1, dtype=torch.int32,
                        device=cuda)
    off = torch.tensor(rng.integers(0, ps, b), dtype=torch.int32,
                       device=cuda)
    first = None
    for _ in range(50):
        a, a2 = pool.clone(), pool2.clone()
        kd.write_kv_page_row(a, row, page, off, a2, row2)
        torch.cuda.synchronize()
        if first is None:
            first = (a, a2)
        assert _same(a, first[0]) and _same(a2, first[1])
    c, c2 = pool.clone(), pool2.clone()
    kd.write_kv_page_row_plain(c, row, page, off, c2, row2)
    assert _same(first[0], c) and _same(first[1], c2)
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_page_row(pool, row, page, off, pool, row2)
