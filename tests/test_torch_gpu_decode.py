"""K6 (flash decode), K7 and K8 (cache writes) against their plain
versions on the card.

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py`` says);
the inputs are those of ``tests/test_torch_decode.py``, made with numpy
from the same seeds, bf16 rounded by torch (round to nearest even, as
``jnp.asarray(x, jnp.bfloat16)`` rounds there).
"""

import numpy as np
import pytest
import torch

from rlo_tpu_torch.convert import from_numpy
from rlo_tpu_torch.kernels import decode as kd

B, NH, NKV, D = 3, 8, 4, 16


def _quant(x):
    """Seq-minor (b, g, d, L) -> int8 + (b, g, L) scales, per position."""
    xf = np.moveaxis(x, 2, 3)
    s = np.maximum(np.abs(xf).max(-1), 1e-30).astype(np.float32) / 127
    q = np.round(xf / s[..., None]).astype(np.int8)
    return np.ascontiguousarray(np.moveaxis(q, 3, 2)), s.astype(np.float32)


def _case(T, L, kind, seed, dev, nkv=NKV):
    """(q, k cache, v cache, k scales, v scales) on ``dev``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, NH, D)).astype(np.float32)
    kc = rng.standard_normal((B, nkv, D, L)).astype(np.float32)
    vc = rng.standard_normal((B, nkv, D, L)).astype(np.float32)
    ks = vs = None
    if kind == "int8":
        kc, ks = _quant(kc)
        vc, vs = _quant(vc)
    out = [None if a is None else from_numpy([a], dev)[0]
           for a in (q, kc, vc, ks, vs)]
    if kind == "bf16":
        out[:3] = [t.to(torch.bfloat16) for t in out[:3]]
    return out


def _cache(L, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        c = rng.integers(-127, 127, (B, NKV, D, L)).astype(np.int8)
    else:
        c = rng.standard_normal((B, NKV, D, L)).astype(np.float32)
    return c


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


#: caches of one split and of four (K6 splits the cache axis at SPLIT_K)
LENGTHS = (300, 3 * kd.SPLIT_K + 40)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4, 128])
def test_decode_kernel_matches_plain_on_card(cuda, kind, T):
    """Against the twin at SPLIT_K, over one split and over four, scalar
    and ragged positions (one past max_len: a retired slot)."""
    for L in LENGTHS:
        args = _case(T, L, kind, seed=T, dev=cuda)
        for pos in (torch.tensor(200, dtype=torch.int32, device=cuda),
                    torch.tensor([0, L + 1, L - T], dtype=torch.int32,
                                 device=cuda)):
            got = kd.flash_block_decode(args[0], args[1], args[2], pos, 0.25,
                                        args[3], args[4])
            torch.cuda.synchronize()
            want = kd.flash_block_decode_plain(args[0], args[1], args[2],
                                               pos, 0.25, args[3], args[4])
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_decode_kernel_head_dims_on_card(cuda, kind, hd):
    """Every head dim the kernel takes, over four splits, T 1 and 16
    (row tiles of one row group and of two; f32 at hd 128 runs a ring of
    one stage, the two-stage ring not fitting in shared memory)."""
    L = LENGTHS[1]
    rng = np.random.default_rng(hd)
    k = rng.standard_normal((2, 2, hd, L)).astype(np.float32)
    v = rng.standard_normal((2, 2, hd, L)).astype(np.float32)
    ks = vs = None
    if kind == "int8":
        (k, ks), (v, vs) = _quant(k), _quant(v)
    k, v, ks, vs = [None if a is None else from_numpy([a], cuda)[0]
                    for a in (k, v, ks, vs)]
    if kind == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    for T in (1, 16):
        q = from_numpy([rng.standard_normal((2, T, 8, hd))
                        .astype(np.float32)], cuda)[0]
        pos = torch.tensor([L - T, 300], dtype=torch.int32, device=cuda)
        got = kd.flash_block_decode(q, k, v, pos, 0.25, ks, vs)
        torch.cuda.synchronize()
        want = kd.flash_block_decode_plain(q, k, v, pos, 0.25, ks, vs)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


def _proj_view(q):
    """q (b, T, nh, hd) as the decode step passes it: the middle third of
    a (b, T, 3 * nh * hd) projection, strided."""
    b, T, nh, hd = q.shape
    proj = torch.zeros(b, T, 3 * nh * hd, dtype=q.dtype, device=q.device)
    proj[..., nh * hd:2 * nh * hd] = q.reshape(b, T, nh * hd)
    return proj[..., nh * hd:2 * nh * hd].reshape(b, T, nh, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_decode_kernel_bits_on_card(cuda, kind):
    """Row t of a T = 4 call at pos p equals a T = 1 call at p + t bit for
    bit (rows crossing a split edge, one past max_len), 50 repeat launches
    give the first launch's bits (the in-launch merge is in split order),
    and q read in place from the projection's view gives its contiguous
    copy's bits."""
    L = LENGTHS[1]
    S = kd.SPLIT_K
    q, k, v, ks, vs = _case(4, L, kind, seed=11, dev=cuda)
    q = q.to(torch.bfloat16)
    pos = torch.tensor([S - 2, 2 * S - 1, L + 1], dtype=torch.int32,
                       device=cuda)
    block = kd.flash_block_decode(q, k, v, pos, 0.25, ks, vs)
    for t in range(4):
        one = kd.flash_block_decode(q[:, t:t + 1], k, v, pos + t, 0.25, ks,
                                    vs)
        assert torch.equal(one[:, 0], block[:, t]), t
    for _ in range(50):
        assert torch.equal(kd.flash_block_decode(q, k, v, pos, 0.25, ks, vs),
                           block)
    view = _proj_view(q)
    assert not view.is_contiguous()
    assert torch.equal(kd.flash_block_decode(view, k, v, pos, 0.25, ks, vs),
                       block)


@pytest.mark.gpu
def test_writes_match_plain_on_card(cuda):
    for dtype in ("f32", "int8"):
        cache = from_numpy([_cache(256, dtype, seed=7)], cuda)[0]
        row = from_numpy([_cache(1, dtype, seed=8)[..., 0]], cuda)[0]
        rows = from_numpy([_cache(6, dtype, seed=9)], cuda)[0]
        for pos in (torch.tensor([3, 255, 9999], dtype=torch.int32,
                                 device=cuda),
                    torch.tensor(77, dtype=torch.int32, device=cuda)):
            a, b = cache.clone(), cache.clone()
            kd.write_kv_row(a, row, pos)
            kd.write_kv_row_plain(b, row, pos)
            kd.write_kv_block(a, rows, pos)
            kd.write_kv_block_plain(b, rows, pos)
            torch.cuda.synchronize()
            assert torch.equal(a, b)


#: rows layouts: the callers' permuted view of the k slice of a (.., T,
#: 3 * kvh * hd) projection output (hd contiguous, tokens 16-byte
#: aligned: the kernel's 16-byte loads along hd), that slice one element
#: off in a (.., T, 3 * kvh * hd + 1) tensor (scalar loads), and a
#: contiguous (.., kvh, hd, T) copy (scalar loads)
LAYOUTS = ["view", "misaligned", "contiguous"]


def _vector_loads(rows):
    """Whether ``rows`` (.., hd, T) meet the kernel's test for 16-byte
    loads along hd: hd contiguous, a multiple of 16 bytes, and every
    token's start 16-byte aligned."""
    e = rows.element_size()
    return (rows.stride(-2) == 1 and rows.shape[-2] * e % 16 == 0
            and rows.stride(-1) * e % 16 == 0 and rows.data_ptr() % 16 == 0)


def _block_rows(b, nkv, hd, T, kind, rng, dev, layout):
    """(b, kvh, hd, T) rows in ``layout``, from a projection-like tensor
    (see ``LAYOUTS``)."""
    w = nkv * hd
    pad = 1 if layout == "misaligned" else 0
    if kind == "int8":
        proj = rng.integers(-127, 128, (b, T, 3 * w + pad)).astype(np.int8)
    else:
        proj = rng.standard_normal((b, T, 3 * w + pad)).astype(np.float32)
    t = from_numpy([proj], dev)[0]
    if kind == "bf16":
        t = t.to(torch.bfloat16)
    first = w + pad
    view = t[..., first:first + w].reshape(b, T, nkv, hd).permute(0, 2, 3, 1)
    rows = view.contiguous() if layout == "contiguous" else view
    assert _vector_loads(rows) == (layout == "view" and hd > 1)
    return rows


def _block_cache(b, nkv, hd, L, kind, rng, dev):
    """A (b, kvh, hd, L) cache; hd = 1 as the (b, kvh, 1, L) view of a
    (b, kvh, L) scale sidecar, the route the int8 scales take."""
    if kind == "int8":
        c = rng.integers(-127, 128, (b, nkv, hd, L)).astype(np.int8)
    else:
        c = rng.standard_normal((b, nkv, hd, L)).astype(np.float32)
    t = from_numpy([c], dev)[0]
    if kind == "bf16":
        t = t.to(torch.bfloat16)
    return t[:, :, 0].clone()[:, :, None, :] if hd == 1 else t


def _same(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [1, 16, 32, 64, 128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_block_write_kernel_matches_plain_on_card(cuda, kind, hd, layout):
    """K8, single and pair form, bit for bit against its plain version:
    element sizes 4/2/1, hd 16-128 and the scale sidecars' hd = 1 view,
    rows as the callers' views or not, T up to 128, positions on and off
    16-byte columns, from a negative start, straddling and past L, shared
    and per row. A pair costs one launch."""
    rng = np.random.default_rng(hd)
    b, nkv, L = 3, 2, 256
    cache = _block_cache(b, nkv, hd, L, kind, rng, cuda)
    cache2 = _block_cache(b, nkv, hd, L, kind, rng, cuda)
    for T in (1, 7, 64, 128):
        rows = _block_rows(b, nkv, hd, T, kind, rng, cuda, layout)
        rows2 = _block_rows(b, nkv, hd, T, kind, rng, cuda, layout)
        for p in (0, 37, L - 3, L + 5, [5, L - T, 9999], [-4, 64, 200]):
            pos = torch.tensor(p, dtype=torch.int32, device=cuda)
            a, c = cache.clone(), cache.clone()
            kd.write_kv_block(a, rows, pos)
            kd.write_kv_block_plain(c, rows, pos)
            torch.cuda.synchronize()
            assert _same(a, c), (T, p, "single")
            a2, c2 = cache2.clone(), cache2.clone()
            before = kd.write_kv_block.launches
            kd.write_kv_block(a, rows, pos, a2, rows2)
            assert kd.write_kv_block.launches == before + 1
            kd.write_kv_block_plain(c, rows, pos, c2, rows2)
            torch.cuda.synchronize()
            assert _same(a, c) and _same(a2, c2), (T, p, "pair")


@pytest.mark.gpu
def test_block_write_repeats_the_same_bits_on_card(cuda):
    """50 launches of the bf16 pair from the projection's views give the
    first launch's bits; aliasing pairs raise."""
    rng = np.random.default_rng(3)
    cache = _block_cache(2, 16, 64, 256, "bf16", rng, cuda)
    cache2 = _block_cache(2, 16, 64, 256, "bf16", rng, cuda)
    rows = _block_rows(2, 16, 64, 100, "bf16", rng, cuda, "view")
    rows2 = _block_rows(2, 16, 64, 100, "bf16", rng, cuda, "view")
    pos = torch.tensor([3, 150], dtype=torch.int32, device=cuda)
    first = None
    for _ in range(50):
        a, a2 = cache.clone(), cache2.clone()
        kd.write_kv_block(a, rows, pos, a2, rows2)
        torch.cuda.synchronize()
        if first is None:
            first = (a, a2)
        assert _same(a, first[0]) and _same(a2, first[1])
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_block(cache, rows, pos, cache2, cache[..., :100])


def _step_rows(b, nkv, hd, kind, rng, dev, layout):
    """(b, kvh, hd) rows in ``layout``: the decode step's ``k[:, 0]`` of
    the k slice of a (b, 1, 3 * kvh * hd) projection output (hd
    contiguous, 16-byte aligned: the kernel's 16-byte loads), that slice
    one element off (scalar loads), or a contiguous copy."""
    return _block_rows(b, nkv, hd, 1, kind, rng, dev, layout)[..., 0]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [1, 16, 64, 128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_write_kernel_matches_plain_on_card(cuda, kind, hd, layout):
    """K7, single and pair form, bit for bit against its plain version:
    element sizes 4/2/1, hd 16-128 and the scale sidecars' hd = 1 view,
    rows as the decode step's views (16-byte loads), one element off and
    contiguous (scalar loads); positions at both ends, past L and negative
    (dropped), shared and per row. A pair costs one launch."""
    rng = np.random.default_rng(200 + hd)
    b, nkv, L = 5, 2, 256
    cache = _block_cache(b, nkv, hd, L, kind, rng, cuda)
    cache2 = _block_cache(b, nkv, hd, L, kind, rng, cuda)
    for p in (0, 77, L - 1, L, -1, [0, L - 1, L + 3, -2, 131],
              [9, 9, 9, 200, 4]):
        pos = torch.tensor(p, dtype=torch.int32, device=cuda)
        row = _step_rows(b, nkv, hd, kind, rng, cuda, layout)
        row2 = _step_rows(b, nkv, hd, kind, rng, cuda, layout)
        a, c = cache.clone(), cache.clone()
        kd.write_kv_row(a, row, pos)
        kd.write_kv_row_plain(c, row, pos)
        torch.cuda.synchronize()
        assert _same(a, c), (p, "single")
        a2, c2 = cache2.clone(), cache2.clone()
        before = kd.write_kv_row.launches
        kd.write_kv_row(a, row, pos, a2, row2)
        assert kd.write_kv_row.launches == before + 1
        kd.write_kv_row_plain(c, row, pos, c2, row2)
        torch.cuda.synchronize()
        assert _same(a, c) and _same(a2, c2), (p, "pair")


@pytest.mark.gpu
def test_row_write_repeats_the_same_bits_on_card(cuda):
    """50 launches of the bf16 k/v pair from the decode step's views (32
    rows x 16 kv heads x 64 into L 1088) give the first launch's bits;
    aliasing pairs raise."""
    rng = np.random.default_rng(6)
    b, L = 32, 1088
    cache = _block_cache(b, 16, 64, L, "bf16", rng, cuda)
    cache2 = _block_cache(b, 16, 64, L, "bf16", rng, cuda)
    row = _step_rows(b, 16, 64, "bf16", rng, cuda, "view")
    row2 = _step_rows(b, 16, 64, "bf16", rng, cuda, "view")
    pos = torch.tensor(rng.integers(0, L, b), dtype=torch.int32, device=cuda)
    first = None
    for _ in range(50):
        a, a2 = cache.clone(), cache2.clone()
        kd.write_kv_row(a, row, pos, a2, row2)
        torch.cuda.synchronize()
        if first is None:
            first = (a, a2)
        assert _same(a, first[0]) and _same(a2, first[1])
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_row(cache, row, pos, cache2, cache[..., 0])
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_row(cache, row, pos, cache, row2)
