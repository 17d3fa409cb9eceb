"""K6 (flash decode) and the cache writes K7/K8: the port's plain
versions against the Pallas kernels in interpret mode (as
tests/test_flash_decode.py runs them), and the CUDA kernels against the
plain versions on the card.

K6 compares like with like: the port's plain twin runs the kernel's tile
loop at the same tile width as the Pallas call, with the same roundings
(q and the probabilities to bf16 for bf16 and int8 caches). Tolerances:
f32 caches rtol 1e-5 (summation order only), bf16 and int8 caches
rtol 2e-2 / atol 2e-2 (an exp that differs in its last bit can move a
probability across a bf16 rounding boundary). K7/K8 are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.pallas import decode as jdec
from rlo_tpu_torch.convert import from_numpy, to_numpy
from rlo_tpu_torch.kernels import build
from rlo_tpu_torch.kernels import decode as kd

B, NH, NKV, D = 3, 8, 4, 16


def _quant(x):
    """Seq-minor (b, g, d, L) -> int8 + (b, g, L) scales, per position."""
    xf = np.moveaxis(x, 2, 3)
    s = np.maximum(np.abs(xf).max(-1), 1e-30).astype(np.float32) / 127
    q = np.round(xf / s[..., None]).astype(np.int8)
    return np.ascontiguousarray(np.moveaxis(q, 3, 2)), s.astype(np.float32)


def _case(T, L, kind, seed, nkv=NKV):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, NH, D)).astype(np.float32)
    kc = rng.standard_normal((B, nkv, D, L)).astype(np.float32)
    vc = rng.standard_normal((B, nkv, D, L)).astype(np.float32)
    ks = vs = None
    if kind == "bf16":
        q, kc, vc = (np.asarray(jnp.asarray(x, jnp.bfloat16))
                     for x in (q, kc, vc))
    elif kind == "int8":
        kc, ks = _quant(kc)
        vc, vs = _quant(vc)
    return q, kc, vc, ks, vs


def _jax(args, pos, scale, block_k):
    q, kc, vc, ks, vs = args
    j = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    return np.asarray(jdec.flash_block_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        scale, j[0], j[1], block_k=block_k, interpret=True), np.float32)


def _port(args, pos, scale, block_k=None):
    ts = [None if a is None else from_numpy([a], "cpu")[0] for a in args]
    p = torch.as_tensor(np.asarray(pos, np.int32))
    if block_k is None:
        return kd.flash_block_decode(ts[0], ts[1], ts[2], p, scale,
                                     ts[3], ts[4]).numpy()
    return kd.flash_block_decode_plain(ts[0], ts[1], ts[2], p, scale,
                                       ts[3], ts[4], block_k=block_k).numpy()


TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=2e-2, atol=2e-2),
       "int8": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
def test_plain_matches_pallas_interpret(kind, T, ragged):
    L = 48
    args = _case(T, L, kind, seed=T + 3 * ragged)
    pos = np.array([0, L - T, 17], np.int32) if ragged else np.int32(21)
    want = _jax(args, pos, 0.25, block_k=16)
    got = _port(args, pos, 0.25, block_k=16)
    assert got.shape == (B, T, NH, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[kind])


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_padded_tail_tile(kind):
    """A tile width that does not divide L: the tail tile is short and
    positions past L never reach the accumulator."""
    args = _case(2, 48, kind, seed=9)
    want = _jax(args, np.int32(40), 0.3, block_k=32)
    got = _port(args, np.int32(40), 0.3, block_k=32)
    np.testing.assert_allclose(got, want, **TOL[kind])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_wrapper_tile_matches_pallas_at_its_tile(kind):
    """The wrapper's CPU path at the kernel's own tile (BLOCK_K) against
    the Pallas kernel cut at the same width (GQA group 4, a short tail
    tile)."""
    L = 2 * kd.BLOCK_K + 40
    args = _case(3, L, kind, seed=2, nkv=2)
    pos = np.array([5, L - 3, 130], np.int32)
    want = _jax(args, pos, 0.25, block_k=kd.BLOCK_K)
    np.testing.assert_allclose(_port(args, pos, 0.25), want, **TOL[kind])


def test_T1_equals_block_at_T1():
    args = _case(1, 48, "bf16", seed=4)
    ts = [None if a is None else from_numpy([a], "cpu")[0] for a in args]
    a = kd.flash_decode(ts[0], ts[1], ts[2], 13, 0.25)
    b = kd.flash_block_decode(ts[0], ts[1], ts[2], 13, 0.25)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="one query"):
        kd.flash_decode(torch.zeros(B, 2, NH, D), ts[1], ts[2], 13, 0.25)


def _cache(L, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        c = rng.integers(-127, 127, (B, NKV, D, L)).astype(np.int8)
    else:
        c = rng.standard_normal((B, NKV, D, L)).astype(np.float32)
    return c


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("L", [256, 384])
@pytest.mark.parametrize("pos", [0, 129, "ragged"])
def test_write_row_matches_pallas(dtype, L, pos):
    cache = _cache(L, dtype, seed=L)
    row = _cache(1, dtype, seed=L + 1)[..., 0]
    pos = np.array([0, L - 1, 131], np.int32) if pos == "ragged" \
        else np.int32(pos)
    want = np.asarray(jdec.write_kv_row(jnp.asarray(cache), jnp.asarray(row),
                                        jnp.asarray(pos), interpret=True))
    tc, tr = from_numpy([cache, row], "cpu")
    out = kd.write_kv_row(tc, tr, torch.as_tensor(pos))
    assert out is tc                               # in place
    np.testing.assert_array_equal(to_numpy([tc])[0], want)


def test_write_row_out_of_range_is_dropped():
    """Retired serving slots run past max_len: such a write changes
    nothing (the Pallas kernel drops it too)."""
    cache = _cache(256, "f32", seed=31)
    row = _cache(1, "f32", seed=32)[..., 0]
    pos = np.array([256, 300, 10_000], np.int32)
    want = np.asarray(jdec.write_kv_row(jnp.asarray(cache), jnp.asarray(row),
                                        jnp.asarray(pos), interpret=True))
    tc, tr = from_numpy([cache, row], "cpu")
    kd.write_kv_row(tc, tr, torch.as_tensor(pos))
    np.testing.assert_array_equal(tc.numpy(), cache)
    np.testing.assert_array_equal(want, cache)
    # a scalar position past the end is dropped as well (the JAX
    # package's off-TPU scalar path would clamp it into column L-1)
    kd.write_kv_row(tc, tr, 256)
    np.testing.assert_array_equal(tc.numpy(), cache)


def _proj_rows(b, nkv, hd, dtype, seed):
    """k and v rows (b, kvh, hd) as the decode step hands them to K7:
    k[:, 0] and v[:, 0] of one (b, 1, 3 * kvh * hd) projection output (hd
    contiguous, batch rows 3 * kvh * hd apart); their numpy copies beside
    them."""
    rng = np.random.default_rng(seed)
    w = nkv * hd
    proj = (rng.integers(-127, 127, (b, 1, 3 * w)).astype(np.int8)
            if dtype == "int8"
            else rng.standard_normal((b, 1, 3 * w)).astype(np.float32))
    t = torch.from_numpy(proj)
    views = [t[:, 0, a:a + w].reshape(b, nkv, hd) for a in (w, 2 * w)]
    assert not views[0].is_contiguous()
    return views, [np.ascontiguousarray(x.numpy()) for x in views]


def _jax_rows(caches, rows, pos):
    return [np.asarray(jdec.write_kv_row(jnp.asarray(c), jnp.asarray(r),
                                         jnp.asarray(pos), interpret=True))
            for c, r in zip(caches, rows)]


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("pos", ["shared", "per-row"])
def test_write_row_pair_matches_two_pallas_writes(dtype, pos):
    """K7's pair form from the decode step's views, k with v in one call
    (for int8 also the f32 scale sidecars' pair at hd 1, through their
    (b, kvh, 1, L) views), bit-equal to two calls of the Pallas kernel on
    the same inputs; the wrapper's CPU path is the plain version."""
    L = 256
    p = np.int32(129) if pos == "shared" else np.array([0, L - 1, 131],
                                                        np.int32)
    caches = [_cache(L, dtype, seed=70 + i) for i in range(2)]
    views, rows = _proj_rows(B, NKV, D, dtype, 72)
    pairs = [(caches, views, rows)]
    if dtype == "int8":
        rng = np.random.default_rng(74)
        scales = [rng.random((B, NKV, 1, L)).astype(np.float32)
                  for _ in range(2)]
        pairs.append((scales,) + _proj_rows(B, NKV, 1, "f32", 75))
    for dsts, views, rows in pairs:
        want = _jax_rows(dsts, rows, p)
        got = from_numpy(dsts, "cpu")
        wrapped = from_numpy(dsts, "cpu")
        if dsts[0].shape[2] == 1:           # the sidecars' (b, kvh, L)
            got = [g[:, :, 0] for g in got]
            wrapped = [g[:, :, 0] for g in wrapped]
            got4 = [g[:, :, None, :] for g in got]
            wr4 = [g[:, :, None, :] for g in wrapped]
        else:
            got4, wr4 = got, wrapped
        assert kd.write_kv_row_plain(got4[0], views[0], torch.as_tensor(p),
                                     got4[1], views[1]) is got4[0]
        kd.write_kv_row(wr4[0], views[0], torch.as_tensor(p), wr4[1],
                        views[1])
        for g, w, x in zip(got4, want, wr4):
            np.testing.assert_array_equal(g.numpy(), w)
            assert torch.equal(x, g)
        assert not np.array_equal(want[0], dsts[0])


def test_write_row_pair_drops_out_of_range_and_refuses_aliases():
    """The pair form drops positions outside [0, L), past the end and
    negative, shared or per row (the Quirk
    ``test_write_row_out_of_range_is_dropped`` pins); pairs that alias
    raise where K10's do."""
    L = 256
    caches = from_numpy([_cache(L, "f32", seed=80 + i) for i in range(2)],
                        "cpu")
    before = [c.clone() for c in caches]
    (kr, vr), _ = _proj_rows(B, NKV, D, "f32", 82)
    for pos in (torch.tensor([L, L + 7, -3], dtype=torch.int32), L, -1,
                torch.tensor(-128, dtype=torch.int32)):
        kd.write_kv_row(caches[0], kr, pos, caches[1], vr)
        for c, b in zip(caches, before):
            assert torch.equal(c, b)
    kd.write_kv_row(caches[0], kr, torch.tensor([-1, 5, L],
                                                dtype=torch.int32),
                    caches[1], vr)
    for c, b, r in zip(caches, before, (kr, vr)):
        b[1, :, :, 5] = r[1]
        assert torch.equal(c, b)
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_row(caches[0], kr, 5, caches[1], caches[0][:, :, :, 0])
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_row(caches[0], kr, 5, caches[0], vr)
    with pytest.raises(ValueError, match="match the first"):
        kd.write_kv_row(caches[0], kr, 5, caches[1], vr[:2])
    with pytest.raises(ValueError, match="both tensors"):
        kd.write_kv_row(caches[0], kr, 5, caches[1])


def _as_view(rows, pad=0):
    """(b, kvh, hd, T) rows as the callers hand them to K8: a permuted
    view of the k slice of a (b, T, 3 * kvh * hd) projection output (hd
    contiguous, tokens 3 * kvh * hd apart); ``pad`` 1 moves the slice one
    element on in a (b, T, 3 * kvh * hd + 1) tensor (the kernel's scalar
    route)."""
    b, nkv, d, T = rows.shape
    w = nkv * d
    proj = torch.zeros((b, T, 3 * w + pad), dtype=rows.dtype)
    proj[..., w + pad:2 * w + pad] = rows.permute(0, 3, 1, 2).reshape(b, T, w)
    view = proj[..., w + pad:2 * w + pad].reshape(b, T, nkv, d) \
        .permute(0, 2, 3, 1)
    assert view.stride(2) == 1 and not view.is_contiguous()
    return view


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("pos0", [0, 126, 256, "ragged"])
@pytest.mark.parametrize("layout", ["contiguous", "view", "misaligned"])
def test_write_block_matches_pallas(dtype, pos0, layout):
    L, T = 384, 5
    cache = _cache(L, dtype, seed=41)
    rows = _cache(T, dtype, seed=42)
    pos0 = np.array([125, 0, L - T], np.int32) if pos0 == "ragged" \
        else np.int32(pos0)
    want = np.asarray(jdec.write_kv_block(
        jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(pos0),
        interpret=True))
    tc, tr = from_numpy([cache, rows], "cpu")
    if layout != "contiguous":
        tr = _as_view(tr, int(layout == "misaligned"))
    assert kd.write_kv_block(tc, tr, torch.as_tensor(pos0)) is tc
    np.testing.assert_array_equal(to_numpy([tc])[0], want)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_write_block_pair_equals_two_single_writes(dtype):
    """The pair form (k with v; for int8 also the scale sidecars' pair
    through their (b, kvh, 1, L) views) writes what two single calls
    write; pairs that alias raise."""
    L, T = 256, 9
    pos = torch.tensor([250, 0, 100], dtype=torch.int32)
    if dtype == "int8":
        k, v, kr, vr = from_numpy([_cache(n, "int8", seed=60 + i)
                                   for i, n in enumerate((L, L, T, T))],
                                  "cpu")
        rng = np.random.default_rng(64)
        ks, vs = from_numpy([rng.random((B, NKV, n)).astype(np.float32)
                             for n in (L, L)], "cpu")
        ksr, vsr = (torch.from_numpy(rng.random((B, T, NKV))
                                     .astype(np.float32)).transpose(1, 2)
                    for _ in range(2))
    else:
        k, v, kr, vr = (t.to(torch.bfloat16) for t in from_numpy(
            [_cache(n, "f32", seed=60 + i)
             for i, n in enumerate((L, L, T, T))], "cpu"))
    kr, vr = _as_view(kr), _as_view(vr)
    got = [k.clone(), v.clone()]
    want = [k.clone(), v.clone()]
    kd.write_kv_block(got[0], kr, pos, got[1], vr)
    kd.write_kv_block(want[0], kr, pos)
    kd.write_kv_block(want[1], vr, pos)
    if dtype == "int8":
        got += [ks.clone(), vs.clone()]
        want += [ks.clone(), vs.clone()]
        kd.write_kv_block(got[2][:, :, None, :], ksr[:, :, None, :], pos,
                          got[3][:, :, None, :], vsr[:, :, None, :])
        kd.write_kv_block(want[2][:, :, None, :], ksr[:, :, None, :], pos)
        kd.write_kv_block(want[3][:, :, None, :], vsr[:, :, None, :], pos)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], k)
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_block(got[0], kr, pos, got[1], got[0][..., :T])
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_block(got[0], kr, pos, got[0], vr)
    with pytest.raises(ValueError, match="both tensors"):
        kd.write_kv_block(got[0], kr, pos, got[1])


def test_write_block_drops_columns_past_the_end():
    cache = _cache(256, "f32", seed=51)
    rows = _cache(8, "f32", seed=52)
    tc, tr = from_numpy([cache, rows], "cpu")
    kd.write_kv_block(tc, tr, torch.tensor([252, 256, 0], dtype=torch.int32))
    want = cache.copy()
    want[0, :, :, 252:] = rows[0, :, :, :4]
    want[2, :, :, :8] = rows[2]
    np.testing.assert_array_equal(tc.numpy(), want)
    with pytest.raises(ValueError, match="T <= 128"):
        kd.write_kv_block(torch.zeros(1, 1, 1, 512),
                          torch.zeros(1, 1, 1, 129), 0)


def test_no_fallback_off_cpu():
    c = torch.zeros(B, NKV, D, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kd.write_kv_row(c, torch.zeros(B, NKV, D, device="meta"), 0)
    q = torch.zeros(B, 1, NH, D, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kd.flash_block_decode(q, c, c, 0, 1.0)
    assert kd.write_kv_row.launches == 0
    assert kd.flash_block_decode.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(kd, "_fns", {})
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load("decode")
    with pytest.raises(build.KernelBuildError):
        kd._lib_fn("rlo_write_kv_rows", [])
