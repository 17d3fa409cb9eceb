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


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("pos0", [0, 126, 256, "ragged"])
def test_write_block_matches_pallas(dtype, pos0):
    L, T = 384, 5
    cache = _cache(L, dtype, seed=41)
    rows = _cache(T, dtype, seed=42)
    pos0 = np.array([125, 0, L - T], np.int32) if pos0 == "ragged" \
        else np.int32(pos0)
    want = np.asarray(jdec.write_kv_block(
        jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(pos0),
        interpret=True))
    tc, tr = from_numpy([cache, rows], "cpu")
    assert kd.write_kv_block(tc, tr, torch.as_tensor(pos0)) is tc
    np.testing.assert_array_equal(to_numpy([tc])[0], want)


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
        kd._lib_fn("rlo_write_kv_row", [])
