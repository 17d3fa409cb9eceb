"""K6/K9's split partition: the port's plain twins, split at ``split_k``
and merged in split order as the CUDA kernel does, against the Pallas
kernels in interpret mode (one sweep over the cache axis), over caches
long enough for at least three splits.

Tolerances (those of tests/test_torch_decode.py): f32 caches rtol 1e-5
(the merge changes only the summation order), bf16 and int8 caches rtol
2e-2 / atol 2e-2 (p is rounded to bf16 against its split's running max,
not the row's). A cache no longer than one split gives the single
sweep's bits, and a row's bits do not depend on T or on the other rows.
"""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.pallas import decode as jdec
from rlo_tpu_torch.convert import from_numpy
from rlo_tpu_torch.kernels import decode as kd

B, NH, D = 3, 8, 16
S = kd.SPLIT_K
L = 3 * S + 40                       # four splits at S, seven at 128
SPLITS = [128, S]
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=2e-2, atol=2e-2),
       "int8": dict(rtol=2e-2, atol=2e-2)}


def _quant(x, axis):
    """x -> int8 + f32 scales per position (amax over ``axis``, hd)."""
    s = np.maximum(np.abs(x).max(axis), 1e-30).astype(np.float32) / 127
    q = np.round(x / np.expand_dims(s, axis)).astype(np.int8)
    return q, s.astype(np.float32)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _values(shape, kind, rng, axis):
    """(values, scales or None) of ``kind`` for a cache or pool whose hd
    axis is ``axis``."""
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "int8":
        return _quant(x, axis)
    return (_bf16(x) if kind == "bf16" else x), None


def _positions(pos, T, length):
    """Scalar: the last query at the end; ragged: one past max_len (a
    retired slot), one row over two splits, one inside the first."""
    if pos == "scalar":
        return np.int32(length - T)
    return np.array([length + 1, min(300, length - T), 5], np.int32)


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode())


def _t(x):
    return None if x is None else from_numpy([x], "cpu")[0]


@functools.lru_cache(maxsize=None)
def _dense_case(kind, T, group, pos):
    rng = np.random.default_rng(_seed(kind, T, group, pos))
    nkv = NH // group
    q = rng.standard_normal((B, T, NH, D)).astype(np.float32)
    if kind != "f32":
        q = _bf16(q)
    kc, ks = _values((B, nkv, D, L), kind, rng, 2)
    vc, vs = _values((B, nkv, D, L), kind, rng, 2)
    p = _positions(pos, T, L)
    jargs = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    want = np.asarray(jdec.flash_block_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(p),
        0.25, jargs[0], jargs[1], block_k=128, interpret=True), np.float32)
    return (q, kc, vc, p, ks, vs), want


def _dense(args, split_k, **kw):
    q, kc, vc, p, ks, vs = args
    return kd.flash_block_decode_plain(
        _t(q), _t(kc), _t(vc), torch.as_tensor(p), 0.25, _t(ks), _t(vs),
        split_k=split_k, **kw)


@pytest.mark.parametrize("split_k", SPLITS)
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("pos", ["scalar", "ragged"])
def test_split_plain_matches_pallas_interpret(split_k, kind, T, group, pos):
    args, want = _dense_case(kind, T, group, pos)
    got = _dense(args, split_k).numpy()
    assert got.shape == (B, T, NH, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[kind])


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4, 128])
def test_split_matches_single_sweep(kind, T):
    """SPLIT_K against one sweep (``split_k=None``), within the same
    tolerances; the wrapper's CPU path is the split twin."""
    args, _ = _dense_case(kind, T, 4, "ragged")
    split = _dense(args, S)
    np.testing.assert_allclose(split.numpy(), _dense(args, None).numpy(),
                               **TOL[kind])
    q, kc, vc, p, ks, vs = args
    wrapped = kd.flash_block_decode(_t(q), _t(kc), _t(vc), torch.as_tensor(p),
                                    0.25, _t(ks), _t(vs))
    assert torch.equal(wrapped, split)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("length", [40, S])
def test_one_split_gives_the_single_sweep_bits(kind, length):
    args, _ = _dense_case(kind, 4, 1, "ragged")
    q, kc, vc, p, ks, vs = args
    cut = (q, kc[..., :length], vc[..., :length], np.minimum(p, length - 4),
           None if ks is None else ks[..., :length].copy(),
           None if vs is None else vs[..., :length].copy())
    cut = tuple(None if a is None else np.ascontiguousarray(a) for a in cut)
    assert torch.equal(_dense(cut, S), _dense(cut, None))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("split_k", SPLITS)
def test_dead_splits_add_nothing(kind, split_k):
    """A row whose positions lie in the first split: its bits on the
    long cache (the later splits merged in, each adding exactly 0) equal
    its bits on the cache cut to that split (no merge at all)."""
    args, _ = _dense_case(kind, 4, 4, "ragged")
    q, kc, vc, p, ks, vs = args
    assert p[2] + 4 <= split_k
    cut = tuple(None if a is None else np.ascontiguousarray(a[..., :split_k])
                for a in (kc, vc, ks, vs))
    long = _dense(args, split_k)
    short = _dense((q, cut[0], cut[1], np.minimum(p, split_k - 4), cut[2],
                    cut[3]), split_k)
    assert torch.equal(long[2], short[2])
    assert not torch.equal(long[0], short[0])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_strided_q_gives_its_copy_bits(kind):
    """q as a strided view of a projection-like tensor (the decode
    step's layout) and its contiguous copy give the same bits."""
    args, _ = _dense_case(kind, 4, 1, "ragged")
    q, kc, vc, p, ks, vs = args
    proj = torch.zeros(B, 4, 3 * NH * D, dtype=_t(q).dtype)
    proj[..., NH * D:2 * NH * D] = _t(q).reshape(B, 4, NH * D)
    view = proj[..., NH * D:2 * NH * D].reshape(B, 4, NH, D)
    assert not view.is_contiguous()
    got = kd.flash_block_decode(view, _t(kc), _t(vc), torch.as_tensor(p),
                                0.25)
    want = kd.flash_block_decode(view.contiguous(), _t(kc), _t(vc),
                                 torch.as_tensor(p), 0.25)
    assert torch.equal(got, want)


def test_split_k_must_be_a_multiple_of_the_tile():
    args, _ = _dense_case("f32", 1, 1, "scalar")
    for bad in (0, 96, -128):
        with pytest.raises(ValueError, match="split_k"):
            _dense(args, bad)
    with pytest.raises(ValueError, match="split_k"):
        _dense(args, 256, block_k=96)


# ---------------------------------------------------------------------------
# K9: the same partition over logical positions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _paged_case(kind, ps, T, group):
    rng = np.random.default_rng(_seed(kind, ps, T, group))
    nkv = NH // group
    mp = -(-L // ps)
    P = B * mp + 1
    q = rng.standard_normal((B, T, NH, D)).astype(np.float32)
    if kind != "f32":
        q = _bf16(q)
    kp, ks = _values((P, nkv, D, ps), kind, rng, 2)
    vp, vs = _values((P, nkv, D, ps), kind, rng, 2)
    table = (rng.permutation(P - 1) + 1).astype(np.int32).reshape(B, mp)
    table[1, mp // 2:] = 0                  # unmapped tail: the null page
    p = np.array([mp * ps - T, (mp // 2) * ps - T, 5], np.int32)
    jargs = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    want = np.asarray(jdec.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(p), 0.25, jargs[0], jargs[1], interpret=True),
        np.float32)
    return (q, kp, vp, table, p, ks, vs), want


def _paged(args, split_k):
    q, kp, vp, table, p, ks, vs = args
    return kd.paged_flash_decode_plain(
        _t(q), _t(kp), _t(vp), _t(table), torch.as_tensor(p), 0.25, _t(ks),
        _t(vs), split_k=split_k)


@pytest.mark.parametrize("split_k", SPLITS)
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("T,group", [(1, 1), (4, 4), (128, 1)])
def test_paged_split_plain_matches_pallas_interpret(split_k, kind, ps, T,
                                                    group):
    """The Pallas kernel tiles the logical axis at ps; the twin at
    BLOCK_K, split at ``split_k``."""
    args, want = _paged_case(kind, ps, T, group)
    got = _paged(args, split_k).numpy()
    assert got.shape == (B, T, NH, D) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[kind])


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ps", [16, 128])
def test_paged_split_equals_dense_split_on_the_gathered_cache(kind, ps):
    """K9's twin on pages equals K6's on the cache the table gathers, bit
    for bit, and the wrapper's CPU path is that twin."""
    args, _ = _paged_case(kind, ps, 4, 4)
    q, kp, vp, table, p, ks, vs = args
    tab = _t(table)
    dense = kd.flash_block_decode_plain(
        _t(q), kd.gather_pages(_t(kp), tab), kd.gather_pages(_t(vp), tab),
        torch.as_tensor(p), 0.25,
        None if ks is None else kd.gather_pages(_t(ks), tab),
        None if vs is None else kd.gather_pages(_t(vs), tab))
    paged = _paged(args, S)
    assert torch.equal(paged, dense)
    assert torch.equal(kd.paged_flash_decode(
        _t(q), _t(kp), _t(vp), tab, torch.as_tensor(p), 0.25, _t(ks),
        _t(vs)), paged)
