"""The paged serving path of the port against the JAX package on the CPU:
the page writes K10/K11 and paged decode K9 (plain versions against the
Pallas kernels in interpret mode), ``models/paged.py`` against
``rlo_tpu/models/paged.py``, the paged ``DecodeServer`` against the JAX
paged server and the port's own ``generate``, and the fabric's
kill-mid-decode run over the port's ``ModelBackend``. Card-only cases
(the CUDA kernels against their plain versions) are marked ``gpu``.

Tolerances: K10/K11 exact. K9 f32 rtol 1e-5 / atol 1e-6 (summation order
only); bf16 and int8 pools rtol/atol 2e-2 (an exp that differs in its
last bit can move a probability across a bf16 rounding boundary; the
classes of test_torch_decode.py). Paged decode and prefill logits rtol
1e-5 against the JAX functions (f32 tiny config). Served tokens exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.models import paged as jpaged
from rlo_tpu.models import serve as js
from rlo_tpu.models import transformer as jt
from rlo_tpu.pallas import decode as jdec
from rlo_tpu.utils.metrics import Registry as JaxRegistry
from rlo_tpu_torch.convert import (cache_from_numpy, cache_to_numpy,
                                   from_numpy, params_from_numpy)
from rlo_tpu_torch.kernels import decode as kd
from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import paged as tpaged
from rlo_tpu_torch.models import serve as ts
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.serving.backend import ModelBackend
from rlo_tpu_torch.utils.metrics import Registry

KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          dtype="float32")
VARIANTS = {"mha": {}, "gqa_rope": dict(n_kv_heads=2, pos_encoding="rope"),
            "int8": dict(kv_cache_dtype="int8")}
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=2e-2, atol=2e-2),
       "int8": dict(rtol=2e-2, atol=2e-2)}


def _model(variant, seed=0):
    jc = jt.TransformerConfig(**KW, **VARIANTS[variant])
    tc = tt.TransformerConfig(**KW, **VARIANTS[variant])
    jp = jt.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def mha():
    return _model("mha")


def _generate(tp, tc, prompt, max_new):
    return tg.generate(tp, torch.as_tensor(np.asarray(prompt)[None],
                                           dtype=torch.int32),
                       tc, max_new=max_new)[0].numpy()


def _tensor(x):
    return from_numpy([x], "cpu")[0]


def _values(shape, kind, rng):
    """Random values of ``kind`` (f32, bf16 as ml_dtypes, int8)."""
    if kind == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16)) if kind == "bf16" else x


# ---------------------------------------------------------------------------
# K10 / K11: the page writes (exact)
# ---------------------------------------------------------------------------

def _row_view(row):
    """(b, kvh, hd) rows as ``paged_decode_step`` hands them to K10:
    ``k[:, 0]`` of the k slice of a (b, 1, 3 * kvh * hd) projection output
    (hd contiguous, batch rows 3 * kvh * hd apart)."""
    b, nkv, d = row.shape
    w = nkv * d
    proj = torch.zeros((b, 1, 3 * w), dtype=row.dtype)
    proj[:, 0, w:2 * w] = row.reshape(b, w)
    view = proj[..., w:2 * w].reshape(b, 1, nkv, d)[:, 0]
    assert view.stride() == (3 * w, d, 1) and not view.is_contiguous()
    return view


@pytest.mark.parametrize("layout", ["contiguous", "view"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "scales"])
@pytest.mark.parametrize("ps", [8, 128])
def test_page_row_write_matches_pallas(kind, ps, layout):
    """Lanes inside the page, off = ps (the drop sentinel), a negative
    off, and a page index past the pool (clamped to P - 1); rows
    contiguous or as the decode step's strided ``k[:, 0]`` view. No two
    rows write one page (the copy-on-write invariant the Pallas kernel
    relies on: a revisited page block rereads the pool as it was)."""
    rng = np.random.default_rng(ps)
    P, nkv, d, b = 6, 2, 16, 5
    if kind == "scales":   # the f32 scale pools' (P, kvh, 1, ps) view
        pool = rng.standard_normal((P, nkv, 1, ps)).astype(np.float32)
        row = rng.standard_normal((b, nkv, 1)).astype(np.float32)
    else:
        pool, row = _values((P, nkv, d, ps), kind, rng), \
            _values((b, nkv, d), kind, rng)
    page = np.array([2, 0, 4, 3, P + 4], np.int32)
    off = np.array([ps - 1, ps, 3, -1, 1], np.int32)
    want = np.asarray(jdec.write_kv_page_row(
        jnp.asarray(pool), jnp.asarray(row), jnp.asarray(page),
        jnp.asarray(off), interpret=True))
    tp, tr = _tensor(pool), _tensor(row)
    if layout == "view":
        tr = _row_view(tr)
    assert kd.write_kv_page_row(tp, tr, torch.as_tensor(page),
                                torch.as_tensor(off)) is tp     # in place
    got = np.asarray(cache_to_numpy([{"k": tp}])[0]["k"])
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert not np.array_equal(got.view(np.uint8), pool.view(np.uint8))


def test_page_row_write_two_rows_on_one_page():
    """Outside the copy-on-write invariant (two rows writing one page)
    the port writes both rows; the Pallas kernel rereads the page as it
    was for the second row and keeps only the second write."""
    pool = np.zeros((4, 1, 2, 8), np.float32)
    row = np.arange(1, 5, dtype=np.float32).reshape(2, 1, 2)
    page, off = np.array([2, 2], np.int32), np.array([1, 5], np.int32)
    want = np.asarray(jdec.write_kv_page_row(
        jnp.asarray(pool), jnp.asarray(row), jnp.asarray(page),
        jnp.asarray(off), interpret=True))
    got = kd.write_kv_page_row(_tensor(pool), _tensor(row),
                               torch.as_tensor(page),
                               torch.as_tensor(off)).numpy()
    np.testing.assert_array_equal(got[2, 0, :, 1], row[0, 0])
    np.testing.assert_array_equal(got[2, 0, :, 5], row[1, 0])
    np.testing.assert_array_equal(want[2, 0, :, 1], [0, 0])
    np.testing.assert_array_equal(want[2, 0, :, 5], row[1, 0])


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_page_row_write_pair_equals_two_single_writes(kind):
    """K10's pair form (k with v from the decode step's views; for int8
    also the scale pools' pair through their (P, kvh, 1, ps) views)
    writes what two single calls write; pairs that alias raise."""
    rng = np.random.default_rng(13)
    P, nkv, d, ps, b = 6, 2, 16, 32, 5
    k, v = (_tensor(_values((P, nkv, d, ps), kind, rng)) for _ in range(2))
    kr, vr = (_row_view(_tensor(_values((b, nkv, d), kind, rng)))
              for _ in range(2))
    page = torch.tensor([2, 0, 4, 3, P + 4], dtype=torch.int32)
    off = torch.tensor([ps - 1, ps, 3, -1, 1], dtype=torch.int32)
    got, want = [k.clone(), v.clone()], [k.clone(), v.clone()]
    kd.write_kv_page_row(got[0], kr, page, off, got[1], vr)
    kd.write_kv_page_row(want[0], kr, page, off)
    kd.write_kv_page_row(want[1], vr, page, off)
    if kind == "int8":
        ks, vs = (_tensor(_values((P, nkv, ps), "f32", rng))
                  for _ in range(2))
        # (b, kvh) scale rows as the decode step makes them, as (b, kvh, 1)
        ksr, vsr = (_tensor(_values((b, nkv), "f32", rng))[:, :, None]
                    for _ in range(2))
        got += [ks.clone(), vs.clone()]
        want += [ks.clone(), vs.clone()]
        kd.write_kv_page_row(got[2][:, :, None, :], ksr, page, off,
                             got[3][:, :, None, :], vsr)
        kd.write_kv_page_row(want[2][:, :, None, :], ksr, page, off)
        kd.write_kv_page_row(want[3][:, :, None, :], vsr, page, off)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], k) and not torch.equal(got[1], v)
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_page_row(got[0], kr, page, off, got[1],
                             got[0][:b, :, :, 0])
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_page_row(got[0], kr, page, off, got[0], vr)
    with pytest.raises(ValueError, match="match the first"):
        kd.write_kv_page_row(got[0], kr, page, off, got[1], vr[:2])
    with pytest.raises(ValueError, match="both tensors"):
        kd.write_kv_page_row(got[0], kr, page, off, got[1])


@pytest.mark.parametrize("variant", ["mha", "int8"])
def test_paged_write_rows_takes_one_call_per_pair(variant, monkeypatch):
    """The decode step's write passes k with v (and the int8 scales) as
    pairs: one K10 call for a bf16/f32 layer, two for an int8 one, each
    pair from the same page and off."""
    calls = []

    def counting(pool, row, page, off, pool2=None, row2=None):
        calls.append((pool2 is not None, row.is_contiguous()))
        return kd.write_kv_page_row(pool, row, page, off, pool2, row2)

    monkeypatch.setattr(tpaged, "write_kv_page_row", counting)
    jc, tc, jp, tp = _model(variant)
    pools = tpaged.init_page_pool(tc, 6, 8, device="cpu")
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    tpaged.paged_decode_step(tp, torch.tensor([3, 5], dtype=torch.int32),
                             torch.tensor([0, 9], dtype=torch.int32), pools,
                             table, torch.tensor([True, True]), tc)
    per_layer = 2 if variant == "int8" else 1
    assert len(calls) == per_layer * KW["n_layers"]
    assert all(pair for pair, _ in calls)
    if variant == "mha":    # the k, v rows are the projection's views
        assert not any(contiguous for _, contiguous in calls)


def _as_view(rows, pad=0):
    """(kvh, hd, T) rows as ``paged_prefill_chunk`` hands them to K11: a
    permuted view of the k slice of a (T, 3 * kvh * hd) projection output
    (hd contiguous, tokens 3 * kvh * hd apart); ``pad`` 1 moves the slice
    one element on in a (T, 3 * kvh * hd + 1) tensor (the kernel's scalar
    route)."""
    nkv, d, T = rows.shape
    w = nkv * d
    proj = torch.zeros((T, 3 * w + pad), dtype=rows.dtype)
    proj[:, w + pad:2 * w + pad] = rows.permute(2, 0, 1).reshape(T, w)
    view = proj[:, w + pad:2 * w + pad].reshape(T, nkv, d).permute(1, 2, 0)
    assert view.stride(1) == 1 and not view.is_contiguous()
    return view


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", ["pads", "page_edge", "short", "past_pool",
                                  "negative_off"])
@pytest.mark.parametrize("layout", ["contiguous", "view", "misaligned"])
def test_page_block_write_matches_pallas(kind, case, layout):
    """A chunk with pads past n_valid, one that ends at the page edge, a
    short one, a page index past the pool, and a negative start (only
    the lanes inside the page are written); rows contiguous, as the
    caller's view, or that view one element off."""
    rng = np.random.default_rng(7)
    P, nkv, d, ps = 6, 2, 16, 32
    T, page, off0, nv = {"pads": (16, 4, 9, 11),
                         "page_edge": (8, 2, ps - 8, 8),
                         "short": (32, 1, 0, 5),
                         "past_pool": (4, P + 2, 20, 4),
                         "negative_off": (8, 3, -3, 8)}[case]
    pool = _values((P, nkv, d, ps), kind, rng)
    rows = _values((nkv, d, T), kind, rng)
    want = np.asarray(jdec.write_kv_page_block(
        jnp.asarray(pool), jnp.asarray(rows), page, off0, nv,
        interpret=True))
    tr = _tensor(rows)
    if layout != "contiguous":
        tr = _as_view(tr, int(layout == "misaligned"))
    tp = _tensor(pool)
    assert kd.write_kv_page_block(tp, tr, page, off0, nv) is tp
    got = np.asarray(cache_to_numpy([{"k": tp}])[0]["k"])
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    # device-tensor scalars give the same write
    tp2 = _tensor(pool)
    kd.write_kv_page_block(tp2, tr,
                           *(torch.tensor([x], dtype=torch.int32)
                             for x in (page, off0, nv)))
    assert torch.equal(tp2, tp)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_page_block_write_pair_equals_two_single_writes(kind):
    """The pair form (k with v; for int8 also the scale pools' pair
    through their (P, kvh, 1, ps) views) writes what two single calls
    write; pairs that alias raise."""
    rng = np.random.default_rng(11)
    P, nkv, d, ps, T = 6, 2, 16, 32, 20
    k, v = (_tensor(_values((P, nkv, d, ps), kind, rng)) for _ in range(2))
    kr, vr = (_as_view(_tensor(_values((nkv, d, T), kind, rng)))
              for _ in range(2))
    args = (3, 9, 17)                      # page, off0, n_valid (pads)
    got, want = [k.clone(), v.clone()], [k.clone(), v.clone()]
    kd.write_kv_page_block(got[0], kr, *args, got[1], vr)
    kd.write_kv_page_block(want[0], kr, *args)
    kd.write_kv_page_block(want[1], vr, *args)
    if kind == "int8":
        ks, vs = (_tensor(_values((P, nkv, ps), "f32", rng))
                  for _ in range(2))
        # (kvh, T) sidecar rows as the caller takes them: (1, T, kvh)[0].t()
        ksr, vsr = (_tensor(_values((1, T, nkv), "f32", rng))[0].t()
                    for _ in range(2))
        got += [ks.clone(), vs.clone()]
        want += [ks.clone(), vs.clone()]
        kd.write_kv_page_block(got[2][:, :, None, :], ksr[:, None, :],
                               *args, got[3][:, :, None, :],
                               vsr[:, None, :])
        kd.write_kv_page_block(want[2][:, :, None, :], ksr[:, None, :],
                               *args)
        kd.write_kv_page_block(want[3][:, :, None, :], vsr[:, None, :],
                               *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], k)
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_page_block(got[0], kr, *args, got[1], got[0][1, ..., :T])
    with pytest.raises(ValueError, match="alias"):
        kd.write_kv_page_block(got[0], kr, *args, got[0], vr)
    with pytest.raises(ValueError, match="match the first"):
        kd.write_kv_page_block(got[0], kr, *args, got[1], vr[..., :4])


def test_page_block_write_rejects_a_chunk_wider_than_a_page():
    with pytest.raises(ValueError, match="exceeds page size"):
        kd.write_kv_page_block(torch.zeros(3, 1, 4, 8),
                               torch.zeros(1, 4, 9), 1, 0, 9)


# ---------------------------------------------------------------------------
# K9: paged decode attention
# ---------------------------------------------------------------------------

def _quant_pool(x):
    """(P, g, d, ps) f32 -> int8 pool + (P, g, ps) scales, per position."""
    xf = np.moveaxis(x, 2, 3)
    s = np.maximum(np.abs(xf).max(-1), 1e-30).astype(np.float32) / 127
    q = np.round(xf / s[..., None]).astype(np.int8)
    return np.ascontiguousarray(np.moveaxis(q, 3, 2)), s.astype(np.float32)


def _paged_case(kind, ps, T, nkv, seed, P=7, b=3, mp=5, nh=4, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, T, nh, d)).astype(np.float32)
    kp = rng.standard_normal((P, nkv, d, ps)).astype(np.float32)
    vp = rng.standard_normal((P, nkv, d, ps)).astype(np.float32)
    ks = vs = None
    if kind == "bf16":
        q, kp, vp = (np.asarray(jnp.asarray(x, jnp.bfloat16))
                     for x in (q, kp, vp))
    elif kind == "int8":
        kp, ks = _quant_pool(kp)
        vp, vs = _quant_pool(vp)
    table = rng.integers(1, P, (b, mp)).astype(np.int32)
    table[1, 2:] = 0                      # unmapped tail: the null page
    L = mp * ps
    pos0 = np.array([L - T, 2 * ps - T + 1, ps // 2], np.int32)[:b]
    return q, kp, vp, table, pos0, ks, vs


def _jax_paged(args, scale):
    q, kp, vp, table, pos0, ks, vs = args
    js_ = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    return np.asarray(jdec.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos0), scale, js_[0], js_[1], interpret=True),
        np.float32)


def _port_paged(args, scale, block_k=None):
    t = [None if a is None else _tensor(a) for a in args]
    if block_k is None:   # the wrapper: on CPU tensors, the plain version
        return kd.paged_flash_decode(t[0], t[1], t[2], t[3], t[4], scale,
                                     t[5], t[6]).numpy()
    return kd.paged_flash_decode_plain(t[0], t[1], t[2], t[3], t[4], scale,
                                       t[5], t[6], block_k=block_k).numpy()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("nkv", [4, 2], ids=["group1", "group2"])
@pytest.mark.parametrize("ps", [8, 128])
def test_paged_plain_matches_pallas_interpret(kind, T, nkv, ps):
    """The Pallas kernel tiles the cache axis at ps; the port's plain
    version is run at the same tile width (the wrapper's own BLOCK_K
    when ps = 128)."""
    args = _paged_case(kind, ps, T, nkv, seed=T + nkv + ps)
    want = _jax_paged(args, 0.25)
    got = _port_paged(args, 0.25, block_k=None if ps == kd.BLOCK_K else ps)
    assert got.shape == args[0].shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[kind])


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ps", [8, 32, 128])
def test_paged_on_gathered_pages_equals_dense(kind, ps):
    """A dense cache's columns scattered into permuted pages: K9's plain
    version (BLOCK_K tiles over the logical axis) equals K6's on the
    dense cache bit for bit, and ``paged_view`` gives the dense cache
    back."""
    rng = np.random.default_rng(ps)
    b, nkv, nh, d, mp = 3, 2, 4, 16, 4
    L = mp * ps
    k = rng.standard_normal((b, nkv, d, L)).astype(np.float32)
    v = rng.standard_normal((b, nkv, d, L)).astype(np.float32)
    ks = vs = None
    if kind == "int8":
        (k, ks), (v, vs) = (_quant_pool(x) for x in (k, v))
    elif kind == "bf16":
        k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (k, v))
    P = b * mp + 1
    table = (rng.permutation(P - 1) + 1).astype(np.int32).reshape(b, mp)

    def pool_of(x):
        out = np.zeros((P,) + x.shape[1:-1] + (ps,), x.dtype)
        for bi in range(b):
            for i in range(mp):
                out[table[bi, i]] = x[bi, ..., i * ps:(i + 1) * ps]
        return out

    entry = cache_from_numpy([{"k": pool_of(k), "v": pool_of(v)}
                              | ({} if ks is None else
                                 {"ks": pool_of(ks), "vs": pool_of(vs)})],
                             "cpu")[0]
    tab = torch.as_tensor(table)
    dense = cache_from_numpy([{"k": k, "v": v}], "cpu")[0]
    kg, vg, ksg, vsg = tpaged.paged_view(entry, tab)
    assert torch.equal(kg, dense["k"]) and torch.equal(vg, dense["v"])
    # pages_from_dense builds the same pools, a shorter cache zero-padded
    full = cache_from_numpy([{"k": k, "v": v} | ({} if ks is None else
                                                 {"ks": ks, "vs": vs})],
                            "cpu")
    for key, t in tpaged.pages_from_dense(full, tab, P, ps)[0].items():
        assert torch.equal(t, entry[key]), key
    short = tpaged.pages_from_dense([{"k": dense["k"][..., :L - 3]}], tab, P,
                                    ps)[0]["k"]
    assert torch.equal(tpaged.paged_view({"k": short, "v": short}, tab)[0],
                       torch.cat([dense["k"][..., :L - 3],
                                  torch.zeros_like(dense["k"][..., :3])], -1))
    with pytest.raises(ValueError, match="cannot hold"):
        tpaged.pages_from_dense(full, tab[:, :1], P, ps)
    q = _tensor(rng.standard_normal((b, 2, nh, d)).astype(np.float32))
    pos = torch.tensor([L - 2, ps + 1, 3], dtype=torch.int32)
    tks, tvs = (None, None) if ks is None else (_tensor(ks), _tensor(vs))
    want = kd.flash_block_decode_plain(q, dense["k"], dense["v"], pos, 0.25,
                                       tks, tvs)
    got = kd.paged_flash_decode(q, entry["k"], entry["v"], tab, pos, 0.25,
                                entry.get("ks"), entry.get("vs"))
    assert torch.equal(got, want)


def test_paged_wrapper_contract():
    q = torch.zeros(2, 1, 4, 16)
    pool = torch.zeros(3, 2, 16, 8)
    with pytest.raises(ValueError, match="table"):
        kd.paged_flash_decode(q, pool, pool, torch.zeros(3, 2,
                                                         dtype=torch.int32),
                              0, 1.0)
    with pytest.raises(ValueError, match="int8 pools need"):
        kd.paged_flash_decode(q, pool.to(torch.int8), pool.to(torch.int8),
                              torch.zeros(2, 2, dtype=torch.int32), 0, 1.0)
    meta = torch.zeros(3, 2, 16, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kd.paged_flash_decode(q.to("meta"), meta, meta,
                              torch.zeros(2, 2, dtype=torch.int32,
                                          device="meta"), 0, 1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kd.write_kv_page_row(meta, torch.zeros(2, 2, 16, device="meta"),
                             torch.zeros(2, dtype=torch.int32, device="meta"),
                             torch.zeros(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        kd.write_kv_page_block(meta, torch.zeros(2, 16, 4, device="meta"),
                               1, 0, 4)
    assert kd.paged_flash_decode.launches == 0
    assert kd.write_kv_page_row.launches == 0
    assert kd.write_kv_page_block.launches == 0


# ---------------------------------------------------------------------------
# models/paged.py against the JAX package's
# ---------------------------------------------------------------------------

def _pools_np(cfg, P, ps, seed):
    """Random pool contents (page 0 zero), for both sides."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(cfg.n_layers):
        e = {"k": rng.standard_normal((P, cfg.kv_heads, cfg.head_dim, ps)),
             "v": rng.standard_normal((P, cfg.kv_heads, cfg.head_dim, ps))}
        e = {k: x.astype(np.float32) for k, x in e.items()}
        if cfg.kv_cache_dtype == "int8":
            e["k"], e["ks"] = _quant_pool(e["k"])
            e["v"], e["vs"] = _quant_pool(e["v"])
        for x in e.values():
            x[0] = 0
        out.append(e)
    return out


def _assert_pools(got, want, written):
    """Pools equal: every lane the step did not write (the null page
    included) bit for bit; the written lanes (``written`` (page, lane)
    pairs) hold the K/V projections, equal up to the f32 summation order
    of the two frameworks' matrix products."""
    for a, b in zip(cache_to_numpy(got), want):
        for key in a:
            w = np.asarray(b[key])
            mask = np.zeros(w.shape, bool)
            for page, lane in written:
                mask[page, ..., lane] = True
            np.testing.assert_array_equal(a[key][~mask], w[~mask])
            np.testing.assert_allclose(a[key][mask], w[mask], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("variant", ["mha", "gqa_rope", "int8"])
def test_paged_decode_step_matches_jax(variant):
    jc, tc, jp, tp = _model(variant)
    ps, P, mp = 8, 9, 3
    pools = _pools_np(tc, P, ps, seed=1)
    table = np.array([[3, 5, 0], [2, 0, 0], [7, 8, 1]], np.int32)
    pos = np.array([12, 4, 23], np.int32)
    active = np.array([True, False, True])
    token = np.array([5, 9, 61], np.int32)
    jl, jpools = jpaged.paged_decode_step(
        jp, jnp.asarray(token), jnp.asarray(pos),
        [{k: jnp.asarray(x) for k, x in e.items()} for e in pools],
        jnp.asarray(table), jnp.asarray(active), jc)
    tpools = cache_from_numpy(pools, "cpu")
    tl, out = tpaged.paged_decode_step(
        tp, torch.as_tensor(token), torch.as_tensor(pos), tpools,
        torch.as_tensor(table), torch.as_tensor(active), tc)
    assert out is tpools
    tol = TOL["int8"] if variant == "int8" else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    if variant == "int8":
        return  # the JAX package attends int8 pools in f32 off a TPU
    written = [(5, 12 % ps), (1, 23 % ps)]   # row 1 is inactive
    _assert_pools(tpools, jpools, written)


@pytest.mark.parametrize("variant", ["mha", "gqa_rope"])
def test_paged_prefill_chunk_matches_jax(variant):
    """Two chunks of one prompt: a full first page, then a short one that
    attends the first page's rows and its own."""
    jc, tc, jp, tp = _model(variant)
    ps, P = 8, 6
    pools = _pools_np(tc, P, ps, seed=2)
    table = np.array([[4, 2, 0, 0]], np.int32)
    toks = np.random.default_rng(3).integers(0, KW["vocab"], (1, 2 * ps))
    jpools = [{k: jnp.asarray(x) for k, x in e.items()} for e in pools]
    tpools = cache_from_numpy(pools, "cpu")
    for pos0, n in ((0, ps), (ps, 5)):
        chunk = np.zeros((1, ps), np.int32)
        chunk[0, :n] = toks[0, pos0:pos0 + n]
        jl, jpools = jpaged.paged_prefill_chunk(
            jp, jnp.asarray(chunk), pos0, n, jpools, jnp.asarray(table), jc)
        tl, _ = tpaged.paged_prefill_chunk(
            tp, torch.as_tensor(chunk), pos0, n, tpools,
            torch.as_tensor(table), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-6)
    _assert_pools(tpools, jpools, [(4, lane) for lane in range(ps)]
                  + [(2, lane) for lane in range(5)])


def test_copy_page_matches_jax():
    _, tc, _, _ = _model("int8")
    pools = _pools_np(tc, 5, 8, seed=4)
    want = jpaged.copy_page([{k: jnp.asarray(x) for k, x in e.items()}
                             for e in pools], 3, 1)
    got = cache_from_numpy(pools, "cpu")
    assert tpaged.copy_page(got, 3, 1) is got
    for a, b in zip(cache_to_numpy(got), want):
        for key in a:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_init_page_pool_matches_jax():
    for variant in ("gqa_rope", "int8"):
        jc, tc, _, _ = _model(variant)
        want = jax.tree.map(np.asarray, jpaged.init_page_pool(jc, 5, 8))
        got = cache_to_numpy(tpaged.init_page_pool(tc, 5, 8, device="cpu"))
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].shape == b[key].shape
                assert a[key].dtype == b[key].dtype and not a[key].any()


# ---------------------------------------------------------------------------
# the paged DecodeServer
# ---------------------------------------------------------------------------

def _check_drained(srv):
    """Leak-free: only the radix cache still holds pages; the null page
    was never written."""
    assert srv.allocator.pages_in_use == (srv.trie.entries
                                          if srv.trie is not None else 0)
    for entry in srv.pools:
        for t in entry.values():
            assert not t[0].any()


def _run_both(jp, jc, tp, tc, reqs, *, jax_too=True, stepper=None, **kw):
    """The stream through the port's paged server (and the JAX one): the
    port's tokens equal its own ``generate`` and the JAX server's; the
    scheduling counters, rounds and steps equal the JAX server's."""
    mine = ts.DecodeServer(tp, tc, paged=True, metrics=Registry(), **kw)
    ref = js.DecodeServer(jp, jc, paged=True, metrics=JaxRegistry(),
                          **kw) if jax_too else None
    for srv in ([mine, ref] if jax_too else [mine]):
        if stepper is None:
            for p, m, *eos in reqs:
                srv.submit(p, m, *eos)
        else:
            stepper(srv)
    got = mine.run()
    for (p, m, *eos), g in zip(reqs, got):
        want = _generate(tp, tc, p, m)
        if eos and eos[0] in want:
            want = want[:list(want).index(eos[0]) + 1]
        np.testing.assert_array_equal(g, want)
    _check_drained(mine)
    if jax_too:
        want = ref.run()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        a, b = mine.stats(), ref.stats()
        assert a["counters"] == b["counters"]
        assert a["gauges"] == b["gauges"] and a["pages"] == b["pages"]
        assert (mine.rounds_run, mine.steps_run) == (ref.rounds_run,
                                                     ref.steps_run)
    return mine, got


@pytest.mark.parametrize("variant", ["mha", "gqa_rope", "int8"])
def test_paged_stream_matches_jax_server_and_generate(variant):
    """8 mixed requests through 3 slots over 8-token pages: prompts span
    1-4 pages and slots are reused."""
    jc, tc, jp, tp = _model(variant, seed=1)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, KW["vocab"], (int(rng.integers(3, 30)),)),
             int(rng.integers(1, 20))) for _ in range(8)]
    srv, _ = _run_both(jp, jc, tp, tc, reqs, jax_too=variant != "int8",
                       n_slots=3, max_len=96, round_len=5, page_size=8)
    assert srv.clip_rounds and srv.n_pages == 3 * 12 + 1


def test_eos_and_late_submission(mha):
    jc, tc, jp, tp = mha
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, KW["vocab"], (7,))
    dense = _generate(tp, tc, prompt, 16)
    eos = int(next(t for i, t in enumerate(dense)
                   if i >= 3 and t not in dense[:i]))
    late = rng.integers(0, KW["vocab"], (6,))

    def stepper(srv):
        srv.submit(prompt, 16, eos)
        srv.step_round()
        srv.submit(late, 5)

    _run_both(jp, jc, tp, tc, [(prompt, 16, eos), (late, 5)],
              stepper=stepper, n_slots=1, max_len=64, round_len=4,
              page_size=8)


def test_prefix_sharing_and_exact_duplicate_cow(mha):
    """Requests sharing a 16-token prefix map the same pages; an exact
    duplicate of a finished prompt takes the full radix hit and copies
    the shared page it must write into."""
    jc, tc, jp, tp = mha
    rng = np.random.default_rng(4)
    sys_p = rng.integers(0, KW["vocab"], (16,))
    reqs = [(np.concatenate([sys_p, rng.integers(0, KW["vocab"], (t,))]), 8)
            for t in (5, 9, 3)]
    dup = (reqs[0][0].copy(), 11)

    def stepper(srv):
        for p, m in reqs:
            srv.submit(p, m)
        srv.run()
        srv.submit(*dup)

    srv, _ = _run_both(jp, jc, tp, tc, reqs + [dup], stepper=stepper,
                       n_slots=2, max_len=64, round_len=4, page_size=8)
    c = srv.stats()["counters"]
    # the first two are admitted in one pass, before either registers
    assert c["serve.prefix_hits"] == 2 and c["serve.cow_copies"] == 1
    # the third shares the 16-token prefix, the duplicate all but its
    # last prompt token
    assert c["serve.prefix_tokens_shared"] == 16 + 20


def test_exhaustion_backpressure_and_eviction(mha):
    """8 usable pages, each request spans 4: admission stalls, decode
    drains, freed pages (and evicted trie pages) admit the rest."""
    jc, tc, jp, tp = mha
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, KW["vocab"], (8,)), 24) for _ in range(4)]
    srv, _ = _run_both(jp, jc, tp, tc, reqs, n_slots=3, max_len=64,
                       round_len=4, page_size=8, n_pages=9)
    c = srv.stats()["counters"]
    assert c["serve.admission_stalls"] >= 1 and c["serve.trie_evictions"] >= 1


def test_oversized_requests_are_rejected(mha):
    _, tc, _, tp = mha
    srv = ts.DecodeServer(tp, tc, n_slots=1, max_len=64, round_len=4,
                          paged=True, page_size=8, n_pages=5,
                          metrics=Registry())
    with pytest.raises(ValueError, match="max_len"):
        srv.submit(np.zeros(60, np.int32), 20)
    with pytest.raises(ValueError, match="pool"):
        srv.submit(np.zeros(30, np.int32), 20)
    with pytest.raises(ValueError, match="empty"):
        srv.submit(np.zeros(0, np.int32), 4)
    assert not srv.has_work()


def test_prefill_budget_interleaves_chunks(mha):
    jc, tc, jp, tp = mha
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, KW["vocab"], (4,)), 12),
            (rng.integers(0, KW["vocab"], (29,)), 6)]   # 4 chunks
    srv, _ = _run_both(jp, jc, tp, tc, reqs, n_slots=2, max_len=96,
                       round_len=3, page_size=8, prefill_budget=8)
    assert srv.stats()["counters"]["serve.prefill_chunks"] >= 5


def test_clip_rounds(mha):
    """Clipped rounds spend fewer slot-steps than unclipped ones on the
    same stream, with the same tokens; the dense server takes the knob
    too and schedules as the JAX dense server does."""
    jc, tc, jp, tp = mha
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, KW["vocab"], (int(rng.integers(3, 12)),)),
             int(rng.integers(2, 15))) for _ in range(6)]
    kw = dict(n_slots=2, max_len=64, round_len=5, page_size=8)
    clipped, toks = _run_both(jp, jc, tp, tc, reqs, **kw)
    unclipped, toks2 = _run_both(jp, jc, tp, tc, reqs, clip_rounds=False,
                                 **kw)
    assert clipped.steps_run < unclipped.steps_run
    for a, b in zip(toks, toks2):
        np.testing.assert_array_equal(a, b)
    # unclipped rounds decode rows past their reserved pages: the port
    # drops those writes (its null page stays zero, _check_drained), the
    # JAX package lands them in page 0
    ref = js.DecodeServer(jp, jc, paged=True, metrics=JaxRegistry(),
                          clip_rounds=False, **kw)
    for p, m in reqs:
        ref.submit(p, m)
    ref.run()
    assert np.asarray(ref.pools[0]["k"][0]).any()
    dense_kw = dict(n_slots=2, max_len=64, round_len=5, prompt_buckets=(16,),
                    clip_rounds=True)
    mine = ts.DecodeServer(tp, tc, metrics=Registry(), **dense_kw)
    ref = js.DecodeServer(jp, jc, metrics=JaxRegistry(), **dense_kw)
    for srv in (mine, ref):
        for p, m in reqs:
            srv.submit(p, m)
    for a, b in zip(mine.run(), ref.run()):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (mine.rounds_run, mine.steps_run) == (ref.rounds_run,
                                                 ref.steps_run)
    assert not ts.DecodeServer(tp, tc, metrics=Registry(),
                               **dict(dense_kw, clip_rounds=None)).clip_rounds


def test_cancel_releases_pages(mha):
    _, tc, _, tp = mha
    rng = np.random.default_rng(9)
    srv = ts.DecodeServer(tp, tc, n_slots=2, max_len=64, round_len=3,
                          paged=True, page_size=8, prefill_budget=8,
                          metrics=Registry())
    long_ = srv.submit(rng.integers(0, KW["vocab"], (30,)), 10)
    queued = srv.submit(rng.integers(0, KW["vocab"], (5,)), 4)
    other = srv.submit(rng.integers(0, KW["vocab"], (5,)), 4)
    srv.step_round()                    # long_ is mid-prefill
    assert srv.cancel(long_) and srv.cancel(other)
    assert not srv.cancel(long_)
    outs = srv.run()
    assert len(outs[long_]) == 0 and len(outs[queued]) == 4
    _check_drained(srv)
    assert srv.stats()["counters"]["serve.requests_canceled"] == 2


def test_span_hooks_emit_prefill_chunks(mha):
    """``ModelBackend.attach_spans`` hands a span recorder to the paged
    scheduler: one PREFILL_CHUNK span per chunk, under the fabric rid."""
    from rlo_tpu.observe.spans import SpanRecorder, Stage
    from rlo_tpu.utils.tracing import Ev, Tracer
    assert ts.STAGE_PREFILL_CHUNK == int(Stage.PREFILL_CHUNK)
    _, tc, _, tp = mha
    ring = Tracer(enabled=True)
    be = ModelBackend(ts.DecodeServer(tp, tc, n_slots=2, max_len=64,
                                      round_len=4, paged=True, page_size=8,
                                      metrics=Registry()))
    be.attach_spans(SpanRecorder(0, lambda: 0.0, tracer=ring))
    prompt = list(np.random.default_rng(10).integers(0, KW["vocab"], (19,)))
    be.submit((2, 7), prompt, 5)
    be.submit((2, 7), prompt, 5)       # a duplicate key is ignored
    done = []
    while be.has_work():
        done += be.step_round()
    assert done == [((2, 7), tuple(int(t) for t in
                                   _generate(tp, tc, prompt, 5)))]
    evs = ring.events(Ev.SPAN)
    assert [(e.a, e.d, e.c) for e in evs] == \
        [(int(Stage.PREFILL_CHUNK), 2, 7)] * 3           # 19 tokens: 3 pages
    assert be.stats()["backend"] == "decode_server" and be.load() == (2, 0)


def test_fabric_kill_paged_model_backend_exactly_once(mha):
    """3-rank fabric over the port's paged DecodeServer: the owner dies
    mid-decode, the re-queued request re-prefills on a survivor and
    completes exactly once with the port's generate tokens."""
    from rlo_tpu.engine import EngineManager, ProgressEngine
    from rlo_tpu.serving.fabric import DecodeFabric
    from rlo_tpu.transport.sim import SimWorld

    _, tc, _, tp = mha
    n_ranks = 3
    world = SimWorld(n_ranks, seed=0)
    mgr = EngineManager()
    engines = [ProgressEngine(world.transport(r), manager=mgr,
                              clock=world.clock, failure_timeout=6.0,
                              heartbeat_interval=1.0, arq_rto=1.5,
                              arq_max_retries=6, op_deadline=20.0)
               for r in range(n_ranks)]
    fabrics = [DecodeFabric(
        engines[r],
        ModelBackend(ts.DecodeServer(tp, tc, n_slots=2, max_len=64,
                                     round_len=4, paged=True, page_size=8,
                                     metrics=Registry())),
        decode_interval=1.0) for r in range(n_ranks)]
    rng = np.random.default_rng(1)
    prompt = tuple(int(t) for t in rng.integers(0, KW["vocab"], (6,)))
    rid = fabrics[1].submit(prompt, 14)
    live = {0, 1, 2}
    killed = False
    while world.now < 90.0:
        if not killed and world.now >= 2.5:
            killed = True
            world.kill_rank(0)
            engines[0].cleanup()
            live.discard(0)
        world.step()
        mgr.progress_all()
        for r in sorted(live):
            fabrics[r].pump()
        if killed and all(fabrics[r].result(rid) is not None for r in live):
            break
    assert killed
    want = tuple(int(t) for t in _generate(tp, tc, prompt, 14))
    for r in sorted(live):
        assert fabrics[r].result(rid) == want, f"rank {r} diverged"
        assert fabrics[r].completions.count(rid) == 1
