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
@pytest.mark.parametrize("T", [1, 4])
def test_paged_kernel_matches_plain_on_card(cuda, kind, T):
    args = _paged_case(kind, 32, T, 2, seed=T, dev=cuda, d=64, mp=9)
    got = kd.paged_flash_decode(*args[:5], 0.125, args[5], args[6])
    torch.cuda.synchronize()
    want = kd.paged_flash_decode_plain(*args[:5], 0.125, args[5], args[6])
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


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
