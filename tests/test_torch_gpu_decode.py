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


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4])
def test_decode_kernel_matches_plain_on_card(cuda, kind, T):
    L = 300
    args = _case(T, L, kind, seed=T, dev=cuda)
    for pos in (torch.tensor(200, dtype=torch.int32, device=cuda),
                torch.tensor([0, 150, L - T], dtype=torch.int32,
                             device=cuda)):
        got = kd.flash_block_decode(args[0], args[1], args[2], pos, 0.25,
                                    args[3], args[4])
        torch.cuda.synchronize()
        want = kd.flash_block_decode_plain(args[0], args[1], args[2], pos,
                                           0.25, args[3], args[4])
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


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
