"""Every launch whose grid.y or grid.z is a count the caller chooses, past
CUDA's 65,535, on the card: K2-K5 at 65,536 folded heads, K8 and K11 at
65,536 (row, head) blocks, K6 over 65,535 * 256 + 1 positions (its entry
widens the split) and over 65,536 row tiles, each against its plain
version; each call makes one launch a chunk of 65,535 blocks.

Card-only and jax-free, so the machine with the card runs it without the
JAX package:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu -q \\
        tests/test_torch_gpu_*.py

Without a card every test skips (the kernels have no CPU mode).
"""

import pytest
import torch

from rlo_tpu_torch.kernels import decode as kd
from rlo_tpu_torch.kernels import flash as kf

PAST = 65536      # one past CUDA's grid.y/z limit


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, rtol, atol_unit):
    scale = max(1.0, float(want.abs().max()))
    return bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=rtol, atol=atol_unit * scale)


def _launches(fn, call):
    before = fn.launches
    out = call()
    torch.cuda.synchronize()
    return out, fn.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_past_65535_heads(cuda, dtype):
    """K2's m/l/o and K4/K5 within rtol 1e-4 of the plain versions (each
    side on its own forward's m'), K3's counts equal, two launches each."""
    g = torch.Generator(device=cuda).manual_seed(1)
    h, L, d, kw = PAST, 16, 16, dict(causal=True, scale=0.25)
    q, k, v = (torch.randn(h, L, d, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    m = torch.full((h, 1, L), kf.NEG, device=cuda)
    l, o = torch.zeros(h, 1, L, device=cuda), torch.zeros(h, L, d,
                                                          device=cuda)
    pos = torch.arange(L, dtype=torch.int32, device=cuda).reshape(1, L)
    fwd = (q, k, v, m, l, o, pos, pos)
    with torch.no_grad():
        got, n2 = _launches(kf.flash_block_update_hld, lambda: (
            kf.flash_block_update_hld(*fwd, **kw)))
        want = kf.flash_block_update_hld_plain(*fwd, **kw)
    assert n2 == 2
    for x, y in zip(got, want):
        assert _close(x, y, 1e-4, 1e-4)
    dl2, route = (torch.randn(h, 1, L, generator=g, device=cuda)
                  for _ in range(2))
    do2 = torch.randn(h, L, d, generator=g, device=cuda)
    ops = (q, k, v, got[0], dl2, do2, route, pos, pos)
    pops = (q, k, v, want[0], dl2, do2, route, pos, pos)
    cnt, n3 = _launches(kf.rowstats, lambda: kf.rowstats(
        q, k, got[0], pos, pos, **kw))
    dq, n4 = _launches(kf.bwd_dq, lambda: kf.bwd_dq(*ops, **kw))
    (dk, dv), n5 = _launches(kf.bwd_dkv, lambda: kf.bwd_dkv(*ops, **kw))
    assert (n3, n4, n5) == (2, 2, 2)
    assert torch.equal(cnt, kf.rowstats_plain(q, k, want[0], pos, pos, **kw))
    pdk, pdv = kf.bwd_dkv_plain(*pops, **kw)
    for x, y in ((dq, kf.bwd_dq_plain(*pops, **kw)), (dk, pdk), (dv, pdv)):
        assert _close(x, y, 1e-4, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,heads", [(PAST, 1), (1, PAST)])
def test_block_write_past_65535_blocks(cuda, nb, heads):
    """K8 over nb x heads (row, head) blocks, a k/v pair: bit-equal to
    indexed assignment in two launches."""
    g = torch.Generator(device=cuda).manual_seed(2)
    D, T, Lc = 16, 8, 32
    caches = [torch.randn(nb, heads, D, Lc, generator=g, device=cuda)
              .to(torch.bfloat16) for _ in range(2)]
    rows = [torch.randn(nb, heads, D, T, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2)]
    at = torch.randint(0, Lc - T + 1, (nb,), generator=g, device=cuda,
                       dtype=torch.int32)
    got = [c.clone() for c in caches]
    _, n = _launches(kd.write_kv_block, lambda: kd.write_kv_block(
        got[0], rows[0], at, got[1], rows[1]))
    kd.write_kv_block_plain(caches[0], rows[0], at, caches[1], rows[1])
    assert n == 2
    assert all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(got, caches))


@pytest.mark.gpu
def test_page_block_write_past_65535_heads(cuda):
    """K11 with 65,536 kv heads, a k/v pair: bit-equal to indexed
    assignment in two launches."""
    g = torch.Generator(device=cuda).manual_seed(3)
    D, T, ps = 16, 8, 32
    pools = [torch.randn(3, PAST, D, ps, generator=g, device=cuda)
             .to(torch.bfloat16) for _ in range(2)]
    rows = [torch.randn(PAST, D, T, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2)]
    got = [p.clone() for p in pools]
    _, n = _launches(kd.write_kv_page_block, lambda: kd.write_kv_page_block(
        got[0], rows[0], 1, 5, T - 1, got[1], rows[1]))
    kd.write_kv_page_block_plain(pools[0], rows[0], 1, 5, T - 1, pools[1],
                                 rows[1])
    assert n == 2
    assert all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(got, pools))


@pytest.mark.gpu
def test_decode_past_65535_splits(cuda):
    """K6 over 65,535 * 256 + 1 positions (D 16, bf16): the entry widens
    the split to 512; one launch, within rtol 1e-3 / atol 2e-3 of the
    plain version's one sweep, and the planted keys' mean value."""
    g = torch.Generator(device=cuda).manual_seed(4)
    L, hd, scale = 65535 * 256 + 1, 16, 0.25
    q = torch.randn(1, 1, 1, hd, generator=g, device=cuda).to(torch.bfloat16)
    kc = torch.randn(1, 1, hd, L, generator=g, device=cuda,
                     dtype=torch.bfloat16)
    vc = torch.randn(1, 1, hd, L, generator=g, device=cuda,
                     dtype=torch.bfloat16)
    planted = (7, L - 1)
    for j in planted:
        kc[0, 0, :, j] = q[0, 0, 0] * 16
    got, n = _launches(kd.flash_block_decode, lambda: kd.flash_block_decode(
        q, kc, vc, L - 1, scale))
    want = kd.flash_block_decode_plain(q, kc, vc, L - 1, scale,
                                       block_k=1 << 20, split_k=None)
    assert n == 1
    assert torch.allclose(got, want, rtol=1e-3, atol=2e-3)
    mean = vc[0, 0][:, list(planted)].float().mean(-1)
    assert torch.allclose(got[0, 0, 0], mean, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_decode_past_65535_row_tiles(cuda):
    """K6 with 65,536 row tiles of 32 query rows (T 65,536, 32 query heads
    on one kv head, two splits): two launches, within rtol 1e-3 / atol
    2e-3 of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(1, PAST, 32, 16, generator=g, device=cuda) \
        .to(torch.bfloat16)
    kc, vc = (torch.randn(1, 1, 16, 384, generator=g, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    got, n = _launches(kd.flash_block_decode, lambda: kd.flash_block_decode(
        q, kc, vc, 0, 0.25))
    assert n == 2
    assert torch.allclose(got, kd.flash_block_decode_plain(q, kc, vc, 0,
                                                           0.25),
                          rtol=1e-3, atol=2e-3)
