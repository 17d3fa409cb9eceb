"""K2 (flash forward) against its plain version on the card, and K2-K5
on operands that are views.

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py`` says);
the inputs are those of ``tests/test_torch_flash.py``, made with numpy
from the same seeds.
"""

import numpy as np
import pytest
import torch

from rlo_tpu_torch.convert import from_numpy
from rlo_tpu_torch.kernels import flash as k2


def _inputs(h, hk, lq, lk, d, seed, carried=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((h, lq, d)).astype(np.float32)
    k = rng.standard_normal((hk, lk, d)).astype(np.float32)
    v = rng.standard_normal((hk, lk, d)).astype(np.float32)
    if carried:  # a non-initial state, as a ring step carries it
        m = rng.standard_normal((h, 1, lq)).astype(np.float32)
        l = rng.uniform(0.5, 2.0, (h, 1, lq)).astype(np.float32)
        o = rng.standard_normal((h, lq, d)).astype(np.float32)
    else:
        m = np.full((h, 1, lq), -1e30, np.float32)
        l = np.zeros((h, 1, lq), np.float32)
        o = np.zeros((h, lq, d), np.float32)
    # global positions: the K block sits at an offset, as on a ring
    qp = (np.arange(lq, dtype=np.int32) + 7).reshape(1, lq)
    kp = (np.arange(lk, dtype=np.int32) + 7 - lk // 3).reshape(1, lk)
    return q, k, v, m, l, o, qp, kp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hk,lq,lk,d", [(8, 8, 100, 130, 64),
                                          (8, 2, 64, 64, 128),
                                          (4, 1, 33, 7, 16),
                                          (4, 4, 33, 7, 32),
                                          (8, 4, 129, 77, 16),
                                          (8, 4, 129, 77, 32),
                                          (16, 2, 129, 77, 64),
                                          (16, 2, 33, 7, 128)])
@pytest.mark.parametrize("state", ["carried", "initial", "ring"])
def test_kernel_matches_plain_on_card(cuda, h, hk, lq, lk, d, dtype, state):
    """K2 against its plain version (bf16: the tensor-core route; f32: the
    CUDA-core route): ragged Lq/Lk, GQA groups 1-8, a carried or the
    initial state, and ("ring") key positions permuted and shifted so
    some rows see no key (fully masked rows)."""
    args = from_numpy(list(_inputs(h, hk, lq, lk, d, seed=lq,
                                   carried=state == "carried")), cuda)
    args[:3] = [t.to(dtype) for t in args[:3]]
    if state == "ring":
        perm = np.random.default_rng(lk).permutation(lk)
        args[7] = (args[7][:, perm] + lq // 2).contiguous()
    for causal in (True, False):
        before = k2.flash_block_update_hld.launches
        got = k2.flash_block_update_hld(*args, causal=causal, scale=0.125)
        torch.cuda.synchronize()
        assert k2.flash_block_update_hld.launches == before + 1
        want = k2.flash_block_update_hld_plain(*args, causal=causal,
                                               scale=0.125)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        if causal and state == "ring":
            assert bool((got[1] == 0).any())  # some rows saw no key


def _offset(t):
    """A contiguous view of ``t``'s values one element into its storage
    (a bf16 view so starts 2 bytes past 16)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def _transposed(t):
    """A non-contiguous view of ``t``'s values (the last two axes
    swapped in storage)."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_views_equal_contiguous_copies_on_card(cuda, dtype):
    """K2-K5 take operands that are views, as the reference takes any
    array: an offset-by-one (misaligned) k, v and do', and a transposed
    q and do', give the same bits as their contiguous copies."""
    h, lq, lk, d = 4, 96, 80, 64
    q, k, v, m, l, o, qp, kp = from_numpy(list(_inputs(h, h, lq, lk, d, 3)),
                                          cuda)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    gen = torch.Generator(device=cuda).manual_seed(5)
    dl2 = torch.randn(h, 1, lq, generator=gen, device=cuda)
    do2 = torch.randn(h, lq, d, generator=gen, device=cuda)
    route = torch.randn(h, 1, lq, generator=gen, device=cuda)
    kw = dict(causal=True, scale=0.125)
    for views in ((_transposed(q), _offset(k), _offset(v), _offset(do2)),
                  (_offset(q), k, v, _transposed(do2))):
        assert not views[0].is_contiguous() or views[0].data_ptr() % 16
        vq, vk, vv, vdo = views
        for got, want in (
                (k2.flash_block_update_hld(vq, vk, vv, m, l, o, qp, kp, **kw),
                 k2.flash_block_update_hld(q, k, v, m, l, o, qp, kp, **kw)),
                ((k2.rowstats(vq, vk, m, qp, kp, **kw),),
                 (k2.rowstats(q, k, m, qp, kp, **kw),)),
                ((k2.bwd_dq(vq, vk, vv, m, dl2, vdo, route, qp, kp, **kw),),
                 (k2.bwd_dq(q, k, v, m, dl2, do2, route, qp, kp, **kw),)),
                (k2.bwd_dkv(vq, vk, vv, m, dl2, vdo, route, qp, kp, **kw),
                 k2.bwd_dkv(q, k, v, m, dl2, do2, route, qp, kp, **kw))):
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
