"""K1 (the fused combine) against its plain version on the card.

Card-only and jax-free, so the machine with the card runs it without the
JAX package:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu -q \\
        tests/test_torch_gpu_*.py

Without a card every test skips (the kernel has no CPU mode).
"""

import pytest
import torch

from rlo_tpu_torch.kernels import reduce as k1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 105, 513, 1 << 20])
@pytest.mark.parametrize("dtype,op", [(torch.float32, "sum"),
                                      (torch.bfloat16, "max"),
                                      (torch.int32, "min"),
                                      (torch.int32, "or")])
def test_kernel_matches_plain_on_card(cuda, n, dtype, op):
    g = torch.Generator(device=cuda).manual_seed(n)
    if dtype == torch.int32:
        a = torch.randint(-2 ** 30, 2 ** 30, (n,), generator=g,
                          device=cuda, dtype=dtype)
        b = torch.randint(-2 ** 30, 2 ** 30, (n,), generator=g,
                          device=cuda, dtype=dtype)
    else:
        a = torch.randn(n, generator=g, device=cuda).to(dtype)
        b = torch.randn(n, generator=g, device=cuda).to(dtype)
    before = k1.fused_combine.launches
    got = k1.fused_combine(a, b, op)
    torch.cuda.synchronize()
    assert k1.fused_combine.launches == before + 1
    assert torch.equal(got, k1.fused_combine_plain(a, b, op))


#: 16-byte vectors a block of K1 covers in one step of its loop (threads
#: x the vectors each loads before its stores), and its grid's cap in
#: blocks an SM (csrc/reduce.cu's kThreads, kUnroll and grid_for)
BLOCK_VECS = 256 * 4
BLOCKS_PER_SM = 256


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,op", [(torch.float32, "sum"),
                                      (torch.bfloat16, "min"),
                                      (torch.int32, "max"),
                                      (torch.int16, "and")])
def test_vector_and_tail_edges_on_card(cuda, dtype, op):
    """Sizes around one block's step of the unrolled loop, each with a
    scalar tail or none, and just past the grid's cap (a second pass of
    the grid-stride loop, 553 MB an operand), bit-identical to the plain
    version, also with out = a (the accumulate path); NaN inputs for
    min."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    step = BLOCK_VECS * per
    cap = torch.cuda.get_device_properties(cuda).multi_processor_count \
        * BLOCKS_PER_SM
    sizes = [per - 1, per, per + 1, step - 1, step, step + per + 3,
             3 * step - per, cap * step + per + 3]
    g = torch.Generator(device=cuda).manual_seed(1)
    for n in sizes:
        if dtype.is_floating_point:
            a = torch.randn(n, generator=g, device=cuda).to(dtype)
            b = torch.randn(n, generator=g, device=cuda).to(dtype)
            a[::5] = float("nan")
            b[2::7] = float("nan")
        else:   # int32 far above 2^24
            lo, hi = torch.iinfo(dtype).min, torch.iinfo(dtype).max
            a = torch.randint(lo, hi, (n,), generator=g, device=cuda,
                              dtype=dtype)
            b = torch.randint(lo, hi, (n,), generator=g, device=cuda,
                              dtype=dtype)
        want = k1.fused_combine_plain(a, b, op)
        got = k1.fused_combine(a, b, op)
        acc = a.clone()
        k1.fused_combine(acc, b, op, out=acc)
        torch.cuda.synchronize()
        bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        for x in (got, acc):    # bit for bit, NaN payloads included
            view = bits.get(dtype, dtype)
            assert torch.equal(x.view(view), want.view(view)), (n, op)
