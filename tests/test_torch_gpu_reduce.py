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
