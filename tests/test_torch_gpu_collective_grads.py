"""K1's backward on the card: ``FusedCombine`` (the differentiable step of
the manual schedules) against its plain path (``use_kernel=False``: the
plain forward, the same JAX rule backward).

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


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1027, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_fused_combine_grad_matches_plain_on_card(cuda, n, dtype, op):
    """Integer-valued operands (ties everywhere) and a NaN in each: the
    forward launches K1 once and equals the plain version; both
    gradients equal the plain path's bit for bit, and a winning NaN
    gives neither operand a share (JAX's rule)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    a, b = (torch.randint(-3, 4, (n,), generator=g, device=cuda)
            .to(dtype) for _ in range(2))
    a[n // 2] = float("nan")
    b[-1] = float("nan")
    ct = torch.randn(n, generator=g, device=cuda).to(dtype)
    ka, kb = a.clone().requires_grad_(), b.clone().requires_grad_()
    pa, pb = a.clone().requires_grad_(), b.clone().requires_grad_()
    before = k1.fused_combine.launches
    got = k1.FusedCombine.apply(ka, kb, op)
    assert k1.fused_combine.launches == before + 1
    want = k1.FusedCombine.apply(pa, pb, op, False)
    assert k1.fused_combine.launches == before + 1
    assert torch.equal(_bits(got.detach()), _bits(want.detach()))
    gk = torch.autograd.grad(got, (ka, kb), ct)
    gp = torch.autograd.grad(want, (pa, pb), ct)
    torch.cuda.synchronize()
    assert k1.fused_combine.launches == before + 1   # no kernel backward
    for x, y in zip(gk, gp):
        assert x.dtype == dtype and torch.equal(_bits(x), _bits(y))
        if op != "sum":
            assert x[n // 2] == 0 and x[-1] == 0


@pytest.mark.gpu
def test_fused_combine_refuses_bitwise_ops(cuda):
    a = torch.ones(4, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        k1.FusedCombine.apply(a, a.detach(), "and")
