"""The host facades fed card tensors: ``init("native")`` and
``init("loopback")`` against ``TorchBackend`` on the same tensors, bit for
bit (the C ring and ``Comm``'s ring reduce each chunk in the device
ring's order), every result a tensor back on the card, and no K1 launched
by the facades themselves (they compute on the host).

Card-only and jax-free, so the machine with the card runs it without the
JAX package:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu -q \\
        tests/test_torch_gpu_*.py

Without a card every test skips (the CPU twin, against the JAX package,
is ``tests/test_torch_host_backends.py``).
"""

import pytest
import torch

import rlo_tpu_torch
from rlo_tpu_torch.kernels import reduce as k1

WS = 5


@pytest.fixture(scope="module")
def torch_b():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the tensors live on the card)")
    b = rlo_tpu_torch.init("cuda", world_size=WS)
    yield b
    b.close()


def _xs(n, seed, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int32:
        return [torch.randint(-999, 999, (n,), generator=g, device="cuda",
                              dtype=dtype) for _ in range(WS)]
    return [torch.randn(n, generator=g, device="cuda") for _ in range(WS)]


def _equal(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert isinstance(got, torch.Tensor) and got.is_cuda
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["native", "loopback"])
@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_ring_ops_equal_torch_backend(torch_b, name, n):
    with rlo_tpu_torch.init(name, world_size=WS) as f:
        xs = _xs(n, seed=n)
        for op in ("sum", "min", "max"):
            before = k1.fused_combine.launches
            got = f.allreduce(xs, op=op, algorithm="ring")
            assert k1.fused_combine.launches == before
            _equal(got, torch_b.allreduce(xs, op=op, algorithm="ring"))
        _equal(f.reduce_scatter(xs), torch_b.reduce_scatter(
            xs, algorithm="ring"))
        _equal(f.all_gather(xs), torch_b.all_gather(xs))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["native", "loopback"])
def test_other_ops_equal_torch_backend(torch_b, name):
    with rlo_tpu_torch.init(name, world_size=WS) as f:
        ints = _xs(4096, seed=1, dtype=torch.int32)
        _equal(f.allreduce(ints), torch_b.allreduce(ints))
        grid = [_xs(64, seed=10 + r) for r in range(WS)]
        _equal(f.all_to_all(grid), torch_b.all_to_all(grid))
        x = _xs(2048, seed=2)[0]
        _equal(f.bcast(3, x), torch_b.bcast(3, x))
        votes = [1, 1, 0, 1, 1]
        assert f.consensus(votes, proposer=4) == \
            torch_b.consensus(votes) == 0
        assert f.consensus([1] * WS, proposer=2) == 1
        f.barrier()
        with f.sub_group([0, 2, 4]) as s:
            sub = rlo_tpu_torch.init("cuda", world_size=3)
            xs = _xs(777, seed=3)[:3]
            _equal(s.allreduce(xs, algorithm="ring"),
                   sub.allreduce(xs, algorithm="ring"))
        st = f.last_staging
        assert st is not None and min(st.values()) >= 0


@pytest.mark.gpu
def test_bfloat16_card_tensors_are_refused(torch_b):
    with rlo_tpu_torch.init("native", world_size=WS) as f:
        xs = [x.to(torch.bfloat16) for x in _xs(8, seed=4)]
        with pytest.raises(TypeError, match="bfloat16"):
            f.allreduce(xs)
