"""The consensus-gated bridge on the card: ``init(backend="hybrid")``'s
gated collectives against the ungated ``TorchBackend`` calls, bit for
bit, with K1 launched; the shape, dtype and device-judge vetoes, which
launch no K1.

Card-only and jax-free, so the machine with the card runs it without the
JAX package:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu -q \\
        tests/test_torch_gpu_*.py

Without a card every test skips (the data plane's kernels have no CPU
mode on a card's tensors; the CPU twin is ``tests/test_torch_bridge.py``).
"""

import pytest
import torch

import rlo_tpu_torch
from rlo_tpu_torch.kernels import reduce as k1

WS = 8
PROPOSER = 5


@pytest.fixture(scope="module")
def backends():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the gated collectives run K1)")
    h = rlo_tpu_torch.init(backend="hybrid", world_size=WS)
    b = rlo_tpu_torch.init(backend="cuda", world_size=WS)
    yield h, b
    h.close()
    b.close()


def _xs(n, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(n, generator=g, device="cuda") for _ in range(WS)]


def _finite(v):
    return torch.isfinite(v).all().to(torch.int32)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 1000, 1 << 20])
@pytest.mark.parametrize("op", ["allreduce", "reduce_scatter", "all_gather"])
def test_gated_equals_ungated_and_launches_k1(backends, n, op):
    h, b = backends
    xs = _xs(n, seed=n)
    before = k1.fused_combine.launches
    d, got = h.propose_collective(op, xs, proposer=PROPOSER,
                                  algorithm="ring")
    assert d == 1
    if op != "all_gather":
        assert k1.fused_combine.launches > before
    want = {"allreduce": lambda: b.allreduce(xs, algorithm="ring"),
            "reduce_scatter": lambda: b.reduce_scatter(xs),
            "all_gather": lambda: b.all_gather(xs)}[op]()
    torch.cuda.synchronize()
    assert all(g.is_cuda for g in got)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["shape", "dtype"])
def test_structural_veto_launches_nothing(backends, what):
    h, _ = backends
    xs = _xs(4096, seed=3)
    if what == "shape":
        xs[3] = xs[3][:100]
    else:
        xs[1] = xs[1].to(torch.bfloat16)
    before = k1.fused_combine.launches
    assert h.propose_collective("allreduce", xs, proposer=PROPOSER,
                                algorithm="ring") == (0, None)
    assert k1.fused_combine.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("poisoned", [None, 6, PROPOSER])
def test_device_judge_votes_from_each_rank_tensor(backends, poisoned):
    h, b = backends
    xs = _xs(4096, seed=4)
    if poisoned is not None:
        xs[poisoned][77] = float("nan")
    before = k1.fused_combine.launches
    d, out = h.propose_collective("allreduce", xs, proposer=PROPOSER,
                                  device_judge=_finite, algorithm="ring")
    if poisoned is None:
        assert d == 1
        want = b.allreduce(xs, algorithm="ring")
        torch.cuda.synchronize()
        assert all(torch.equal(_bits(g), _bits(w))
                   for g, w in zip(out, want))
    else:
        assert (d, out) == (0, None)
        assert k1.fused_combine.launches == before


@pytest.mark.gpu
def test_engine_bcast_and_consensus_with_card_tensors(backends):
    h, _ = backends
    x = torch.arange(1000, device="cuda", dtype=torch.float32)
    got = h.bcast(3, x)
    assert all(g.is_cuda and torch.equal(g, x) for g in got)
    assert h.consensus([1] * WS, proposer=PROPOSER) == 1
    assert h.consensus([1] * 7 + [0], proposer=PROPOSER) == 0
