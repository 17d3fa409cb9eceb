"""K2, the flash block update (forward): the port's plain version against
the Pallas kernel (interpret mode on the CPU) and its pure-JAX
restatement ``_ref_block_update_hld``, and the CUDA kernel against the
plain version on the card.

Tolerance f32 rtol 1e-5 / atol 1e-6 for f32 and bf16 inputs alike:
both sides upcast q, k and v to f32 and compute in f32, so they differ
only in summation order. The atol is per unit of the output's largest
magnitude: the f32 rounding of a sum of many terms grows with them, and
an output near zero can be the difference of terms of size 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.pallas import flash as jflash
from rlo_tpu_torch.convert import from_numpy, to_numpy
from rlo_tpu_torch.kernels import build
from rlo_tpu_torch.kernels import flash as k2

RTOL, ATOL = 1e-5, 1e-6


def _inputs(h, hk, lq, lk, d, seed, bf16=False, carried=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((h, lq, d)).astype(np.float32)
    k = rng.standard_normal((hk, lk, d)).astype(np.float32)
    v = rng.standard_normal((hk, lk, d)).astype(np.float32)
    if bf16:
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v))
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


def _port(args, causal, scale):
    ts = from_numpy(list(args), "cpu")
    return to_numpy(list(k2.flash_block_update_hld(*ts, causal=causal,
                                                   scale=scale)))


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_plain_matches_pallas_interpret(g, causal, bf16):
    args = _inputs(4, 4 // g, 32, 48, 16, seed=g + 10 * causal, bf16=bf16)
    want = jflash.flash_block_update_hld(
        *(jnp.asarray(a) for a in args), causal=causal, scale=0.3,
        block_q=16, interpret=True)
    _close(_port(args, causal, 0.3), want)


@pytest.mark.parametrize("lq,lk", [(37, 50), (5, 129), (64, 1)])
def test_ragged_lengths_match_reference(lq, lk):
    """Lq and Lk that no tile divides: held against the pure-JAX
    restatement (the interpret path takes only tile-divisible shapes)."""
    args = _inputs(4, 4, lq, lk, 16, seed=lq)
    ref = jax.jit(jflash._ref_block_update_hld, static_argnums=(8, 9))
    for causal in (True, False):
        want = ref(*(jnp.asarray(a) for a in args), causal, 0.25)
        _close(_port(args, causal, 0.25), want)


@pytest.mark.parametrize("g", [1, 4])
def test_flash_attention_matches_jax(g):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((32, 4 // g, 16)).astype(np.float32)
    v = rng.standard_normal((32, 4 // g, 16)).astype(np.float32)
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=16, interpret=True))
    got = k2.flash_attention(*from_numpy([q, k, v], "cpu"), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_forward_only():
    """Without grad the update is the forward alone (no graph); with an
    operand that requires grad the gradient flows to q, k and v (the
    backward is tests/test_torch_flash_grad.py's subject)."""
    args = from_numpy(list(_inputs(2, 2, 4, 4, 16, seed=1)), "cpu")
    assert all(t.grad_fn is None for t in k2.flash_block_update_hld(*args))
    for t in args[:3]:
        t.requires_grad_(True)
    m2, l2, o2 = k2.flash_block_update_hld(*args, causal=True)
    grads = torch.autograd.grad(o2.sum() + l2.sum(), args[:3])
    assert all(g.shape == t.shape and bool(torch.isfinite(g).all())
               and bool(g.abs().sum() > 0) for g, t in zip(grads, args[:3]))


def test_rejects_bad_operands():
    q, k, v, m, l, o, qp, kp = from_numpy(list(_inputs(4, 3, 4, 4, 16, 2)),
                                          "cpu")
    with pytest.raises(ValueError, match="multiple"):
        k2.flash_block_update_hld(q, k, v, m, l, o, qp, kp)
    q, k, v, m, l, o, qp, kp = from_numpy(list(_inputs(4, 2, 4, 4, 16, 2)),
                                          "cpu")
    with pytest.raises(ValueError, match="float32"):
        k2.flash_block_update_hld(q, k, v, m.double(), l, o, qp, kp)


def test_no_fallback_off_cpu():
    args = [t.to("meta") for t in
            from_numpy(list(_inputs(2, 2, 4, 4, 16, seed=3)), "cpu")]
    with pytest.raises(ValueError, match="cpu or cuda"):
        k2.flash_block_update_hld(*args)
    assert k2.flash_block_update_hld.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(k2, "_fn", None)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load("flash")
    with pytest.raises(build.KernelBuildError):
        k2._kernel()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hk,lq,lk,d", [(8, 8, 100, 130, 64),
                                          (8, 2, 64, 64, 128),
                                          (4, 1, 33, 7, 16)])
def test_kernel_matches_plain_on_card(cuda, h, hk, lq, lk, d, dtype):
    args = from_numpy(list(_inputs(h, hk, lq, lk, d, seed=lq)), cuda)
    args[:3] = [t.to(dtype) for t in args[:3]]
    for causal in (True, False):
        before = k2.flash_block_update_hld.launches
        got = k2.flash_block_update_hld(*args, causal=causal, scale=0.125)
        torch.cuda.synchronize()
        assert k2.flash_block_update_hld.launches == before + 1
        want = k2.flash_block_update_hld_plain(*args, causal=causal,
                                               scale=0.125)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
