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


def _tensor_core_emulation(q, k, v, m, l, o, qp, kp, causal, scale,
                           split=True):
    """K2's bf16 route restated in torch on the CPU: scores as sums of
    exact bf16 products in f32 over 16-wide steps of d, an f32 multiply by
    scale, and P.V with p split exactly as p_hi = bf16(p), p_lo = bf16(p -
    p_hi) (or, with ``split`` False, rounded once to bf16, the usual
    FlashAttention choice)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.zeros(q.shape[0], q.shape[1], k.shape[1])
    for d0 in range(0, q.shape[2], 16):
        s = s + torch.einsum("hqd,hkd->hqk", qf[..., d0:d0 + 16],
                             kf[..., d0:d0 + 16])
    s = s * scale
    mask = (kp[0][None, :] <= qp[0][:, None])[None] if causal else \
        torch.ones_like(s, dtype=torch.bool)
    s = torch.where(mask, s, k2.NEG)
    m_new = torch.maximum(m[:, 0, :], s.amax(-1))
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    p_hi = p.to(torch.bfloat16).float()
    p_lo = (p - p_hi).to(torch.bfloat16).float() if split else \
        torch.zeros_like(p)
    corr = torch.exp(m[:, 0, :] - m_new)
    l_new = l[:, 0, :] * corr + (p_hi + p_lo).sum(-1)
    o_new = o * corr[..., None] + torch.einsum("hqk,hkd->hqd", p_hi, vf) \
        + torch.einsum("hqk,hkd->hqd", p_lo, vf)
    return m_new[:, None, :], l_new[:, None, :], o_new


@pytest.mark.parametrize("carried", [False, True], ids=["initial", "carried"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
def test_split_p_precision_matches_pallas_interpret(d, causal, carried,
                                                   record_property):
    """The precision argument of the tensor-core route, emulated on the
    CPU: bf16 score products with the f32 scale multiply and P.V with the
    exact p_hi/p_lo split stay within rtol 1e-4 (atol 1e-4 per unit of the
    largest value) of the Pallas kernel in interpret mode. How far the
    single-bf16 p lies from it is reported, not asserted."""
    args = _inputs(4, 4, 64, 64, d, seed=d + causal, bf16=True,
                   carried=carried)
    want = [np.asarray(w) for w in jflash.flash_block_update_hld(
        *(jnp.asarray(a) for a in args), causal=causal, scale=0.125,
        block_q=16, interpret=True)]
    ts = from_numpy(list(args), "cpu")
    got = to_numpy(list(_tensor_core_emulation(*ts, causal, 0.125)))
    single = to_numpy(list(_tensor_core_emulation(*ts, causal, 0.125,
                                                  split=False)))
    unit = max(1.0, float(np.abs(want[2]).max()))
    dev = {"split": float(np.abs(got[2] - want[2]).max()) / unit,
           "single": float(np.abs(single[2] - want[2]).max()) / unit}
    record_property("o_dev_per_unit", dev)
    print(f"o' from the reference, per unit of max|o'|: split p "
          f"{dev['split']:.3g}, single-bf16 p {dev['single']:.3g}")
    for name, g, w in zip("mlo", got, want):
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(w).max())),
            err_msg=f"{name}': split p {dev['split']:.3g} and single-bf16 "
                    f"p {dev['single']:.3g} from the reference (o', per "
                    f"unit of max|o'|)")


def test_cuda_checks_want_aligned_bf16():
    """The tensor-core route copies 16-byte chunks: a bf16 operand that
    does not start on 16 bytes is refused before any launch (the check
    reads only pointers, so it runs on CPU tensors; the wrappers copy
    such an operand first, see the next test)."""
    q, k, v, m, l, o, qp, kp = from_numpy(list(_inputs(2, 2, 4, 4, 16, 1)),
                                          "cpu")
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    ops = dict(q=q, k=k, v=v, m=m, l=l, o=o, q_pos=qp, k_pos=kp)
    k2._cuda_checks("K2", ops, 16)
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:]
    ops["k"] = shifted.reshape(q.shape)
    assert ops["k"].is_contiguous() and ops["k"].data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        k2._cuda_checks("K2", ops, 16)
    f32 = torch.zeros(q.numel() + 1)[1:].reshape(q.shape)
    assert f32.data_ptr() % 16
    ops.update(q=f32, k=f32, v=f32)
    k2._cuda_checks("K2", ops, 16)  # f32 takes the CUDA-core route


def test_launch_operands_copy_views_and_misaligned_staged():
    """The wrappers' copy decision reads only strides and pointers, so it
    runs on CPU tensors: an operand that is not contiguous, or that the
    bf16 route copies in 16-byte chunks (q, k, v, do') and that does not
    start on 16 bytes, becomes a fresh contiguous copy with the same
    values; every other operand reaches the kernel as it is."""
    q, k, v, m, l, o, qp, kp = from_numpy(list(_inputs(2, 2, 8, 8, 16, 1)),
                                          "cpu")

    def shifted(t):  # the same values one element into a storage
        s = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
        return s.copy_(t)

    def transposed(t):
        return t.transpose(1, 2).contiguous().transpose(1, 2)

    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        ops = dict(q=transposed(qd), k=shifted(kd), v=vd, m2=m,
                   dl2=shifted(l), do2=shifted(o), route=m, q_pos=qp,
                   k_pos=kp)
        assert ops["k"].is_contiguous() and ops["k"].data_ptr() % 16
        out = k2._launch_operands("K4", ops, 16)
        staged = dtype == torch.bfloat16
        copied = {"q"} | ({"k", "do2"} if staged else set())
        for name, t in out.items():
            assert (t is not ops[name]) == (name in copied), (dtype, name)
            assert t.is_contiguous() and torch.equal(t, ops[name])
            if name in copied:
                assert t.data_ptr() % 16 == 0
    # a misaligned bf16 q is copied, where _cuda_checks alone refuses it
    ops = dict(q=shifted(q.to(torch.bfloat16)), k=k.to(torch.bfloat16),
               v=v.to(torch.bfloat16), m=m, l=l, o=o, q_pos=qp, k_pos=kp)
    with pytest.raises(ValueError, match="aligned"):
        k2._cuda_checks("K2", ops, 16)
    assert k2._launch_operands("K2", ops, 16)["q"].data_ptr() % 16 == 0


def test_profilers_group_both_k2_routes():
    """The profilers file K2's two instantiated kernels (the bf16
    tensor-core and the f32 CUDA-core route) under K2 by name: the
    decode profiler and the benchmark's trace."""
    from portbench import trace
    from rlo_tpu_torch.tools import profile_decode
    for name in ("void (anonymous namespace)::flash_fwd_mma_kernel<64>(...)",
                 "void (anonymous namespace)::flash_fwd_f32_kernel<64>(...)"):
        assert profile_decode._group(name) == "K2 flash"
        assert trace.group(name) == "K2 flash forward"


def test_profile_train_groups_both_backward_routes():
    """The benchmark's trace, which profiles the training step, files
    K4's and K5's instantiated kernels (the bf16 tensor-core and the f32
    CUDA-core route) under K4 and K5 by name."""
    from portbench import trace
    for route in ("mma", "f32"):
        for kern, group in (("dq", "K4 flash dq"), ("dkv", "K5 flash dk/dv")):
            name = (f"void (anonymous namespace)::flash_bwd_{kern}_{route}"
                    f"_kernel<64>(...)")
            assert trace.group(name) == group


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
