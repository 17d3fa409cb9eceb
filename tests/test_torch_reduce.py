"""K1, the fused combine: the port's plain version against the Pallas
kernel (interpret mode on the CPU, as tests/test_pallas_reduce.py runs
it), and the CUDA kernel against the plain version on the card.

Exact match everywhere (same f32 upcast, same rounding back), except
int32 values above 2^24: the Pallas kernel rounds int32 through f32 and
loses them, while the JAX package's default path off a TPU (``jnp``) is
exact, and the port holds to that path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.pallas.reduce import fused_combine as jax_fused_combine
from rlo_tpu_torch.convert import from_numpy, to_numpy
from rlo_tpu_torch.kernels import build
from rlo_tpu_torch.kernels import reduce as k1

SHAPES = [(8, 128), (1,), (513,), (3, 5, 7)]


def _operands(shape, dtype, seed, nan=False):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        a = rng.integers(-1000, 1000, shape).astype(np.int32)
        b = rng.integers(-1000, 1000, shape).astype(np.int32)
        return a, b
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    if nan:
        a.reshape(-1)[::3] = np.nan
        b.reshape(-1)[1::4] = np.nan
    if dtype == "bfloat16":
        a = np.asarray(jnp.asarray(a, jnp.bfloat16))
        b = np.asarray(jnp.asarray(b, jnp.bfloat16))
    return a, b


def _port(a, b, op):
    ta, tb = from_numpy([a, b], "cpu")
    return to_numpy([k1.fused_combine(ta, tb, op=op)])[0]


CASES = ([(dt, op) for dt in ("float32", "bfloat16")
          for op in ("sum", "min", "max")]
         + [("int32", op) for op in ("sum", "min", "max", "and", "or")])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,op", CASES)
def test_plain_matches_pallas_kernel(dtype, op, shape):
    a, b = _operands(shape, dtype, seed=len(shape) + len(op))
    want = np.asarray(jax_fused_combine(jnp.asarray(a), jnp.asarray(b),
                                        op=op, interpret=True))
    got = _port(a, b, op)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["min", "max"])
def test_min_max_propagate_nan(dtype, op):
    a, b = _operands((4, 33), dtype, seed=7, nan=True)
    want = np.asarray(jax_fused_combine(jnp.asarray(a), jnp.asarray(b),
                                        op=op, interpret=True))
    got = _port(a, b, op).astype(np.float32)
    assert np.isnan(got).sum() > 0
    # NaN exactly where JAX has NaN, every other value equal
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_int32_above_2_24_is_exact(op):
    """The port is exact where the Pallas kernel rounds through f32:
    it matches JAX's jnp path (the default off a TPU) bit for bit."""
    big = np.array([2 ** 24 + 1, 2 ** 30 + 3, -(2 ** 27) - 5, 123456789],
                   np.int32)
    other = np.array([2 ** 24 + 3, 7, -(2 ** 27) - 4, 1], np.int32)
    jnp_op = {"sum": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[op]
    want = np.asarray(jnp_op(jnp.asarray(big), jnp.asarray(other)))
    np.testing.assert_array_equal(_port(big, other, op), want)
    if op == "sum":  # the reference kernel's own quirk, pinned here
        tpu = np.asarray(jax_fused_combine(jnp.asarray(big),
                                           jnp.asarray(other), op=op,
                                           interpret=True))
        assert not np.array_equal(tpu, want)


def test_out_aliases_first_operand():
    a = torch.arange(10, dtype=torch.float32)
    b = torch.full((10,), 2.0)
    res = k1.fused_combine(a, b, op="sum", out=a)
    assert res is a
    np.testing.assert_array_equal(a.numpy(), np.arange(10) + 2.0)


def test_and_or_on_other_integer_dtypes():
    a = torch.tensor([0b1100, 0b1010, -1], dtype=torch.int16)
    b = torch.tensor([0b1010, 0b0110, 5], dtype=torch.int16)
    assert k1.fused_combine(a, b, "and").tolist() == [0b1000, 0b0010, 5]
    assert k1.fused_combine(a, b, "or").tolist() == [0b1110, 0b1110, -1]


def test_rejects_bad_operands():
    with pytest.raises(ValueError):
        k1.fused_combine(torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError):
        k1.fused_combine(torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        k1.fused_combine(torch.zeros(4), torch.zeros(4), op="xor")
    with pytest.raises(TypeError):
        k1.fused_combine(torch.zeros(4), torch.zeros(4), op="and")


def test_no_fallback_off_cpu():
    """A tensor that is not on the CPU never takes the plain version."""
    a = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        k1.fused_combine(a, a)
    assert k1.fused_combine.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Asked for the kernel on a machine without the CUDA toolkit, the
    build raises a clear error instead of falling back."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load("reduce")
    monkeypatch.setattr(k1, "_fn", None)
    with pytest.raises(build.KernelBuildError):
        k1._kernel()


def test_every_kernel_source_is_listed():
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == [
        "decode.cu", "flash.cu", "reduce.cu"]
    for name in ("reduce", "flash", "decode"):
        lib = build._lib_path(name)
        assert lib.parent == build.BUILD_DIR
        assert lib.name.startswith(f"lib{name}-")


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
