"""K1, the fused per-step combine: ``out = op(a, b)`` elementwise.

The port of ``rlo_tpu/pallas/reduce.py:fused_combine`` (Pallas kernel
``_combine_kernel``). ``fused_combine`` launches the CUDA kernel in
``csrc/reduce.cu`` for CUDA tensors and takes ``fused_combine_plain``
only for CPU tensors; a CUDA tensor it cannot take raises.

Semantics (the same in both versions):
  - sum/min/max on floating tensors widen to f32, combine, and cast back
    to ``a.dtype``; min/max propagate NaN;
  - sum/min/max on integer tensors are exact in the integer type (the
    TPU kernel rounds int32 through f32, which is lossy above 2^24; the
    JAX package's default off the TPU is the exact ``jnp`` path);
  - and/or are bitwise on integer (and bool) tensors.

On the card the kernel takes f32, bf16 and int32 for sum/min/max, and
every integer dtype for and/or.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional

import torch

#: the ops K1 combines, in the order of csrc/reduce.cu's op codes
OPS = ("sum", "min", "max", "and", "or")
_OP_CODE = {op: i for i, op in enumerate(OPS)}
#: op codes from here on are bitwise (and, or)
_BITWISE = _OP_CODE["and"]
# dtype codes of csrc/reduce.cu; 0 = bytes (and/or on any integer dtype)
_DT_CODE = {torch.float32: 1, torch.bfloat16: 2, torch.int32: 3}
_INT_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16,
               torch.int32, torch.int64)

_count_lock = threading.Lock()
_fn = None


def fused_combine_plain(a: torch.Tensor, b: torch.Tensor, op: str = "sum",
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1: the CPU path, and the yardstick the
    kernel is held against on the card."""
    _check(a, b, op, out)
    if op in ("and", "or"):
        fn = torch.bitwise_and if op == "and" else torch.bitwise_or
        res = fn(a, b)
    else:
        fn = {"sum": torch.add, "min": torch.minimum,
              "max": torch.maximum}[op]
        if a.dtype.is_floating_point:
            res = fn(a.float(), b.float()).to(a.dtype)
        else:
            res = fn(a, b)
    if out is None:
        return res
    return out.copy_(res)


def _check(a, b, op, out) -> None:
    if op not in _OP_CODE:
        raise ValueError(f"unknown op {op!r}")
    shape = a.shape
    if (shape != b.shape or a.dtype != b.dtype or a.is_cuda != b.is_cuda
            or a.get_device() != b.get_device()):
        raise ValueError(f"operand mismatch: {tuple(a.shape)}/{a.dtype}/"
                         f"{a.device} vs {tuple(b.shape)}/{b.dtype}/"
                         f"{b.device}")
    if op in ("and", "or") and a.dtype not in _INT_DTYPES:
        raise TypeError(f"op {op!r} needs an integer dtype, got {a.dtype}")
    if out is not None and out is not a and (
            out.shape != shape or out.dtype != a.dtype
            or out.is_cuda != a.is_cuda
            or out.get_device() != a.get_device()):
        raise ValueError("out must match a in shape, dtype and device")


#: the parameter block of ``rlo_fused_combine`` (csrc/reduce.cu): a, b,
#: out, n, stream, op, dtype (one ctypes argument, packed in one step)
_PARAMS = struct.Struct("<5Q2i")


def _kernel():
    global _fn
    if _fn is None:
        from rlo_tpu_torch.kernels import build
        f = build.load("reduce").rlo_fused_combine
        f.argtypes = [ctypes.c_char_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def fused_combine(a: torch.Tensor, b: torch.Tensor, op: str = "sum",
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise ``op(a, b)`` as one kernel launch; ``out`` may be
    ``a`` itself (the accumulate path). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check(a, b, op, out)
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"fused_combine runs on cpu or cuda, not "
                             f"{a.device}")
        return fused_combine_plain(a, b, op, out)
    if not (a.is_contiguous() and b.is_contiguous()
            and (out is None or out is a or out.is_contiguous())):
        name = next(n for n, t in (("a", a), ("b", b), ("out", out))
                    if not t.is_contiguous())
        raise ValueError(f"fused_combine needs contiguous tensors "
                         f"({name} is not)")
    code = _OP_CODE[op]
    if code >= _BITWISE:
        dt, n = 0, a.numel() * a.element_size()
    else:
        dt = _DT_CODE.get(a.dtype)
        if dt is None:
            raise TypeError(f"the CUDA kernel takes float32, bfloat16 and "
                            f"int32 for {op!r}, not {a.dtype}")
        n = a.numel()
    if out is None:
        out = torch.empty_like(a)
    if n == 0:
        return out
    fn = _fn or _kernel()
    index = a.get_device()
    # the raw handle of the current stream (no Stream object), and no
    # device switch when the tensors' device is already the current one
    params = _PARAMS.pack(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                          torch._C._cuda_getCurrentRawStream(index), code,
                          dt)
    if torch._C._cuda_getDevice() == index:
        rc = fn(params)
    else:
        with torch.cuda.device(index):
            rc = fn(params)
    if rc != 0:
        raise RuntimeError(f"fused_combine kernel launch failed: CUDA "
                           f"error {rc} (op={op}, dtype={a.dtype}, n={n})")
    with _count_lock:
        fused_combine.launches += 1
    return out


#: kernel launches so far (CPU tensors never count); a run sets it to 0
#: and reads it to show its path went through the kernel
fused_combine.launches = 0


class FusedCombine(torch.autograd.Function):
    """``fused_combine(a, b, op)`` out of place, with a backward: the
    differentiable step of the manual schedules (``FusedCombine.apply(a,
    b, op, use_kernel)``). The forward is K1 on CUDA tensors and the
    plain version on CPU tensors, or the plain version everywhere with
    ``use_kernel`` False. The backward is ``jax.grad``'s rule for
    ``lax.add``/``lax.max``/``lax.min``: (g, g) for sum; for min/max,
    with z = op(a, b), JAX's ``_balanced_eq``:
    da = g [a == z] / (1 + [b == z]) and db = g [b == z] / (1 + [a == z]),
    so the cotangent goes to the operand that won, split in half where
    they tie, and to neither where a NaN won (NaN equals nothing). It is
    computed in f32, as the plain version widens, and cast to the
    operand's dtype. and/or take integers, which carry no gradient."""

    @staticmethod
    def forward(ctx, a, b, op, use_kernel=True):
        if op not in ("sum", "min", "max"):
            raise ValueError(f"op {op!r} has no gradient")
        ctx.op = op
        if op != "sum":
            ctx.save_for_backward(a, b)
        return (fused_combine if use_kernel else fused_combine_plain)(
            a, b, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "sum":
            return g, g, None, None
        a, b = ctx.saved_tensors
        af, bf, gf = a.float(), b.float(), g.float()
        z = (torch.maximum if ctx.op == "max" else torch.minimum)(af, bf)
        a_won, b_won = (af == z).float(), (bf == z).float()
        # g times the share, as JAX multiplies (-0 for a negative g)
        da, db = gf * (a_won / (1 + b_won)), gf * (b_won / (1 + a_won))
        return da.to(a.dtype), db.to(b.dtype), None, None
