"""The backward of the collectives: a model-parallel step's transpose rules.

Under ``shard_map``'s varying-manual-axes typing, JAX's autodiff inserts
the transpose of every collective of a per-shard function itself. The
port has no such typing, so the collectives on a training path go
through these ``torch.autograd.Function``s, each the transpose rule JAX
applies:

  - ``ppermute(x, axis, pairs)``: sends along ``pairs``; its backward
    sends the cotangent along the inverted pairs (a rank that sent
    nothing gets a zero gradient, as ``lax.ppermute``'s transpose gives);
  - ``all_to_all(x, axis)``: row s to rank s; its backward is the same
    exchange of the cotangent (the exchange is its own inverse);
  - ``psum_invariant(x, axis)``: the sum over the axis, a value every
    rank holds alike; its backward passes the cotangent on unchanged (the
    transpose of a psum into an invariant value is no collective);
  - ``pvary(x, axis)``: the identity where an axis-invariant value meets
    an axis-sharded one (a tensor-parallel weight); its backward sums the
    cotangent over the axis.

Each is the plain ``Axis`` call when grad mode is off or ``x`` needs no
gradient. The backward runs its collective on the thread that runs the
rank's backward: a CPU ``LocalMesh`` rank's own thread, or a process of
its own (``DistAxis``) on a card (``parallel.mesh``).
"""

from __future__ import annotations

import torch

from rlo_tpu_torch.parallel.mesh import Pairs


def needs_grad(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x`` here."""
    return torch.is_grad_enabled() and x.requires_grad


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, pairs):
        ctx.axis, ctx.pairs = axis, tuple(pairs)
        return axis.ppermute(x, pairs)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.pairs]
        return ctx.axis.ppermute(g.contiguous(), back), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_to_all(g.contiguous()), None


class _PsumInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.contiguous(), "sum"), None


def ppermute(x: torch.Tensor, axis, pairs: Pairs) -> torch.Tensor:
    """``axis.ppermute(x, pairs)``; differentiable (the inverted pairs)."""
    if needs_grad(x):
        return _PPermute.apply(x, axis, pairs)
    return axis.ppermute(x, pairs)


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """``axis.all_to_all(x)``; differentiable (the same exchange)."""
    if needs_grad(x):
        return _AllToAll.apply(x, axis)
    return axis.all_to_all(x)


def psum_invariant(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; its backward is the identity."""
    if needs_grad(x):
        return _PsumInvariant.apply(x, axis)
    return axis.all_reduce(x, "sum")


def pvary(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself; its backward sums the cotangent over ``axis``."""
    if axis is not None and needs_grad(x):
        return _PVary.apply(x, axis)
    return x
