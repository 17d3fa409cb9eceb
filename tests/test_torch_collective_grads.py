"""The gradients of the port's rootless collectives against ``jax.grad``
of the JAX package's under ``shard_jit`` (vma typing on), on the CPU.

The JAX side is ``jax.vjp`` of the per-shard function over the 8-device
CPU mesh (``use_pallas=False``: the ``jnp`` combine); the port's side
runs each rank as a thread of a ``device="cpu"`` ``LocalMesh`` and takes
``torch.autograd.grad`` of its own result with its own block of the same
cotangent. A manual schedule's result varies over its axis, so its
gradient is that of the sum of every rank's loss (the transposes of the
schedule's ``ppermute``s carry the cross-rank terms); psum's is the
invariant result whose cotangent every rank holds alike (out_specs
without the axis on the JAX side).

Tolerances: sum through a manual schedule rtol 1e-6 / atol 1e-6 (the
forward keeps the schedule's order; the transposes' cotangent sums may
add in another order than XLA's, a few ulps of values of order 1);
min/max exact (integer-valued inputs with ties, integer cotangents: the
halves at a tie are exact); ``all_gather('xla')`` and the ``gather``
bcast rtol 1e-6 too (their backward sums over the axis in rank order,
XLA's ``psum_scatter`` in its own). The int8 hierarchical hop's gradient
flows through the scales only, through f64 on the port's side and f32 on
the JAX side: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rlo_tpu.ops import tpu_collectives as tc
from rlo_tpu.parallel.mesh import make_mesh, shard_jit
from rlo_tpu_torch.ops import device_collectives as dc
from rlo_tpu_torch.parallel import autodiff
from rlo_tpu_torch.parallel.mesh import LocalMesh

N = 23                      # a rank's payload: ragged to every chunking
SUM_TOL = dict(rtol=1e-6, atol=1e-6)
INT8_TOL = dict(rtol=1e-5, atol=1e-6)
ANY_WS = [2, 3, 4, 5, 8]
POW2 = [2, 4, 8]


def _inputs(ws, op, seed):
    """A rank's x (N) and the global cotangent's rows: integer-valued
    with many ties for min/max, normal for sum."""
    rng = np.random.default_rng(seed + 7 * ws)
    if op == "sum":
        return rng.standard_normal((ws, N)).astype(np.float32), rng
    return rng.integers(-2, 3, (ws, N)).astype(np.float32), rng


def _cotangent(rng, shape, op):
    if op == "sum":
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(-4, 5, shape).astype(np.float32)


def jax_grad(fn, x, ct, shape=None, names=("x",), invariant=None):
    """x: (ranks, N) rows in row-major mesh order; ct: the global
    cotangent, (ranks, ...) for a varying result, or (size of the axes
    the result varies over, ...) when ``invariant`` names the axes it is
    invariant over (dropped from out_specs)."""
    shape = shape or (x.shape[0],)
    mesh = make_mesh(shape, names)
    spec = P(names if len(names) > 1 else names[0])
    kept = names
    if invariant:
        kept = tuple(n for n in names if n not in invariant)
        out = P(kept if len(kept) > 1 else kept[0]) if kept else P()
    else:
        out = spec
    wrap = (lambda v: fn(v)) if invariant and not kept else \
        (lambda v: fn(v)[None])
    f = shard_jit(wrap, mesh, spec, out)
    _, vjp = jax.vjp(f, jnp.asarray(x.reshape(-1)))
    (g,) = vjp(jnp.asarray(ct))
    return np.asarray(g).reshape(x.shape)


def port_grad(fn, x, cts, shape=None, names=("x",), dtype=torch.float32):
    """Each rank r: y = fn(x[r], axes), grad of y against cts[r]; x and
    the cotangents cast to ``dtype`` first, the gradient back to f32."""
    shape = shape or (x.shape[0],)
    mesh = LocalMesh(shape, names, device="cpu", timeout=60)

    def body(axes, v, c):
        v = v.clone().requires_grad_(True)
        y = fn(v, axes)
        (g,) = torch.autograd.grad(y, v, c)
        return g
    outs = mesh.run(body, [r.to(dtype) for r in torch.from_numpy(x)],
                    [torch.from_numpy(np.ascontiguousarray(c)).to(dtype)
                     for c in cts])
    return np.stack([o.float().numpy() for o in outs])


def _check(got, want, op):
    if op == "sum":
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        np.testing.assert_array_equal(got, want)


ALLREDUCE = [(alg, ws, op) for op in ("sum", "min", "max")
             for alg, worlds in (("ring", ANY_WS), ("bidir_ring", ANY_WS),
                                 ("recursive_doubling", POW2),
                                 ("halving_doubling", POW2))
             for ws in worlds]


@pytest.mark.parametrize("alg,ws,op", ALLREDUCE,
                         ids=[f"{a}-ws{w}-{o}" for a, w, o in ALLREDUCE])
def test_allreduce_grad(alg, ws, op):
    """Every manual allreduce: sum gives each rank the sum of every
    rank's cotangent; min/max give it to the rank holding the extreme,
    split at each combine where operands tie."""
    x, rng = _inputs(ws, op, 1)
    ct = _cotangent(rng, (ws, N), op)
    want = jax_grad(lambda v: tc.allreduce(v, "x", op=op, algorithm=alg,
                                           use_pallas=False), x, ct)
    got = port_grad(lambda v, a: dc.allreduce(v, a["x"], op=op,
                                              algorithm=alg), x, ct)
    _check(got, want, op)
    if op == "sum":
        np.testing.assert_allclose(got, np.broadcast_to(ct.sum(0), x.shape),
                                   **SUM_TOL)


@pytest.mark.parametrize("ws", [2, 3, 4])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_bidir_ring_grad_pipelined(ws, op):
    """The bidirectional ring with two sub-chunks a row (its default on
    a card), its padding and rank-relative roll under grad."""
    x, rng = _inputs(ws, op, 2)
    ct = _cotangent(rng, (ws, N), op)
    want = jax_grad(lambda v: tc.allreduce(
        v, "x", op=op, algorithm="bidir_ring", use_pallas=False,
        pipeline_chunks=2), x, ct)
    got = port_grad(lambda v, a: dc.allreduce(
        v, a["x"], op=op, algorithm="bidir_ring", pipeline_chunks=2), x, ct)
    _check(got, want, op)


def test_max_grad_three_way_tie():
    """Three ranks tie for the max: the cotangent splits in half at each
    combine, so the shares follow the schedule's order (ring, ws 4)."""
    x = np.zeros((4, 1), np.float32)
    x[[0, 1, 3], 0] = 5.0
    x[2, 0] = 1.0
    ct = np.full((4, 1), 8.0, np.float32)
    x = np.repeat(x, 4, axis=1)
    ct = np.repeat(ct, 4, axis=1)
    for alg in ("ring", "recursive_doubling", "halving_doubling"):
        want = jax_grad(lambda v: tc.allreduce(v, "x", op="max",
                                               algorithm=alg,
                                               use_pallas=False), x, ct)
        got = port_grad(lambda v, a: dc.allreduce(v, a["x"], op="max",
                                                  algorithm=alg), x, ct)
        np.testing.assert_array_equal(got, want)
        assert got[2].sum() == 0 and got.sum() == 4 * 8.0 * 4


@pytest.mark.parametrize("op", ["min", "max"])
def test_psum_min_max_under_grad_raises(op):
    """lax.pmin/lax.pmax have no differentiation rule; the port's psum
    min/max refuse autograd the same way, before any collective."""
    x = np.ones((2, 4), np.float32)
    with pytest.raises(NotImplementedError, match="Differentiation rule"):
        jax_grad(lambda v: tc.allreduce(v, "x", op=op, algorithm="psum"),
                 x, x)
    with pytest.raises(NotImplementedError, match="no backward"):
        port_grad(lambda v, a: dc.allreduce(v, a["x"], op=op,
                                            algorithm="psum"), x, x)


def test_psum_sum_grad_is_invariant():
    """psum's sum: an invariant result whose cotangent every rank holds
    alike; its backward is the identity."""
    x, rng = _inputs(4, "sum", 3)
    ct = rng.standard_normal(N).astype(np.float32)
    want = jax_grad(lambda v: tc.allreduce(v, "x", algorithm="psum"), x, ct,
                    invariant=("x",))
    got = port_grad(lambda v, a: dc.allreduce(v, a["x"], algorithm="psum"),
                    x, [ct] * 4)
    np.testing.assert_array_equal(got, want)


RS = [("ring", ws) for ws in ANY_WS] + [("halving", ws) for ws in POW2]


@pytest.mark.parametrize("alg,ws", RS, ids=[f"{a}-ws{w}" for a, w in RS])
def test_reduce_scatter_grad(alg, ws):
    """Rank r's gradient is the all-gather of the cotangents (cut to the
    payload); the port gave rank 0 a piece and the others zero before
    (ROADMAP Queue 3, F2)."""
    x, rng = _inputs(ws, "sum", 4)
    chunk = -(-N // ws)
    ct = _cotangent(rng, (ws, chunk), "sum")
    want = jax_grad(lambda v: tc.reduce_scatter(v, "x", algorithm=alg,
                                                use_pallas=False), x, ct)
    got = port_grad(lambda v, a: dc.reduce_scatter(v, a["x"],
                                                   algorithm=alg), x, ct)
    np.testing.assert_allclose(got, want, **SUM_TOL)
    np.testing.assert_array_equal(
        got, np.broadcast_to(ct.reshape(-1)[:N], x.shape))


AG = [(alg, ws) for alg in ("xla", "ring") for ws in ANY_WS] + \
    [("doubling", ws) for ws in POW2]


@pytest.mark.parametrize("alg,ws", AG, ids=[f"{a}-ws{w}" for a, w in AG])
def test_all_gather_grad(alg, ws):
    """Rank r's gradient is row r of the sum of every rank's cotangent
    (``lax.all_gather``'s transpose is ``psum_scatter``); the port gave
    each rank its own cotangent's row before (F2)."""
    x, rng = _inputs(ws, "sum", 5)
    ct = _cotangent(rng, (ws, ws, N), "sum")
    want = jax_grad(lambda v: tc.all_gather(v, "x", algorithm=alg), x, ct)
    got = port_grad(lambda v, a: dc.all_gather(v, a["x"], algorithm=alg),
                    x, ct)
    np.testing.assert_allclose(got, want, **SUM_TOL)
    np.testing.assert_allclose(got, ct.sum(0), **SUM_TOL)


BCAST = [(s, ws) for s in ("binomial", "skip_ring", "gather")
         for ws in ANY_WS]


@pytest.mark.parametrize("schedule,ws", BCAST,
                         ids=[f"{s}-ws{w}" for s, w in BCAST])
def test_rootless_bcast_grad(schedule, ws):
    """The origin's gradient is the sum of every rank's cotangent, every
    other rank's zero (a tensor, not None); the port gave the origin its
    own cotangent and binomial's other ranks None before (F2)."""
    x, rng = _inputs(ws, "sum", 6)
    ct = _cotangent(rng, (ws, N), "sum")
    origin = ws - 1 if ws < 3 else 2
    want = jax_grad(lambda v: tc.rootless_bcast(v, origin, "x",
                                                schedule=schedule), x, ct)
    got = port_grad(lambda v, a: dc.rootless_bcast(v, origin, a["x"],
                                                   schedule=schedule), x, ct)
    np.testing.assert_allclose(got, want, **SUM_TOL)
    expect = np.zeros_like(x)
    expect[origin] = ct.sum(0)
    np.testing.assert_allclose(got, expect, **SUM_TOL)


def test_f2_smallest_separating_input():
    """F2's probe: ws 2, one element a rank, cotangent 1. JAX gives
    reduce_scatter [1, 1] (the all-gather of the cotangents), all_gather
    [2, 2] (each row's cotangent summed over the ranks) and the
    binomial bcast from rank 0 [2, 0]; the port gave [1, 0], [1, 1] and
    [1, None]."""
    x = np.array([[1.0], [2.0]], np.float32)
    cases = [
        (lambda v: tc.reduce_scatter(v, "x", algorithm="ring",
                                     use_pallas=False),
         lambda v, a: dc.reduce_scatter(v, a["x"], algorithm="ring"),
         (2, 1), [1.0, 1.0]),
        (lambda v: tc.all_gather(v, "x"),
         lambda v, a: dc.all_gather(v, a["x"]), (2, 2, 1), [2.0, 2.0]),
        (lambda v: tc.rootless_bcast(v, 0, "x"),
         lambda v, a: dc.rootless_bcast(v, 0, a["x"]), (2, 1), [2.0, 0.0]),
    ]
    for jfn, pfn, shape, expect in cases:
        ct = np.ones(shape, np.float32)
        want = jax_grad(jfn, x, ct)
        got = port_grad(pfn, x, ct)
        np.testing.assert_array_equal(want[:, 0], expect)
        np.testing.assert_array_equal(got, want)


HIER = [((2, 4), "psum", "auto"), ((2, 4), "ring", "auto"),
        ((2, 4), "int8", "auto"), ((2, 2), "psum", "ring"),
        ((2, 2), "recursive_doubling", "halving"), ((2, 3), "ring", "auto"),
        ((1, 4), "psum", "auto")]


@pytest.mark.parametrize("shape,dcn_alg,ici_alg", HIER,
                         ids=[f"{s[0]}x{s[1]}-{d}-{i}" for s, d, i in HIER])
def test_hierarchical_allreduce_grad(shape, dcn_alg, ici_alg):
    """Each step differentiates as it does alone: with psum over dcn the
    result is invariant over dcn (4x on (2, 4) with unit cotangents),
    with a manual dcn schedule or int8 it varies over both axes (8x; int8
    through the scales only)."""
    nd, ni = shape
    x, rng = _inputs(nd * ni, "sum", 8)
    psum = dcn_alg == "psum" and nd > 1
    rows = ni if psum else nd * ni
    ct = _cotangent(rng, (rows, N), "sum")
    want = jax_grad(lambda v: tc.hierarchical_allreduce(
        v, "ici", "dcn", dcn_algorithm=dcn_alg, ici_algorithm=ici_alg,
        use_pallas=False), x, ct, shape, ("dcn", "ici"),
        invariant=("dcn",) if psum else None)
    cts = [ct[r % ni] for r in range(nd * ni)] if psum else ct
    got = port_grad(lambda v, a: dc.hierarchical_allreduce(
        v, a["ici"], a["dcn"], dcn_algorithm=dcn_alg, ici_algorithm=ici_alg),
        x, cts, shape, ("dcn", "ici"))
    np.testing.assert_allclose(got, want,
                               **(INT8_TOL if dcn_alg == "int8"
                                  else SUM_TOL))
    if dcn_alg == "int8":
        # only each rank's largest |x| per dcn shard carries a gradient
        assert (got != 0).sum() <= nd * ni * ni
    elif nd > 1:
        ones = np.ones_like(ct)
        cts1 = [ones[r % ni] for r in range(nd * ni)] if psum else ones
        unit = port_grad(lambda v, a: dc.hierarchical_allreduce(
            v, a["ici"], a["dcn"], dcn_algorithm=dcn_alg,
            ici_algorithm=ici_alg), x, cts1, shape, ("dcn", "ici"))
        np.testing.assert_array_equal(unit, ni if psum else nd * ni)


def test_autodiff_all_gather_and_no_grad_bits():
    """``autodiff.all_gather`` under grad gives the stacked rows of the
    plain call, and every manual schedule's forward under grad has the
    no-grad path's bits."""
    ws = 4
    x, _ = _inputs(ws, "sum", 9)
    mesh = LocalMesh((ws,), ("x",), device="cpu", timeout=60)
    fns = [lambda v, a: autodiff.all_gather(v, a),
           lambda v, a: dc.all_gather(v, a, algorithm="ring"),
           lambda v, a: dc.all_gather(v, a, algorithm="doubling"),
           lambda v, a: dc.reduce_scatter(v, a, algorithm="ring"),
           lambda v, a: dc.rootless_bcast(v, 1, a, schedule="skip_ring"),
           lambda v, a: dc.hierarchical_allreduce(v, a, a)]
    fns += [lambda v, a, alg=alg: dc.allreduce(v, a, algorithm=alg,
                                               pipeline_chunks=2)
            for alg in ("ring", "bidir_ring", "recursive_doubling",
                        "halving_doubling")]

    def body(axes, v):
        out = []
        for fn in fns:
            with torch.no_grad():
                plain = fn(v, axes["x"])
            live = fn(v.clone().requires_grad_(True), axes["x"])
            assert live.requires_grad
            out.append(torch.equal(plain, live.detach()))
        return out
    assert all(all(o) for o in mesh.run(body, list(torch.from_numpy(x))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_fused_combine_grad_is_the_plain_versions(dtype, op):
    """K1's ``FusedCombine`` on CPU tensors (the plain version forward)
    gives ``jax.vjp`` of ``jnp.add``/``jnp.minimum``/``jnp.maximum`` bit
    for bit: the winner takes the cotangent, ties split it in half, and
    where a NaN wins neither operand gets a share (JAX's rule; torch's
    autograd of the plain version gives it to both). Its forward is the
    plain version's, bf16 through f32 as the plain version widens."""
    from rlo_tpu_torch.kernels.reduce import FusedCombine, \
        fused_combine_plain
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randint(-3, 4, (257,), generator=g).to(dtype)
            for _ in range(2))
    a[7], b[9], a[11], b[11] = (float("nan"),) * 4
    ct = torch.randn(257, generator=g).to(dtype)
    ka, kb = a.clone().requires_grad_(), b.clone().requires_grad_()
    y = FusedCombine.apply(ka, kb, op)
    got = torch.autograd.grad(y, (ka, kb), ct)
    assert torch.equal(_bits(y.detach()),
                       _bits(fused_combine_plain(a, b, op)))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jfn = {"sum": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[op]
    _, vjp = jax.vjp(jfn, *(jnp.asarray(t.float().numpy()).astype(jdt)
                            for t in (a, b)))
    want = vjp(jnp.asarray(ct.float().numpy()).astype(jdt))
    for x, w in zip(got, want):
        assert x.dtype == dtype
        w = torch.tensor(np.asarray(w.astype(jnp.float32))).to(dtype)
        assert torch.equal(_bits(x), _bits(w))
    if op != "sum":
        for x in got:       # the NaN elements: no share to either operand
            assert (x[[7, 9, 11]] == 0).all()


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "plain"])
def test_f3_smallest_separating_input(use_kernel):
    """F3's probe: ws 2, cotangent 1. Where a NaN wins a min/max, JAX
    gives neither operand the cotangent: ``allreduce`` of x = [nan], [1]
    by ring or recursive doubling gives [0, 0] (torch's rule gave
    [2, 2]); ``reduce_scatter`` max of x = [nan, 1], [1, 2] by ring or
    halving gives [[0, 0], [0, 1]] (torch's rule gave [[1, 0], [1, 1]])."""
    x = np.array([[np.nan], [1.0]], np.float32)
    ct = np.ones((2, 1), np.float32)
    for alg in ("ring", "recursive_doubling"):
        for op in ("max", "min"):
            want = jax_grad(lambda v: tc.allreduce(
                v, "x", op=op, algorithm=alg, use_pallas=False), x, ct)
            got = port_grad(lambda v, a: dc.allreduce(
                v, a["x"], op=op, algorithm=alg, use_kernel=use_kernel),
                x, ct)
            np.testing.assert_array_equal(want, [[0.0], [0.0]])
            np.testing.assert_array_equal(got, want)
    x = np.array([[np.nan, 1.0], [1.0, 2.0]], np.float32)
    for alg in ("ring", "halving"):
        want = jax_grad(lambda v: tc.reduce_scatter(
            v, "x", op="max", algorithm=alg, use_pallas=False), x, ct)
        got = port_grad(lambda v, a: dc.reduce_scatter(
            v, a["x"], op="max", algorithm=alg, use_kernel=use_kernel),
            x, ct)
        np.testing.assert_array_equal(want, [[0.0, 0.0], [0.0, 1.0]])
        np.testing.assert_array_equal(got, want)


MINMAX = [(kind, alg, op, dt, path)
          for kind, alg in (("allreduce", "ring"),
                            ("allreduce", "bidir_ring"),
                            ("allreduce", "recursive_doubling"),
                            ("allreduce", "halving_doubling"),
                            ("reduce_scatter", "ring"),
                            ("reduce_scatter", "halving"))
          for op in ("min", "max") for dt in ("f32", "bf16")
          for path in ("kernel", "plain")]


@pytest.mark.parametrize("kind,alg,op,dt,path", MINMAX,
                         ids=["-".join(c) for c in MINMAX])
def test_min_max_grad_with_nans_and_ties(kind, alg, op, dt, path):
    """Every manual min/max schedule at ws 4, on the kernel path and with
    ``use_kernel=False``, in f32 and bf16: integer-valued inputs with
    ties and NaNs on several ranks (some elements NaN on two ranks), so
    NaN wins some combines and ties split others. Equal to ``jax.vjp``
    bit for bit in both dtypes: the values, the halves at a tie and the
    integer cotangents are exact in bf16 too."""
    import ml_dtypes
    ws = 4
    x, rng = _inputs(ws, op, 11)
    x[0, 3] = x[2, 3] = x[1, 8] = x[3, 15] = x[2, 20] = np.nan
    rows = -(-N // ws) if kind == "reduce_scatter" else N
    ct = _cotangent(rng, (ws, rows), op)
    jx = x.astype(ml_dtypes.bfloat16) if dt == "bf16" else x
    jct = ct.astype(ml_dtypes.bfloat16) if dt == "bf16" else ct
    jop = getattr(tc, kind)
    want = jax_grad(lambda v: jop(v, "x", op=op, algorithm=alg,
                                  use_pallas=False), jx, jct)
    pop = getattr(dc, kind)
    got = port_grad(lambda v, a: pop(v, a["x"], op=op, algorithm=alg,
                                     use_kernel=path == "kernel"), x, ct,
                    dtype=torch.bfloat16 if dt == "bf16" else torch.float32)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert (got[0, 3] == 0) and (got[2, 3] == 0)
