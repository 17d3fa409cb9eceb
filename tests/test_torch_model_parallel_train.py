"""The port's sequence-, tensor- and expert-parallel training against the
JAX package on the CPU.

The JAX package runs ``train_step`` (and ``train_step_optax``,
``forward`` under ``jax.grad``) under ``shard_jit`` with vma typing on
the 8-device CPU mesh; the port runs the same step with each rank a
thread of a ``device="cpu"`` ``LocalMesh`` (a CPU rank's backward runs
its collectives on its own thread), the plain twins of K2/K4/K5 behind
``FlashBlockUpdate``. The JAX package's params cross with
``params_from_numpy``; tokens come from numpy with a seed; f32
throughout. Each rank's slices come from ``shard_tree`` over the port's
``param_pspecs``, and the updated slices go back together with
``gather_tree``.

Tolerances are those of the reference's own test of the same axis (the
loosest of a combined mesh's axes): the loss rtol 1e-5; params after a
step, sp/dp rtol 1e-4 / atol 1e-5 (``tests/test_transformer.py``), tp
5e-3 / 5e-4 (``tests/test_tensor_parallel.py``), ep 5e-3 / 1e-4
(``tests/test_expert_parallel.py``), Ulysses 2e-3 / 2e-5
(``tests/test_ulysses.py``); Adam under tp takes tp's class (its first
step is lr times the sign of each gradient wherever |g| >> eps, and an
element whose gradient is near eps moves by up to lr with the last bits
of the sums); ``forward``'s gradients rtol 2e-4 / atol 2e-5
(``tests/test_torch_train.py``'s gradient class), tp 5e-3 / 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from rlo_tpu.models import transformer as jt
from rlo_tpu.parallel.mesh import make_mesh, shard_jit
from rlo_tpu_torch.convert import params_from_numpy, params_to_numpy
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.parallel.sharding import (gather_tree, leaf_specs,
                                             shard_tree)

LR = 1e-2
BASE = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            dtype="float32")
GQA = dict(n_kv_heads=2, pos_encoding="rope")
MOE = dict(n_experts=4, capacity_factor=4.0)
SP_TOL = dict(rtol=1e-4, atol=1e-5)
TP_TOL = dict(rtol=5e-3, atol=5e-4)
EP_TOL = dict(rtol=5e-3, atol=1e-4)
ULYSSES_TOL = dict(rtol=2e-3, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _setup(seed, shape, **cfg):
    kw = dict(BASE, **cfg)
    jc, tc = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    jp = jt.init_params(jax.random.PRNGKey(seed), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(seed).integers(0, kw["vocab"], shape) \
        .astype(np.int32)
    return jc, tc, jp, tp, tok


def _row_axes(names):
    return tuple(a for a in ("dcn", "dp", "ep") if a in names)


def _token_spec(names):
    rows = _row_axes(names)
    row = None if not rows else rows[0] if len(rows) == 1 else rows
    return JP(row, "sp" if "sp" in names else None)


def _rank_tokens(tok, axes):
    """The rank's block of the global (batch, seq) tokens: rows over
    dcn, dp and ep (row-major, as ``P(("dp", "ep"))``), the sequence over
    sp."""
    t = torch.from_numpy(tok)
    idx, n = 0, 1
    for a in _row_axes(axes):
        idx, n = idx * axes[a].size + axes[a].index, n * axes[a].size
    rows = t.shape[0] // n
    t = t[idx * rows:(idx + 1) * rows]
    if "sp" in axes:
        blk = t.shape[1] // axes["sp"].size
        t = t[:, axes["sp"].index * blk:(axes["sp"].index + 1) * blk]
    return t.contiguous()


def _specs(mod, cfg, names):
    return mod.param_pspecs(cfg, "tp" if "tp" in names else None,
                            "ep" if "ep" in names else None)


def _axis_kw(names, axes=None):
    return {f"{n}_axis": (n if axes is None else axes[n]) for n in names}


def _jax_step(jc, jp, tok, shape, names):
    mesh = make_mesh(shape, names)
    specs = _specs(jt, jc, names)
    step = shard_jit(lambda p, t: jt.train_step(p, t, jc, lr=LR,
                                                **_axis_kw(names)),
                     mesh, (specs, _token_spec(names)), (specs, JP()))
    return step(jp, jnp.asarray(tok))


def _port_step(tc, tp, tok, shape, names):
    mesh = LocalMesh(shape, names, device="cpu")
    specs = _specs(tt, tc, names)

    def body(axes):
        return tt.train_step(shard_tree(tp, specs, axes),
                             _rank_tokens(tok, axes), tc, lr=LR,
                             **_axis_kw(names, axes))
    outs = mesh.run(body)
    losses = [float(loss) for _, loss in outs]
    assert losses == [losses[0]] * len(losses), losses
    return gather_tree([p for p, _ in outs], specs, mesh), losses[0]


def _assert_close(got, want, tol):
    got = jax.tree.leaves(params_to_numpy(got))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


# (id, config, mesh shape, axis names, global tokens, tolerance)
STEPS = [
    ("sp2_ring", {}, (2,), ("sp",), (2, 32), SP_TOL),
    ("sp4_ring", {}, (4,), ("sp",), (2, 32), SP_TOL),
    ("sp2_ulysses", dict(sp_attention="ulysses"), (2,), ("sp",), (2, 32),
     ULYSSES_TOL),
    ("sp4_ulysses_gqa_rope", dict(sp_attention="ulysses", **GQA), (4,),
     ("sp",), (2, 32), ULYSSES_TOL),
    ("tp2", {}, (2,), ("tp",), (2, 16), TP_TOL),
    ("ep2", MOE, (2,), ("ep",), (4, 16), EP_TOL),
    ("ep4", MOE, (4,), ("ep",), (4, 16), EP_TOL),
    ("ep2_dropping", dict(MOE, capacity_factor=1.0), (2,), ("ep",), (4, 16),
     EP_TOL),
    ("dp2_ep2", MOE, (2, 2), ("dp", "ep"), (8, 16), EP_TOL),
    ("ep2_sp2", MOE, (2, 2), ("ep", "sp"), (4, 32), EP_TOL),
    ("sp2_tp2_gqa_rope", GQA, (2, 2), ("sp", "tp"), (2, 32), TP_TOL),
    ("dp2_sp2", {}, (2, 2), ("dp", "sp"), (4, 32), SP_TOL),
    ("dp2_tp2", {}, (2, 2), ("dp", "tp"), (4, 16), TP_TOL),
    ("tp2_ep2", MOE, (2, 2), ("ep", "tp"), (4, 16), TP_TOL),
    ("dcn2_dp2_tp2", {}, (2, 2, 2), ("dcn", "dp", "tp"), (8, 16), TP_TOL),
    ("dcn2_dp2_sp2", {}, (2, 2, 2), ("dcn", "dp", "sp"), (8, 32), SP_TOL),
]


@pytest.mark.parametrize("cfg,shape,names,tshape,tol",
                         [s[1:] for s in STEPS], ids=[s[0] for s in STEPS])
def test_step_matches_jax(cfg, shape, names, tshape, tol):
    jc, tc, jp, tp, tok = _setup(3, tshape, **cfg)
    want_p, want_loss = _jax_step(jc, jp, tok, shape, names)
    got_p, got_loss = _port_step(tc, tp, tok, shape, names)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    _assert_close(got_p, want_p, tol)


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_dryrun_multichip_3d_step_matches_jax(variant):
    """``__graft_entry__.py:dryrun_multichip``'s (dp 2, sp 2, tp 2) step
    (:103-123) and its GQA variant (one layer, two K/V heads,
    :180-194), on its tokens (4 x 16 from seed 0)."""
    cfg = dict(BASE) if variant == "mha" else dict(BASE, n_layers=1,
                                                   n_kv_heads=2)
    jc, tc = jt.TransformerConfig(**cfg), tt.TransformerConfig(**cfg)
    jp = jt.init_params(jax.random.PRNGKey(0 if variant == "mha" else 3),
                        jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(0).integers(0, 64, (4, 16)).astype(np.int32)
    names, shape = ("dp", "sp", "tp"), (2, 2, 2)
    want_p, want_loss = _jax_step(jc, jp, tok, shape, names)
    got_p, got_loss = _port_step(tc, tp, tok, shape, names)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    _assert_close(got_p, want_p, TP_TOL)
    # and the single device's step, within the same class
    one_p, one_loss = tt.train_step(tp, torch.from_numpy(tok), tc, lr=LR)
    np.testing.assert_allclose(got_loss, float(one_loss), rtol=1e-5)
    _assert_close(got_p, jax.tree.map(np.asarray, params_to_numpy(one_p)),
                  TP_TOL)


def test_adam_under_tp_matches_optax():
    """One ``torch.optim.Adam`` step on a (dp 2, tp 2) mesh, each rank's
    optimizer over its slices, against ``train_step_optax`` with
    ``optax.adam(1e-2)`` and the moments cut by ``opt_state_pspecs``:
    params and both moments."""
    import optax
    names, shape = ("dp", "tp"), (2, 2)
    jc, tc, jp, tp, tok = _setup(8, (4, 16))
    opt = optax.adam(1e-2)
    state = opt.init(jp)
    specs = jt.param_pspecs(jc, "tp")
    sspecs = jt.opt_state_pspecs(state, jp, specs)
    step = shard_jit(lambda p, s, t: jt.train_step_optax(
        p, s, t, jc, opt, dp_axis="dp", tp_axis="tp"),
        make_mesh(shape, names), (specs, sspecs, JP("dp")),
        (specs, sspecs, JP()))
    want_p, want_s, want_loss = step(jp, state, jnp.asarray(tok))
    mesh = LocalMesh(shape, names, device="cpu")
    tspecs = tt.param_pspecs(tc, "tp")

    def body(axes):
        p = shard_tree(tp, tspecs, axes)
        adam = torch.optim.Adam(tt.tree_leaves(p), lr=1e-2)
        p, loss = tt.train_step_optim(p, adam, _rank_tokens(tok, axes), tc,
                                      dp_axis=axes["dp"],
                                      tp_axis=axes["tp"])
        moments = {k: tt._rebuild(p, iter(adam.state[x][k]
                                          for x in tt.tree_leaves(p)))
                   for k in ("exp_avg", "exp_avg_sq")}
        return p, loss, moments, tt.opt_state_pspecs(adam, p, tspecs)
    outs = mesh.run(body)
    adam_tol = TP_TOL
    np.testing.assert_allclose(float(outs[0][1]), float(want_loss),
                               rtol=1e-5)
    _assert_close(gather_tree([o[0] for o in outs], tspecs, mesh), want_p,
                  adam_tol)
    for key, ref in (("exp_avg", want_s[0].mu), ("exp_avg_sq",
                                                 want_s[0].nu)):
        assert outs[0][3][key] == tspecs
        _assert_close(gather_tree([o[2][key] for o in outs], tspecs, mesh),
                      ref, adam_tol)


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_opt_state_pspecs_matches_jax(axis):
    """The spec trees of an Adam state under tp and ep specs against the
    reference's tree for ``optax.adam``: the moments take the params'
    specs, the step counts are replicated."""
    import optax
    cfg = dict(BASE, **(MOE if axis == "ep" else GQA))
    jc, tc = jt.TransformerConfig(**cfg), tt.TransformerConfig(**cfg)
    jp = jt.init_params(jax.random.PRNGKey(1), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    names = (axis,)
    jspecs, tspecs = _specs(jt, jc, names), _specs(tt, tc, names)
    want = jt.opt_state_pspecs(optax.adam(1e-2).init(jp), jp, jspecs)
    adam = torch.optim.Adam(tt.tree_leaves(tp), lr=1e-2)
    for x in tt.tree_leaves(tp):
        x.grad = torch.ones_like(x)
    adam.step()
    got = tt.opt_state_pspecs(adam, tp, tspecs)
    assert set(got) == {"step", "exp_avg", "exp_avg_sq"}

    def plain(tree):
        return [tuple(s) for s in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, (tuple, JP)))]
    assert plain(got["exp_avg"]) == plain(want[0].mu)
    assert plain(got["exp_avg_sq"]) == plain(want[0].nu)
    assert tuple(want[0].count) == ()
    assert all(s == () for s in plain(got["step"]))
    assert tt.opt_state_pspecs(adam.state, tp, tspecs) == got
    assert any("ep" in s or "tp" in s for s in plain(got["exp_avg"]))


# (id, config, mesh shape, axis names, global tokens, all_to_all, tol)
FORWARD_GRADS = [
    ("sp2_ring", {}, (2,), ("sp",), (2, 16), "xla", GRAD_TOL),
    ("sp2_ulysses", dict(sp_attention="ulysses"), (2,), ("sp",), (2, 16),
     "xla", GRAD_TOL),
    ("tp2", GQA, (2,), ("tp",), (2, 16), "xla", TP_TOL),
    ("ep2_xla", MOE, (2,), ("ep",), (4, 16), "xla", GRAD_TOL),
    ("ep2_direct", MOE, (2,), ("ep",), (4, 16), "direct", GRAD_TOL),
    ("ep2_ring", MOE, (2,), ("ep",), (4, 16), "ring", GRAD_TOL),
    ("ep4_ring", MOE, (4,), ("ep",), (4, 16), "ring", GRAD_TOL),
    ("ep2_direct_dropping", dict(MOE, capacity_factor=1.0), (2,), ("ep",),
     (4, 16), "direct", GRAD_TOL),
]


@pytest.mark.parametrize("cfg,shape,names,tshape,a2a,tol",
                         [s[1:] for s in FORWARD_GRADS],
                         ids=[s[0] for s in FORWARD_GRADS])
def test_forward_grad_matches_jax(cfg, shape, names, tshape, a2a, tol):
    """The gradient of sum(logits * c) (c a fixed random cotangent, the
    rank's block of it) through ``forward`` under grad mode, against
    ``jax.grad`` of the JAX package's ``forward`` under ``shard_jit``.
    The port's per-rank gradients are summed over the data-carrying axes
    a leaf is not split over (sp, ep), as vma typing sums them; every
    all_to_all schedule differentiates to the JAX package's values."""
    jc, tc, jp, tp, tok = _setup(5, tshape, **cfg)
    c = np.random.default_rng(6).standard_normal(
        tshape + (BASE["vocab"],)).astype(np.float32)
    kw = _axis_kw(names)

    def jgrad(p, t, cc):
        return jax.grad(lambda q: jnp.sum(jt.forward(q, t, jc, **kw) * cc))(p)
    specs = _specs(jt, jc, names)
    tspec = _token_spec(names)
    want = shard_jit(jgrad, make_mesh(shape, names),
                     (specs, tspec, JP(*tspec, None)), specs)(
        jp, jnp.asarray(tok), jnp.asarray(c))
    mesh = LocalMesh(shape, names, device="cpu")
    tspecs = _specs(tt, tc, names)

    def body(axes):
        p = shard_tree(tp, tspecs, axes)
        leaves = [x.requires_grad_(True) for x in tt.tree_leaves(p)]
        rows = _rank_tokens(tok, axes)
        cc = _rank_tokens(c, axes)
        logits = tt.forward(p, rows, tc, all_to_all_algorithm=a2a,
                            **_axis_kw(names, axes))
        grads = torch.autograd.grad((logits * cc).sum(), leaves)
        out = []
        for g, spec in zip(grads, leaf_specs(p, tspecs)):
            for n in ("sp", "ep"):
                if n in axes and n not in spec:
                    g = axes[n].all_reduce(g, "sum")
            out.append(g)
        return tt._rebuild(p, iter(out))
    got = gather_tree(mesh.run(body), tspecs, mesh)
    _assert_close(got, want, tol)


def test_forward_grad_with_a_manual_tp_schedule_raises():
    """The manual tp schedules accumulate in place and have no backward:
    ``forward`` with one under autograd raises; under ``no_grad`` it
    runs."""
    jc, tc, jp, tp, tok = _setup(5, (2, 8))
    mesh = LocalMesh((2,), ("tp",), device="cpu")
    specs = tt.param_pspecs(tc, "tp")

    def body(axes, grad):
        p = shard_tree(tp, specs, axes)
        for x in tt.tree_leaves(p):
            x.requires_grad_(grad)
        return tt.forward(p, torch.from_numpy(tok), tc, tp_axis=axes["tp"],
                          tp_algorithm="ring")
    with pytest.raises(NotImplementedError, match="no backward"):
        mesh.run(body, [True, True])
    out = mesh.run(body, [False, False])
    assert torch.equal(out[0], out[1])
