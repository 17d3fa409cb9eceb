"""The port's pipeline-parallel training against the JAX package on the CPU.

The port runs each stage as a thread of a ``device="cpu"`` ``LocalMesh``
on its slices of the stacked params (``pipeline_pspecs`` +
``shard_tree``); the JAX package runs the same schedule under
``shard_jit`` on the 8-device CPU mesh. Both take the JAX package's
params (``params_from_numpy``) and the same seeded numpy tokens; f32
configs: the reference tests' (vocab 32, d 32, 4 heads, 4 layers, d_ff
64) and the GQA and RoPE configs of ``tests/test_gqa.py`` and
``tests/test_rope.py``.

Tolerances, those of ``tests/test_pipeline_parallel.py``: the pipelined
loss within 2e-5 of the flagship loss; a step's loss rtol 1e-5 and its
params rtol 2e-3 / atol 2e-5 against the JAX step and the single-card
``train_step``; 1F1B against GPipe rtol 2e-4 / atol 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from rlo_tpu.models import pipeline as jpl
from rlo_tpu.models import transformer as jt
from rlo_tpu.parallel.mesh import make_mesh, shard_jit
from rlo_tpu_torch.convert import params_from_numpy, params_to_numpy
from rlo_tpu_torch.models import pipeline as tpl
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.parallel.sharding import gather_tree, shard_tree

BASE = dict(vocab=32, d_model=32, n_heads=4, n_layers=4, d_ff=64,
            dtype="float32")
#: tests/test_gqa.py's GQA and tests/test_rope.py's ROPE configs
VARIANTS = {
    "mha": BASE,
    "gqa": dict(vocab=89, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                dtype="float32", n_kv_heads=2),
    "rope": dict(vocab=89, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                 dtype="float32", pos_encoding="rope"),
}
SCHEDULES = {"gpipe": (tpl.pipeline_train_step, jpl.pipeline_train_step),
             "1f1b": (tpl.pipeline_1f1b_train_step,
                      jpl.pipeline_1f1b_train_step)}
STEP_TOL = dict(rtol=2e-3, atol=2e-5)
LR = 0.05


def _model(kw, seed):
    jc, tc = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    jp = jt.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(vocab, batch=8, seq=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, seq)).astype(np.int32)


def _mesh(pp, dp=None):
    if dp is None:
        return LocalMesh((pp,), ("pp",), device="cpu")
    return LocalMesh((dp, pp), ("dp", "pp"), device="cpu")


def _port(tc, params, tokens, pp, fn, dp=None, wrap=None, **kw):
    """fn on every rank of a (dp, pp) CPU mesh; returns (the gathered,
    unstacked new params, every rank's loss, every rank's result)."""
    mesh = _mesh(pp, dp)
    specs = tpl.pipeline_pspecs("pp", tc)
    stacked = tpl.stack_layers(params)
    shards = [shard_tree(stacked, specs, mesh.axes(r))
              for r in range(mesh.world_size)]
    tok = torch.from_numpy(tokens)
    rows = tok.shape[0] // (dp or 1)
    toks = [tok[mesh.coords(r)[0] * rows:(mesh.coords(r)[0] + 1) * rows]
            if dp else tok for r in range(mesh.world_size)]

    def body(axes, p, t):
        pp_axis = axes["pp"] if wrap is None else wrap(axes["pp"])
        return fn(p, t, tc, pp_axis, dp_axis=axes.get("dp"), **kw)
    outs = mesh.run(body, shards, toks)
    new = gather_tree([o[0] for o in outs], specs, mesh)
    return (tpl.unstack_layers(new, tc.n_layers), [float(o[1]) for o in outs],
            outs)


def _jax(jc, jp, tokens, pp, fn, n_micro, dp=None):
    specs = jpl.pipeline_pspecs("pp", jc)
    if dp is None:
        mesh, tok_spec, dp_axis = make_mesh((pp,), ("pp",)), JP(), None
    else:
        mesh = make_mesh((dp, pp), ("dp", "pp"))
        tok_spec, dp_axis = JP("dp"), "dp"
    step = shard_jit(
        lambda p, t: fn(p, t, jc, "pp", n_micro=n_micro, lr=LR,
                        dp_axis=dp_axis),
        mesh, (specs, tok_spec), (specs, JP()))
    new, loss = step(jpl.stack_layers(jp), jnp.asarray(tokens))
    return jpl.unstack_layers(jax.tree.map(np.asarray, new),
                              jc.n_layers), float(loss)


def _close(got, want, what, rtol, atol):
    got = params_to_numpy(got)
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(flat_g) == len(flat_w)
    for (k, a), b in zip(flat_g, flat_w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(k)}")


def _single(tc, tp, tokens):
    return tt.train_step(tp, torch.from_numpy(tokens), tc, lr=LR)


def test_stack_unstack_roundtrip():
    jc, tc, jp, tp = _model(BASE, 0)
    stacked = tpl.stack_layers(tp)
    _close(stacked, jpl.stack_layers(jp), "stacked", 0, 0)
    rt = tpl.unstack_layers(stacked, tc.n_layers)
    _close(rt, jp, "round trip", 0, 0)


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_pspecs_equal_the_reference(variant):
    jc, tc = (jt.TransformerConfig(**VARIANTS[variant]),
              tt.TransformerConfig(**VARIANTS[variant]))
    want = jpl.pipeline_pspecs("pp", jc)
    got = tpl.pipeline_pspecs("pp", tc)
    is_spec = lambda x: isinstance(x, JP)  # noqa: E731
    flat_w = jax.tree_util.tree_flatten_with_path(want, is_leaf=is_spec)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, tuple))[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_g] == \
        [jax.tree_util.keystr(k) for k, _ in flat_w]
    for (_, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g) == tuple(w)


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (4, 4), (4, 8), (2, 1)])
def test_pipeline_loss_matches_flagship_and_jax(pp, n_micro):
    jc, tc, jp, tp = _model(BASE, 0)
    tokens = _tokens(BASE["vocab"])
    want = float(jt.loss_fn(jp, jnp.asarray(tokens), jc))
    mesh = make_mesh((pp,), ("pp",))
    specs = jpl.pipeline_pspecs("pp")
    jax_loss = float(shard_jit(
        lambda p, t: jpl.pipeline_loss(p, t, jc, "pp", n_micro),
        mesh, (specs, JP()), JP())(jpl.stack_layers(jp),
                                   jnp.asarray(tokens)))
    tmesh = _mesh(pp)
    tspecs = tpl.pipeline_pspecs("pp", tc)
    shards = [shard_tree(tpl.stack_layers(tp), tspecs, tmesh.axes(r))
              for r in range(pp)]
    got = tmesh.run(lambda axes, p: tpl.pipeline_loss(
        p, torch.from_numpy(tokens), tc, axes["pp"], n_micro), shards)
    for g in got:
        assert abs(float(g) - want) < 2e-5, (float(g), want)
        assert abs(float(g) - jax_loss) < 2e-5, (float(g), jax_loss)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax_and_single_card(variant, schedule):
    """Each schedule's step against the JAX package's step of the same
    schedule and against the port's single-card step: MHA at pp 4 (one
    layer a stage), the GQA and RoPE pipelines at pp 2."""
    kw = VARIANTS[variant]
    jc, tc, jp, tp = _model(kw, 1)
    pp = min(4, kw["n_layers"])
    tokens = _tokens(kw["vocab"], seed=1)
    port_fn, jax_fn = SCHEDULES[schedule]
    got, losses, _ = _port(tc, tp, tokens, pp, port_fn, n_micro=4, lr=LR)
    want, want_loss = _jax(jc, jp, tokens, pp, jax_fn, 4)
    single, single_loss = _single(tc, tp, tokens)
    for loss in losses:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(loss, float(single_loss), rtol=1e-5)
    _close(got, want, f"{schedule} vs the JAX step", **STEP_TOL)
    _close(got, params_to_numpy(single), f"{schedule} vs single card",
           **STEP_TOL)


@pytest.mark.parametrize("pp,n_micro", [(2, 4), (4, 4), (4, 8)])
def test_1f1b_matches_gpipe_and_single_device(pp, n_micro):
    jc, tc, jp, tp = _model(BASE, 3)
    tokens = _tokens(BASE["vocab"], seed=3)
    g_p, g_l, _ = _port(tc, tp, tokens, pp, tpl.pipeline_train_step,
                        n_micro=n_micro, lr=LR)
    f_p, f_l, _ = _port(tc, tp, tokens, pp, tpl.pipeline_1f1b_train_step,
                        n_micro=n_micro, lr=LR)
    want, want_loss = _jax(jc, jp, tokens, pp,
                           jpl.pipeline_1f1b_train_step, n_micro)
    single, single_loss = _single(tc, tp, tokens)
    np.testing.assert_allclose(f_l[0], g_l[0], rtol=1e-5)
    np.testing.assert_allclose(f_l[0], float(single_loss), rtol=1e-5)
    np.testing.assert_allclose(f_l[0], want_loss, rtol=1e-5)
    _close(f_p, params_to_numpy(single), "1f1b vs single card", **STEP_TOL)
    _close(f_p, want, "1f1b vs the JAX 1f1b step", **STEP_TOL)
    _close(f_p, params_to_numpy(g_p), "1f1b vs gpipe", rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_pipeline_composes_with_dp(schedule):
    """(dp, pp) = (2, 4): tokens split over dp, layers over pp; the step
    equals the JAX (dp, pp) step and the single-card step."""
    jc, tc, jp, tp = _model(BASE, 2)
    tokens = _tokens(BASE["vocab"], seed=2)
    port_fn, jax_fn = SCHEDULES[schedule]
    got, losses, _ = _port(tc, tp, tokens, 4, port_fn, dp=2, n_micro=2,
                           lr=LR)
    want, want_loss = _jax(jc, jp, tokens, 4, jax_fn, 2, dp=2)
    single, single_loss = _single(tc, tp, tokens)
    for loss in losses:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(loss, float(single_loss), rtol=1e-5)
    _close(got, want, f"{schedule} dp x pp vs the JAX step", **STEP_TOL)
    _close(got, params_to_numpy(single), f"{schedule} dp x pp vs single",
           **STEP_TOL)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_pipeline_training_reduces_loss(schedule):
    kw = dict(vocab=16, d_model=32, n_heads=2, n_layers=4, d_ff=32,
              dtype="float32")
    tc = tt.TransformerConfig(**kw)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(np.stack(
        [(rng.integers(0, 16) + np.arange(24)) % 16 for _ in range(4)])
        .astype(np.int32))
    mesh = _mesh(4)
    specs = tpl.pipeline_pspecs("pp", tc)
    stacked = tpl.stack_layers(tt.init_params(tc, seed=5, device="cpu"))
    shards = [shard_tree(stacked, specs, mesh.axes(r)) for r in range(4)]
    fn = SCHEDULES[schedule][0]

    def train(axes, p):
        losses = []
        for _ in range(80):
            p, loss = fn(p, tokens, tc, axes["pp"], 4, lr=0.2)
            losses.append(float(loss))
        return losses
    losses = mesh.run(train, shards)[0]
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


@pytest.mark.parametrize("fn", [
    lambda p, t, c, a: tpl.pipeline_loss(p, t, c, a, 4),
    lambda p, t, c, a: tpl.pipeline_train_step(p, t, c, a, 4),
    lambda p, t, c, a: tpl.pipeline_1f1b_train_step(p, t, c, a, 4)],
    ids=["loss", "gpipe", "1f1b"])
def test_refusals(fn):
    """batch % n_micro != 0 is an AssertionError naming n_micro, an MoE
    config a NotImplementedError, as in the JAX package."""
    jc, tc, jp, tp = _model(BASE, 0)
    tok = torch.from_numpy(_tokens(BASE["vocab"], batch=6))
    mesh = _mesh(2)
    specs = tpl.pipeline_pspecs("pp", tc)
    shards = [shard_tree(tpl.stack_layers(tp), specs, mesh.axes(r))
              for r in range(2)]
    with pytest.raises(AssertionError, match="n_micro"):
        mesh.run(lambda axes, p: fn(p, tok, tc, axes["pp"]), shards)
    moe = tt.TransformerConfig(**dict(BASE, n_experts=4))
    with pytest.raises(NotImplementedError, match="dense"):
        mesh.run(lambda axes, p: fn(p, tok[:4], moe, axes["pp"]), shards)


GRID = [(s, pp, m) for s in ("gpipe", "1f1b") for pp in (1, 2, 3, 4, 8)
        for m in (1, 2, 4, 8, 64)]


@pytest.mark.parametrize("schedule,pp,n_micro",
                         GRID + [("dualpipe", 4, 8), ("gpipe", 0, 8),
                                 ("1f1b", 4, 0)])
def test_cost_model_equals_reference(schedule, pp, n_micro):
    try:
        want = jpl.pipeline_cost(schedule, pp, n_micro)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpl.pipeline_cost(schedule, pp, n_micro)
        assert str(got.value) == str(e)
        return
    assert tpl.pipeline_cost(schedule, pp, n_micro) == want


class CountingAxis:
    """An ``Axis`` that records the pairs of every ``ppermute`` and the
    count of every other collective, then hands the call on."""

    def __init__(self, axis):
        self.axis, self.size, self.index = axis, axis.size, axis.index
        self.device, self.leader = axis.device, axis.leader
        self.permutes, self.reduces = [], 0

    def ppermute(self, x, pairs):
        self.permutes.append(tuple(pairs))
        return self.axis.ppermute(x, pairs)

    def all_reduce(self, x, op):
        self.reduces += 1
        return self.axis.all_reduce(x, op)


@pytest.mark.parametrize("pp,n_micro", [(2, 4), (4, 8), (4, 2)])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_schedule_pinned_to_cost_model(schedule, pp, n_micro):
    """Every rank runs the ticks and permutes a tick ``pipeline_cost``
    gives: GPipe fwd_ticks chain permutes, then as many reverse ones;
    1F1B total_ticks ticks of a chain and a reverse permute. 1F1B's ring
    has peak_boundary_blocks slots (all written when M fills them);
    GPipe holds at most M stage graphs (bubble ticks keep none)."""
    jc, tc, jp, tp = _model(BASE, 0)
    tokens = _tokens(BASE["vocab"])
    cost = tpl.pipeline_cost(schedule, pp, n_micro)
    axes, stats = [], []

    def wrap(axis):
        axes.append(CountingAxis(axis))
        return axes[-1]

    def fn(p, t, c, a, **kw):
        st = {}
        stats.append(st)
        return SCHEDULES[schedule][0](p, t, c, a, stats=st, **kw)
    _port(tc, tp, tokens, pp, fn, wrap=wrap, n_micro=n_micro)
    chain = tuple((i, i + 1) for i in range(pp - 1))
    rchain = tuple((i + 1, i) for i in range(pp - 1))
    T = cost["fwd_ticks"]
    want = [chain] * T + [rchain] * T if schedule == "gpipe" \
        else [chain, rchain] * T
    assert len(axes) == pp
    for a, st in zip(axes, stats):
        assert a.permutes == want
        assert len(a.permutes) == cost["total_ticks"] \
            * cost["permutes_per_tick"]
        assert st["ticks"] == cost["total_ticks"]
        if schedule == "1f1b":
            assert st["ring_slots"] == cost["peak_boundary_blocks"]
            assert st["ring_written"] == min(st["ring_slots"], n_micro)
        else:
            assert st["peak_live_graphs"] == n_micro
            assert n_micro < cost["peak_boundary_blocks"] or pp == 1
