"""The spans inside the port's training step (``rlo.*``), on the CPU.

A profile of ``train_step_optim`` at a tiny size holds one
``rlo.train.step`` with the forward, the backward and the optimizer in
that order; the forward holds each layer's attention and FFN and then
the head; the backward holds one ``rlo.train.recompute`` per layer (each
around the layer's attention and FFN) under remat and none without, and
one per vocab chunk of a chunked head. Each rank of a ``LocalMesh`` dp
axis opens the same spans on its own thread. The layer spans belong to
the training forward: prefill and the decode step open none. The spans
change no number: a profiled step gives the loss and the parameters of
an unprofiled one, bit for bit.
"""

import contextlib
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import LocalMesh

TINY = dict(vocab=16, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            dtype="float32")
CASES = {"remat": dict(remat=True), "no_remat": dict(remat=False),
         "remat_chunked": dict(remat=True, loss_vocab_chunk=8)}


def _setup(**kw):
    cfg = tt.TransformerConfig(**TINY, **kw)
    params = tt.init_params(cfg, seed=3, device="cpu")
    opt = torch.optim.AdamW(tt.tree_leaves(params), lr=1e-2)
    gen = torch.Generator().manual_seed(5)
    tok = torch.randint(0, TINY["vocab"], (2, 16), generator=gen,
                        dtype=torch.int32)
    return cfg, params, opt, tok


def _spans(prof):
    """The profile's ``rlo.*`` ranges as (name, start, end), by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("rlo.")),
                  key=lambda s: (s[1], -s[2]))


def _children(parent, spans):
    """The ranges directly inside ``parent``, in order."""
    inside = [s for s in spans if s is not parent
              and parent[1] <= s[1] and s[2] <= parent[2]]
    return [s for s in inside
            if not any(o is not s and o[1] <= s[1] and s[2] <= o[2]
                       for o in inside)]


def _one(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


@pytest.mark.parametrize("case", list(CASES))
def test_step_spans_nest_in_order(case):
    cfg, params, opt, tok = _setup(**CASES[case])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tt.train_step_optim(params, opt, tok, cfg)
    spans = _spans(prof)
    step = _one(spans, "rlo.train.step")
    assert [s[0] for s in _children(step, spans)] == [
        "rlo.train.forward", "rlo.train.backward", "rlo.train.optimizer"]
    layers = ["rlo.layer.attention", "rlo.layer.ffn"] * cfg.n_layers
    fwd = _one(spans, "rlo.train.forward")
    assert [s[0] for s in _children(fwd, spans)] == layers + \
        ["rlo.train.head"]
    bwd = _one(spans, "rlo.train.backward")
    recs = _children(bwd, spans)
    assert {s[0] for s in recs} <= {"rlo.train.recompute"}
    chunks = -(-cfg.vocab // cfg.loss_vocab_chunk) \
        if cfg.loss_vocab_chunk else 0
    remat = cfg.n_layers if cfg.remat else 0
    assert len(recs) == remat + chunks
    held = [[s[0] for s in _children(r, spans)] for r in recs]
    assert sorted(held) == sorted([["rlo.layer.attention", "rlo.layer.ffn"]]
                                  * remat + [[]] * chunks)


@pytest.mark.parametrize("case", ["remat", "no_remat"])
def test_spans_change_no_bit_of_the_step(case):
    cfg, p0, opt0, tok = _setup(**CASES[case])
    _, p1, opt1, _ = _setup(**CASES[case])
    for _ in range(2):
        p0, loss0 = tt.train_step_optim(p0, opt0, tok, cfg)
        with profile(activities=[ProfilerActivity.CPU]):
            p1, loss1 = tt.train_step_optim(p1, opt1, tok, cfg)
        assert torch.equal(loss0, loss1)
    for a, b in zip(tt.tree_leaves(p0), tt.tree_leaves(p1)):
        assert torch.equal(a, b)


def _record_names(monkeypatch):
    """Replace the module's ``annotate`` by one that logs (thread, name)."""
    log, lock = [], threading.Lock()

    @contextlib.contextmanager
    def rec(name):
        with lock:
            log.append((threading.get_ident(), name))
        yield

    monkeypatch.setattr(tt, "annotate", rec)
    return log


@pytest.mark.parametrize("axis", [None, "dp"])
def test_dp_ranks_open_the_same_spans(monkeypatch, axis):
    """Under a ``LocalMesh`` dp axis each rank's thread opens the
    forward, the head and the backward in that order, as one process
    without an axis does; the gradient sums over dp open no span."""
    cfg, params, _, tok = _setup(remat=False)
    log = _record_names(monkeypatch)
    if axis is None:
        tt.grads_and_loss(params, tok, cfg)
        ranks = 1
    else:
        mesh = LocalMesh((2,), ("dp",), device="cpu")
        mesh.run(lambda axes, t: tt.grads_and_loss(params, t, cfg,
                                                   dp_axis=axes["dp"]),
                 [tok[:1], tok[1:]])
        ranks = 2
    by_thread = {}
    for th, name in log:
        if name.startswith("rlo.train."):
            by_thread.setdefault(th, []).append(name)
    assert len(by_thread) == ranks
    want = ["rlo.train.forward", "rlo.train.head", "rlo.train.backward"]
    assert all(names == want for names in by_thread.values())


def test_decode_opens_no_span():
    """Prefill and the decode step run ``apply_layer`` without its spans
    (the decode step is host-bound); the training forward opens them."""
    cfg, params, _, tok = _setup(remat=False)
    cache = tg.init_kv_cache(cfg, tok.shape[0], 32, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits, _ = tg.prefill(params, tok, cache, cfg)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        tg.decode_step(params, nxt, tok.shape[1], cache, cfg)
    assert _spans(prof) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tt.forward(params, tok, cfg)
    assert [s[0] for s in _spans(prof)] == \
        ["rlo.layer.attention", "rlo.layer.ffn"] * cfg.n_layers
