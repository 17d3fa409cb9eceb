"""The port's continuous-batching DecodeServer (dense mode) against the
JAX package's DecodeServer on the same request stream, and against the
port's own per-request ``generate``: tokens identical (f32 tiny
config), the same ``stats()`` keys, the same scheduling counters."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rlo_tpu.models import serve as js
from rlo_tpu.models import transformer as jt
from rlo_tpu_torch.convert import params_from_numpy
from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import serve as ts
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.utils.metrics import Registry

KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          dtype="float32")
SERVER = dict(n_slots=3, max_len=64, round_len=5, prompt_buckets=(8, 16))


def _stream(seed, vocab):
    """Mixed lengths and budgets, a prompt longer than the largest bucket
    (extended through block_decode) and a max_new = 1 request."""
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, vocab, (int(rng.integers(3, 16)),)),
             int(rng.integers(2, 14))) for _ in range(5)]
    reqs.insert(2, (rng.integers(0, vocab, (37,)), 9))
    reqs.insert(4, (rng.integers(0, vocab, (6,)), 1))
    return reqs


def _run(server, reqs):
    for p, m in reqs:
        server.submit(p, m)
    return server.run()


@pytest.mark.parametrize("variant", ["mha", "gqa_rope", "int8"])
def test_stream_matches_jax_server_and_generate(variant):
    extra = {"mha": {}, "gqa_rope": dict(n_kv_heads=2, pos_encoding="rope"),
             "int8": dict(kv_cache_dtype="int8")}[variant]
    jc = jt.TransformerConfig(**KW, **extra)
    tc = tt.TransformerConfig(**KW, **extra)
    jp = jt.init_params(jax.random.PRNGKey(1), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    reqs = _stream(2, KW["vocab"])
    mine = ts.DecodeServer(tp, tc, metrics=Registry(), **SERVER)
    got = _run(mine, reqs)
    assert len(got) == len(reqs)
    for (p, m), g in zip(reqs, got):
        want = tg.generate(tp, torch.as_tensor(p[None], dtype=torch.int32),
                           tc, max_new=m)[0].numpy()
        np.testing.assert_array_equal(g, want)
    if variant == "int8":
        return  # the JAX server attends int8 caches in f32 off a TPU
    ref = js.DecodeServer(jp, jc, metrics=_jax_registry(), **SERVER)
    want = _run(ref, reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    a, b = mine.stats(), ref.stats()
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(a[kind]) == sorted(b[kind]), kind
    assert a["counters"] == b["counters"]
    assert (mine.rounds_run, mine.steps_run) == (ref.rounds_run,
                                                 ref.steps_run)
    for name, h in a["histograms"].items():
        assert h["count"] == b["histograms"][name]["count"], name


def _jax_registry():
    from rlo_tpu.utils.metrics import Registry as JaxRegistry
    return JaxRegistry()


@pytest.fixture(scope="module")
def small():
    tc = tt.TransformerConfig(**KW)
    return tc, tt.init_params(tc, seed=3, device="cpu")


def test_eos_cancel_and_hooks(small):
    tc, tp = small
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, KW["vocab"], (7,))
    dense = tg.generate(tp, torch.as_tensor(prompt[None], dtype=torch.int32),
                        tc, max_new=12)[0].numpy()
    # an eos whose first appearance is the fourth token or later
    eos = int(next(t for i, t in enumerate(dense)
                   if i >= 3 and t not in dense[:i]))
    srv = ts.DecodeServer(tp, tc, n_slots=1, max_len=64, round_len=2,
                          prompt_buckets=(8,), metrics=Registry())
    r0 = srv.submit(prompt, 12, eos_id=eos)
    r1 = srv.submit(rng.integers(0, KW["vocab"], (5,)), 6)
    r2 = srv.submit(rng.integers(0, KW["vocab"], (5,)), 6)
    assert srv.queue_depth() == 3 and srv.free_slots() == 1
    assert srv.cancel(r2) and not srv.cancel(r2)
    srv.step_round()
    assert srv.slot_ownership() == (r0,)
    outs = srv.run()
    np.testing.assert_array_equal(outs[r0],
                                  dense[:list(dense).index(eos) + 1])
    assert len(outs[r1]) == 6 and len(outs[r2]) == 0
    done = dict(srv.poll_completed())
    assert set(done) == {r0, r1} and not srv.poll_completed()
    assert not srv.has_work()
    assert srv.stats()["counters"]["serve.requests_canceled"] == 1


def test_admission_contract(small):
    tc, tp = small
    srv = ts.DecodeServer(tp, tc, metrics=Registry(), **SERVER)
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit([], 3)
    with pytest.raises(ValueError, match="exceeds max_len"):
        srv.submit(np.zeros(60, np.int32), 5)
    with pytest.raises(ValueError, match="no prompt bucket"):
        ts.DecodeServer(tp, tc, n_slots=1, max_len=4, prompt_buckets=(8,))
    paged = ts.DecodeServer(tp, tc, n_slots=1, max_len=64, paged=True,
                            metrics=Registry())
    assert paged.paged and paged.n_pages == 2 and paged.clip_rounds
    assert ts._bucket(9, (8, 16)) == 16
    with pytest.raises(ValueError):
        ts._bucket(17, (8, 16))


def test_retired_slot_past_max_len_is_harmless(small):
    """A retired slot keeps decoding past max_len; its writes are
    dropped and a later request in that slot still matches generate."""
    tc, tp = small
    srv = ts.DecodeServer(tp, tc, n_slots=2, max_len=24, round_len=16,
                          prompt_buckets=(8,), metrics=Registry())
    rng = np.random.default_rng(5)
    first = (rng.integers(0, KW["vocab"], (8,)), 16)
    short = (rng.integers(0, KW["vocab"], (4,)), 2)
    late = (rng.integers(0, KW["vocab"], (6,)), 10)
    outs = _run(srv, [first, short, late])
    assert int(max(srv.pos)) > 24          # a slot ran past the end
    for (p, m), g in zip([first, short, late], outs):
        want = tg.generate(tp, torch.as_tensor(p[None], dtype=torch.int32),
                           tc, max_new=m)[0].numpy()
        np.testing.assert_array_equal(g, want)


def test_stats_histograms_are_summaries(small):
    tc, tp = small
    srv = ts.DecodeServer(tp, tc, metrics=Registry(), **SERVER)
    _run(srv, [(np.arange(5), 4)])
    h = srv.stats()["histograms"]["serve.ttft_usec"]
    assert set(h) == {"count", "mean", "min", "max", "p50", "p90", "p99"}
    assert dataclasses.asdict(ts.Request(np.arange(2), 3))["max_new"] == 3
