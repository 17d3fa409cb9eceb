"""The port's speculative decoding against the JAX package on the CPU.

Greedy: the port's ``speculative_generate`` gives the JAX package's
tokens and round count exactly (f32 tiny configs of
``tests/test_speculative.py``, the JAX params carried across with
``params_from_numpy``) for a random draft (the rejection path), the
target itself (full acceptance) and the target plus seeded noise
(partial acceptance), for GQA+RoPE, int8-cache and MoE targets; and the
port's own ``generate``'s tokens. Sampling: the self-draft accepts every
proposal, and the marginals of the first two tokens over 4096 rows of
one batch lie within total variation 0.07 of the exact marginals the
JAX package's ``prefill``/``decode_step`` give on the same params (the
reference's own bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlo_tpu.models import generate as jg
from rlo_tpu.models import speculative as jsp
from rlo_tpu.models import transformer as jt
from rlo_tpu_torch.convert import params_from_numpy
from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import speculative as tsp
from rlo_tpu_torch.models import transformer as tt

CFG = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           dtype="float32")
DRAFT = dict(vocab=61, d_model=16, n_heads=2, n_layers=1, d_ff=32,
             dtype="float32")


def _cfgs(kw):
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def setup():
    (jc, tc), (jd, td) = _cfgs(CFG), _cfgs(DRAFT)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    jdp = jt.init_params(jax.random.PRNGKey(5), jd)
    noisy = jax.tree.map(lambda p: p + 0.03 * jax.random.normal(
        jax.random.PRNGKey(9), p.shape, p.dtype), jp)
    prompt = np.random.default_rng(1).integers(0, CFG["vocab"], (3, 6)) \
        .astype(np.int32)
    return dict(cfgs=(jc, tc, jd, td), params=(jp, _to_torch(jp)),
                draft=(jdp, _to_torch(jdp)), noisy=(noisy, _to_torch(noisy)),
                prompt=prompt)


def _both(jp, jd, tp, td, prompt, jc, jdc, tc, tdc, **kw):
    """(port tokens, port rounds), (JAX tokens, JAX rounds) for greedy."""
    want, wr = jsp.speculative_generate(jp, jd, jnp.asarray(prompt), jc, jdc,
                                        return_rounds=True, **kw)
    got, rounds = tsp.speculative_generate(tp, td, torch.from_numpy(prompt),
                                           tc, tdc, return_rounds=True, **kw)
    return (got.numpy(), rounds), (np.asarray(want), int(wr))


@pytest.mark.parametrize("draft,gamma,max_new", [
    ("random", 1, 10), ("random", 3, 10), ("random", 8, 10),
    ("self", 4, 12), ("perturbed", 4, 10)])
def test_greedy_matches_jax_and_generate(setup, draft, gamma, max_new):
    jc, tc, jd, td = setup["cfgs"]
    jp, tp = setup["params"]
    prompt = setup["prompt"]
    if draft == "random":
        (jdp, tdp), jdc, tdc = setup["draft"], jd, td
    else:
        (jdp, tdp), jdc, tdc = setup["params" if draft == "self"
                                     else "noisy"], jc, tc
    (got, rounds), (want, want_rounds) = _both(
        jp, jdp, tp, tdp, prompt, jc, jdc, tc, tdc, max_new=max_new,
        gamma=gamma)
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds
    plain = tg.generate(tp, torch.from_numpy(prompt), tc, max_new=max_new)
    np.testing.assert_array_equal(got, plain.numpy())
    if draft == "self":     # full acceptance: gamma tokens every round
        assert rounds == -(-(max_new - 1) // gamma)


@pytest.mark.parametrize("variant", ["gqa_rope", "int8", "moe"])
def test_greedy_variants_match_jax(setup, variant):
    """The reference's variants, and an MoE target (its plain prefill
    routes with the training capacity in both frameworks; the draft
    steps and the verify drop-free)."""
    extra = {"gqa_rope": dict(n_kv_heads=2, pos_encoding="rope"),
             "int8": dict(kv_cache_dtype="int8"),
             "moe": dict(n_experts=2)}[variant]
    jc, tc = _cfgs(dict(CFG, **extra))
    jdc, tdc = _cfgs(dict(DRAFT, kv_cache_dtype=extra.get("kv_cache_dtype")))
    jp = jt.init_params(jax.random.PRNGKey(11), jc)
    jdp = jt.init_params(jax.random.PRNGKey(12), jdc)
    tp, tdp = _to_torch(jp), _to_torch(jdp)
    prompt = setup["prompt"]
    (got, rounds), (want, want_rounds) = _both(
        jp, jdp, tp, tdp, prompt, jc, jdc, tc, tdc, max_new=9, gamma=3)
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds
    np.testing.assert_array_equal(
        got, tg.generate(tp, torch.from_numpy(prompt), tc, max_new=9).numpy())


def test_argument_errors(setup):
    _, tc, _, td = setup["cfgs"]
    tp, tdp = setup["params"][1], setup["draft"][1]
    prompt = torch.from_numpy(setup["prompt"])
    with pytest.raises(ValueError, match="vocab"):
        tsp.speculative_generate(tp, tdp, prompt, tc,
                                 dataclasses.replace(td, vocab=17),
                                 max_new=4)
    with pytest.raises(ValueError, match="gamma"):
        tsp.speculative_generate(tp, tdp, prompt, tc, td, max_new=4,
                                 gamma=0)
    with pytest.raises(ValueError, match="max_len"):
        tsp.speculative_generate(tp, tdp, prompt, tc, td, max_new=4,
                                 gamma=2, max_len=8)
    with pytest.raises(ValueError, match="generator"):
        tsp.speculative_generate(tp, tdp, prompt, tc, td, max_new=4,
                                 temperature=0.7)


def test_sampling_self_draft_accepts_everything(setup):
    """draft == target at one temperature: p_t == p_d up to the T = 1
    against block products, so every proposal is accepted and the loop
    takes the fewest rounds."""
    _, tc, _, _ = setup["cfgs"]
    tp = setup["params"][1]
    max_new, gamma = 13, 4
    out, rounds = tsp.speculative_generate(
        tp, tp, torch.from_numpy(setup["prompt"]), tc, tc, max_new=max_new,
        gamma=gamma, temperature=0.8,
        generator=torch.Generator().manual_seed(3), return_rounds=True)
    assert tuple(out.shape) == (3, max_new)
    assert int(out.min()) >= 0 and int(out.max()) < CFG["vocab"]
    assert rounds == -(-(max_new - 1) // gamma)


def test_sampling_matches_target_distribution():
    """The rejection scheme's first two tokens against the exact
    marginals of temperature sampling from the target: p0 from the JAX
    package's prefill, p1(w) = sum_t0 p0(t0) p(w | t0) from its
    decode_step over every t0; the port samples 4096 rows of one batch
    with an unrelated random draft (the heavy rejection path)."""
    vocab, temp, n = 23, 1.3, 4096
    jc, tc = _cfgs(dict(vocab=vocab, d_model=16, n_heads=2, n_layers=2,
                        d_ff=32, dtype="float32"))
    jdc, tdc = _cfgs(dict(vocab=vocab, d_model=8, n_heads=1, n_layers=1,
                          d_ff=16, dtype="float32"))
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    jdp = jt.init_params(jax.random.PRNGKey(1), jdc)
    prompt = np.array([[5, 11, 2]], np.int32)

    cache = jg.init_kv_cache(jc, 1, 8)
    logits0, cache = jg.prefill(jp, jnp.asarray(prompt), cache, jc)
    p0 = jax.nn.softmax(logits0[0] / temp)

    def next_probs(t0):
        lg, _ = jg.decode_step(jp, jnp.asarray([t0], jnp.int32), 3, cache,
                               jc)
        return jax.nn.softmax(lg[0] / temp)

    p1 = np.asarray(p0 @ jax.vmap(next_probs)(jnp.arange(vocab)))
    out = tsp.speculative_generate(
        _to_torch(jp), _to_torch(jdp),
        torch.from_numpy(np.repeat(prompt, n, axis=0)), tc, tdc, max_new=2,
        gamma=3, temperature=temp,
        generator=torch.Generator().manual_seed(7)).numpy()
    for posn, exact in ((0, np.asarray(p0)), (1, p1)):
        emp = np.bincount(out[:, posn], minlength=vocab) / n
        tv = 0.5 * np.abs(emp - exact).sum()
        assert tv < 0.07, (posn, tv)
