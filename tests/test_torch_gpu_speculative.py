"""Speculative decoding on the card against the port's ``generate`` there.

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py``
says). f32 tiny configs of ``tests/test_torch_speculative.py``, random
weights from ``init_params``' seeds: the draft steps run K6 at T = 1
and K7, the verify K6 at T = gamma and K8, and the GEMMs take other
shapes than ``generate``'s, so a row's tokens equal ``generate``'s up to
the first position whose top-2 logit gap is under ``NEAR_TIE`` (a
near-tie another summation order may flip), and to the end elsewhere.
"""

import numpy as np
import pytest
import torch

from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import speculative as tsp
from rlo_tpu_torch.models import transformer as tt

CFG = tt.TransformerConfig(vocab=61, d_model=64, n_heads=4, n_layers=2,
                           d_ff=128, dtype="float32")
DRAFT = tt.TransformerConfig(vocab=61, d_model=32, n_heads=2, n_layers=1,
                             d_ff=64, dtype="float32")
NEAR_TIE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _greedy_with_gaps(params, prompt, cfg, max_new):
    """``generate``'s greedy loop, with each pick's top-2 logit gap."""
    b, plen = prompt.shape
    cache = tg.init_kv_cache(cfg, b, plen + max_new, device=prompt.device)
    logits, _ = tg.prefill(params, prompt, cache, cfg)
    toks, gaps = [], []
    for i in range(max_new):
        top = torch.topk(logits, 2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
        if i + 1 < max_new:
            logits, _ = tg.decode_step(params, toks[-1], plen + i, cache, cfg)
    return (torch.stack(toks, 1).cpu().numpy(),
            torch.stack(gaps, 1).cpu().numpy())


def _equal_until_near_tie(got, want, gaps):
    for g, w, gap in zip(got, want, gaps):
        bad = np.nonzero(g != w)[0]
        if len(bad):
            assert gap[bad[0]] < NEAR_TIE, (g, w, bad[0], gap[bad[0]])


@pytest.mark.gpu
@pytest.mark.parametrize("draft", ["random", "self"])
def test_speculative_greedy_equals_generate_on_card(cuda, draft):
    params = tt.init_params(CFG, seed=0, device=cuda)
    dparams, dcfg = (params, CFG) if draft == "self" else \
        (tt.init_params(DRAFT, seed=5, device=cuda), DRAFT)
    g = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(0, CFG.vocab, (4, 16), generator=g, device=cuda,
                           dtype=torch.int32)
    max_new, gamma = 20, 4
    out, rounds = tsp.speculative_generate(
        params, dparams, prompt, CFG, dcfg, max_new=max_new, gamma=gamma,
        return_rounds=True)
    assert out.device.type == "cuda" and tuple(out.shape) == (4, max_new)
    plain = tg.generate(params, prompt, CFG, max_new=max_new).cpu().numpy()
    want, gaps = _greedy_with_gaps(params, prompt, CFG, max_new)
    np.testing.assert_array_equal(plain, want)
    _equal_until_near_tie(out.cpu().numpy(), want, gaps)
    if draft == "self" and (gaps >= NEAR_TIE).all():
        assert rounds == -(-(max_new - 1) // gamma)


@pytest.mark.gpu
def test_speculative_sampling_on_card(cuda):
    """The self-draft sampling path on the card: every proposal accepted
    (p_t and p_d differ by the products' rounding only), tokens in
    range."""
    params = tt.init_params(CFG, seed=0, device=cuda)
    prompt = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    out, rounds = tsp.speculative_generate(
        params, params, prompt, CFG, CFG, max_new=13, gamma=4,
        temperature=0.8, generator=torch.Generator(device=cuda).manual_seed(3),
        return_rounds=True)
    assert int(out.min()) >= 0 and int(out.max()) < CFG.vocab
    assert rounds <= 3 + 1
