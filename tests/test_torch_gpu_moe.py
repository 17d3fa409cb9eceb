"""The MoE layer and an MoE decode step on the card against the same
functions on the CPU.

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py``
says). f32 throughout; the router product runs without TF32 (PyTorch's
default, checked here), so both devices pick the same experts on these
seeds (their top-1 margins are checked). ``moe_ffn``'s out and grads
within rtol 2e-4 / atol 2e-5 (cuBLAS and the CPU sum in other orders),
aux within rtol 1e-5; the decode step's logits (K6 and K7 on the card,
their plain versions on the CPU) within rtol 1e-4 / atol 1e-4.
"""

import pytest
import torch

from rlo_tpu_torch.models import generate as tg
from rlo_tpu_torch.models import moe as tm
from rlo_tpu_torch.models import transformer as tt

D, F, E, T = 64, 128, 8, 96


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, dev) for v in tree]
    return tree.to(dev)


def _margin(wr, h):
    g = torch.sort(torch.softmax(h @ wr, -1), -1).values
    return float((g[:, -1] - g[:, -2]).min())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["padded", "sorted"])
@pytest.mark.parametrize("cf", [1.0, float(E)])
def test_moe_ffn_on_card_matches_cpu(cuda, route, cf, monkeypatch):
    if route == "sorted":
        monkeypatch.setattr(tm, "PAD_ROWS", 0)
        monkeypatch.setattr(tm, "PAD_RATIO", 0)
    params = tm.init_moe_params(torch.Generator().manual_seed(1), D, F, E)
    h = torch.randn((T, D), generator=torch.Generator().manual_seed(2))
    r = torch.randn((T, D), generator=torch.Generator().manual_seed(3))
    assert _margin(params["wr"], h) > 1e-4
    outs = []
    for dev in ("cpu", cuda):
        p = {k: v.to(dev, copy=True).requires_grad_(True)
             for k, v in params.items()}
        x = h.to(dev, copy=True).requires_grad_(True)
        out, aux = tm.moe_ffn(p, x, E, capacity_factor=cf)
        ((out * r.to(dev)).sum() + aux).backward()
        outs.append([out, aux, x.grad] + [p[k].grad for k in sorted(p)])
    (co, ca, *cg), (go, ga, *gg) = outs
    torch.testing.assert_close(go.cpu(), co, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(ga.cpu(), ca, rtol=1e-5, atol=0)
    for a, b in zip(gg, cg):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
def test_moe_decode_step_on_card_matches_cpu(cuda):
    cfg = tt.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                               d_ff=128, dtype="float32", n_experts=4)
    params = tt.init_params(cfg, seed=3, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (3, 12),
                           generator=torch.Generator().manual_seed(4),
                           dtype=torch.int32)
    tok = torch.tensor([5, 77, 120], dtype=torch.int32)
    logits = []
    for dev in ("cpu", cuda):
        p = _on(params, dev)
        cache = tg.init_kv_cache(cfg, 3, 16, device=dev)
        first, _ = tg.prefill(p, prompt.to(dev), cache, cfg)
        lg, _ = tg.decode_step(p, tok.to(dev), 12, cache, cfg)
        logits.append((first.cpu(), lg.cpu()))
    for a, b in zip(logits[1], logits[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
