"""The plain reference agrees with the port's forward, loss and AdamW
step at a tiny f32 config. The test imports the port; the reference
never does."""

import torch

from portbench import weights
from portbench.reference import model as ref

M = {"vocab": 96, "d_model": 32, "n_heads": 4, "n_kv_heads": 2,
     "n_layers": 2, "d_ff": 64}


def _port():
    from rlo_tpu_torch.models import transformer as T
    cfg = T.TransformerConfig(**M, dtype="float32", pos_encoding="rope")
    return T, cfg


def _tokens(seed=0, b=2, s=24):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, M["vocab"], (b, s), generator=g,
                         dtype=torch.int32)


def _tree(live):
    return weights.tree(M, live)


def test_forward_matches_port():
    T, cfg = _port()
    W = weights.make(M, 5, torch.float32, torch.device("cpu"))
    tok = _tokens()
    got = T.forward(W, tok, cfg)
    want = ref.logits(W, tok, M)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    tail = ref.logits(W, tok, M, from_pos=7)
    assert torch.allclose(tail, want[:, 7:], atol=1e-6)


def test_loss_matches_port():
    T, cfg = _port()
    W = weights.make(M, 6, torch.float32, torch.device("cpu"))
    tok = _tokens(1)
    live = [p.detach().requires_grad_(True) for p in weights.leaves(W)]
    R = _tree(live)
    got = ref.loss_backward(R, tok, M, rows_per_block=1, head_rows=5)
    assert abs(float(T.loss_fn(W, tok, cfg)) - got) < 1e-5
    want = T.grads_and_loss(W, tok, cfg)[1]
    for g, p in zip(weights.leaves(want), live):
        assert torch.allclose(g, p.grad, atol=1e-6, rtol=1e-4)


def test_adamw_steps_match_port():
    T, cfg = _port()
    cpu = torch.device("cpu")
    hyper = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    W = weights.make(M, 7, torch.float32, cpu)
    opt = torch.optim.AdamW(weights.leaves(W), **hyper)
    R = weights.make(M, 7, torch.float32, cpu)
    live = [p.detach().requires_grad_(True) for p in weights.leaves(R)]
    Rl = _tree(live)
    ropt = ref.AdamW(live, hyper["lr"], hyper["betas"], hyper["eps"],
                     hyper["weight_decay"])
    for i in range(3):
        tok = _tokens(10 + i)
        W, loss = T.train_step_optim(W, opt, tok, cfg)
        rl = ref.loss_backward(Rl, tok, M)
        ropt.step()
        assert abs(float(loss) - rl) < 1e-5
    # Adam divides by sqrt(v): an element whose gradient is near nought
    # turns rounding into up to lr a step, so the bound is per element
    # a tenth of three steps' lr, and the mean must stay at rounding
    for p, q in zip(weights.leaves(W), live):
        d = (p - q.detach()).abs()
        assert float(d.max()) < 3e-4 and float(d.mean()) < 1e-6


def test_fp8_control_rounds_its_products():
    a = torch.randn(16, 16)
    b = torch.randn(16, 16)
    err = (ref.fp8_mm(a, b) - a @ b).abs().max()
    assert 1e-3 < float(err) < 2.0
