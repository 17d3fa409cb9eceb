"""The port's serving fabric over DecodeServers on the card: a two-rank
fleet in the port's deterministic simulator, each rank a ``DecodeServer``
(dense, then paged) behind ``ModelBackend``, with a tiny f32 model on
``cuda``. Every request completes exactly once on both ranks with the
same tokens, and the fleet's rounds launched the decode kernels (K6 and
K7 dense, K9 and K10 paged).

Card-only and jax-free (run as ``tests/test_torch_gpu_reduce.py`` says);
without a card every test skips.
"""

import numpy as np
import pytest
import torch

from rlo_tpu_torch.engine import EngineManager, ProgressEngine
from rlo_tpu_torch.kernels import decode as kd
from rlo_tpu_torch.models import serve as S
from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                              cast_params, init_params)
from rlo_tpu_torch.serving.backend import ModelBackend
from rlo_tpu_torch.serving.fabric import DecodeFabric
from rlo_tpu_torch.transport.sim import SimWorld
from rlo_tpu_torch.utils.metrics import Registry

CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _fleet(params, cfg, paged, reqs, n_ranks=2):
    world = SimWorld(n_ranks, seed=3)
    mgr = EngineManager()
    engines = [ProgressEngine(world.transport(r), manager=mgr,
                              clock=world.clock, failure_timeout=6.0,
                              heartbeat_interval=1.0, arq_rto=1.5,
                              arq_max_retries=6, op_deadline=20.0)
               for r in range(n_ranks)]
    kw = (dict(paged=True, page_size=16) if paged
          else dict(prompt_buckets=(16, 32)))
    fabrics = [DecodeFabric(
        engines[r],
        ModelBackend(S.DecodeServer(params, cfg, n_slots=2, max_len=64,
                                    round_len=4, metrics=Registry(), **kw)),
        decode_interval=1.0) for r in range(n_ranks)]
    rids = [fabrics[i % n_ranks].submit(p, m) for i, (p, m) in
            enumerate(reqs)]
    while world.now < 60.0:
        world.step()
        mgr.progress_all()
        for f in fabrics:
            f.pump()
        if all(f.result(rid) is not None for f in fabrics for rid in rids):
            break
    out = [[f.result(rid) for rid in rids] for f in fabrics]
    counts = [[f.completions.count(rid) for rid in rids] for f in fabrics]
    for e in engines:
        e.cleanup()
    return out, counts


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fabric_fleet_on_card(cuda, paged):
    cfg = TransformerConfig(**CFG)
    params = cast_params(init_params(cfg, seed=1, device=cuda),
                         cfg.act_dtype)
    rng = np.random.default_rng(2)
    shared = [int(t) for t in rng.integers(0, cfg.vocab, 16)]
    reqs = [(shared + [int(t) for t in rng.integers(0, cfg.vocab, n)], m)
            for n, m in ((3, 9), (7, 5), (1, 12), (5, 6), (2, 8))]
    counted = ((kd.paged_flash_decode, kd.write_kv_page_row) if paged
               else (kd.flash_block_decode, kd.write_kv_row))
    for fn in counted:
        fn.launches = 0
    out, counts = _fleet(params, cfg, paged, reqs)
    torch.cuda.synchronize()
    for fn in counted:
        assert fn.launches > 0, fn.__name__
    assert out[0] == out[1]
    assert counts == [[1] * len(reqs)] * 2
    for toks, (_, m) in zip(out[0], reqs):
        assert toks is not None and len(toks) == m
        assert all(0 <= t < cfg.vocab for t in toks)
