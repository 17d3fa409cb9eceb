"""Decode attention and decode steps timed on the card, for comparing trees.

    python3 -m rlo_tpu_torch.tools.time_decode [--steps]

Times K6 (``flash_block_decode``) at the dense decode shape (batch 32 x
16 kv heads x head_dim 64 x 1088 positions, T 1; bf16 and int8 caches;
one shared position at the end and ragged positions), and, where the
tree has K9 (``paged_flash_decode``), K9 and K6 on the same columns in
turns (K9 over 289 permuted pages of 128). CUDA-event medians of 100
calls after 10 warm-up calls. ``--steps`` adds the host median of full
decode steps of the flagship config (vocab 32768, d 1024, 16 heads, 8
layers, bf16), dense (shared and per-row positions) and paged, timed in
blocks of 12 in three orders in one process. Prints the card line and
one JSON line. To compare two trees on one card, copy this file into
the other tree's ``rlo_tpu_torch/tools/`` and run it from each tree's
root in turns (A, B, B, A): it imports only what a tree has.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

L, B, NKV, HD, PS = 1088, 32, 16, 64, 128


def _event_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _caches(kind, gen, dev):
    """Dense (b, kvh, hd, L) k/v and their int8 scales (or None)."""
    import torch
    k = torch.randn(B, NKV, HD, L, generator=gen, device=dev)
    v = torch.randn(B, NKV, HD, L, generator=gen, device=dev)
    if kind == "bf16":
        return {"k": k.bfloat16(), "v": v.bfloat16()}

    def q8(x):
        s = torch.clamp_min(x.abs().amax(dim=2), 1e-30) * (1.0 / 127.0)
        return torch.round(x / s[:, :, None, :]).to(torch.int8), s

    (k, ks), (v, vs) = q8(k), q8(v)
    return {"k": k, "v": v, "ks": ks, "vs": vs}


def kernels(dev) -> dict:
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for kind in ("bf16", "int8"):
        c = _caches(kind, gen, dev)
        q = torch.randn(B, 1, 16, HD, generator=gen, device=dev).bfloat16()
        for label, pos in (
                ("scalar", torch.tensor(L - 1, dtype=torch.int32,
                                        device=dev)),
                ("ragged", torch.randint(0, L, (B,), generator=gen,
                                         device=dev, dtype=torch.int32))):
            out[f"K6 {kind} {label}"] = _event_ms(
                lambda: kd.flash_block_decode(q, c["k"], c["v"], pos, 0.125,
                                              c.get("ks"), c.get("vs")))
        if not hasattr(kd, "paged_flash_decode"):
            continue
        from rlo_tpu_torch.models.paged import pages_from_dense
        mp = -(-L // PS)
        P = B * mp + 1
        table = (torch.randperm(P - 1, generator=gen, device=dev) + 1) \
            .to(torch.int32).reshape(B, mp).contiguous()
        pg = pages_from_dense([c], table, P, PS)[0]
        f9 = lambda: kd.paged_flash_decode(  # noqa: E731
            q, pg["k"], pg["v"], table, pos, 0.125, pg.get("ks"),
            pg.get("vs"))
        f6 = lambda: kd.flash_block_decode(  # noqa: E731
            q, c["k"], c["v"], pos, 0.125, c.get("ks"), c.get("vs"))
        t = [_event_ms(f) for f in (f9, f6, f6, f9)]
        out[f"K9 {kind} ragged, in turns with K6"] = (t[0] + t[3]) / 2
        out[f"K6 {kind} ragged, in turns with K9"] = (t[1] + t[2]) / 2
    return out


def steps(dev) -> list:
    import torch
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models import paged as PG
    from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                                  cast_params, init_params)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    cfg = TransformerConfig(vocab=32768, d_model=1024, n_heads=16,
                            n_layers=8, d_ff=4096, dtype="bfloat16")
    params = cast_params(init_params(cfg, seed=0, device=dev),
                         cfg.act_dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    plen, max_len = 1024, 1224
    prompt = torch.randint(0, cfg.vocab, (B, plen), generator=gen,
                           device=dev, dtype=torch.int32)
    cache = G.init_kv_cache(cfg, B, max_len, device=dev)
    logits, _ = G.prefill(params, prompt, cache, cfg)
    mp = -(-max_len // PS)
    P = B * mp + 1
    table = (torch.randperm(P - 1, generator=gen, device=dev) + 1) \
        .to(torch.int32).reshape(B, mp).contiguous()
    pools = PG.pages_from_dense(cache, table, P, PS)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = {"dense shared pos": torch.tensor(plen, dtype=torch.int32,
                                            device=dev),
           "dense per-row pos": torch.full((B,), plen, dtype=torch.int32,
                                           device=dev),
           "paged": torch.full((B,), plen, dtype=torch.int32, device=dev)}

    def step(name):
        if name == "paged":
            PG.paged_decode_step(params, tok, pos[name], pools, table,
                                 active, cfg)
        else:
            G.decode_step(params, tok, pos[name], cache, cfg)
        pos[name] = pos[name] + 1

    def block(name, n=12):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(name)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    for name in pos:
        block(name, 3)                      # warm-up
    names = list(pos)
    return [{name: block(name) for name in order}
            for order in (names, names[::-1], names[1:] + names[:1])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", action="store_true",
                    help="also time full dense and paged decode steps")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_decode: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"kernels_ms": kernels(dev)}
    if args.steps:
        out["step_ms_blocks"] = steps(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
