"""The MoE layer's two dispatch routes, the MoE decode step beside the
dense one, and K6 by cache length, timed on the card.

    python3 -m rlo_tpu_torch.tools.time_moe

On the flagship's widths (vocab 32768, d 1024, 16 heads, 8 layers, d_ff
4096, bf16) with 8 experts, random weights from a seed:

  - the SGD training step on 4 x 1024 tokens (the params move, so the
    routing does), with ``models.moe``'s padded and sorted dispatch in
    turns (P S P S), at capacity factors 2 and 4: 7 steps each, the
    median of the last 6;
  - a forward of prefill's shape, 32 x 1024 tokens without grad, at
    capacity factor 8 (drop-free, as serving routes) and 4, the two
    dispatches in turns: the median of 4 calls;
  - the decode step at batch 32, position 1024 of a 1088-position
    cache, MoE (drop-free) beside dense: the host median of blocks of
    10 steps, and over 5 steps the profiler's device time and kernel
    count;
  - K6 (``flash_decode``) alone at 32 x 16 kv heads x head_dim 64, bf16,
    position 1024, over caches of 1088, 1100 and 1104 positions (1100 is
    not a multiple of 8: its rows are not 16-byte aligned and K6 takes
    plain loads), by CUDA events (median of 100) and device time.

Prints the card line and one JSON line. Needs a card; exits non-zero
without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FLAGSHIP = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8,
                d_ff=4096, dtype="bfloat16")
EXPERTS = 8
ROUTES = {"padded": (1 << 62, 1 << 30), "sorted": (0, 0)}


def _wall_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _device(fn):
    """(device ms, kernel launches) of one ``fn()`` by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kern) / 1e3,
            sum(e.count for e in kern))


def _use(M, route) -> None:
    M.PAD_ROWS, M.PAD_RATIO = ROUTES[route]


def time_training(dev, M, tt) -> dict:
    import torch
    tokens = torch.randint(0, FLAGSHIP["vocab"], (4, 1024), device=dev,
                           dtype=torch.int32)
    out = {}
    for cf in (2.0, 4.0):
        cfg = tt.TransformerConfig(**FLAGSHIP, n_experts=EXPERTS,
                                   capacity_factor=cf)
        for i, route in enumerate(("padded", "sorted") * 2):
            _use(M, route)
            state = {"p": tt.init_params(cfg, seed=0, device=dev)}

            def step():
                state["p"], _ = tt.train_step(state["p"], tokens, cfg,
                                              lr=0.05)

            walls = [_wall_ms(step) for _ in range(7)]
            out[f"cf{cf:g}_{route}_{i // 2}"] = statistics.median(walls[1:])
            del state
            torch.cuda.empty_cache()
    return out


def time_prefill(dev, M, tt) -> dict:
    import torch
    prompt = torch.randint(0, FLAGSHIP["vocab"], (32, 1024), device=dev,
                           dtype=torch.int32)
    out = {}
    for cf in (8.0, 4.0):
        cfg = tt.TransformerConfig(**FLAGSHIP, n_experts=EXPERTS,
                                   capacity_factor=cf)
        params = tt.cast_params(tt.init_params(cfg, seed=0, device=dev),
                                cfg.act_dtype)
        for i, route in enumerate(("padded", "sorted") * 2):
            _use(M, route)
            with torch.no_grad():
                walls = [_wall_ms(lambda: tt.forward(params, prompt, cfg))
                         for _ in range(4)]
            out[f"cf{cf:g}_{route}_{i // 2}"] = statistics.median(walls)
        del params
        torch.cuda.empty_cache()
    return out


def time_decode_steps(dev, G, tt) -> dict:
    import torch
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, FLAGSHIP["vocab"], (32, 1024), generator=gen,
                           device=dev, dtype=torch.int32)
    out = {}
    for name, extra in (("dense", {}),
                        ("moe", dict(n_experts=EXPERTS,
                                     capacity_factor=float(EXPERTS)))):
        cfg = tt.TransformerConfig(**FLAGSHIP, **extra)
        params = tt.cast_params(tt.init_params(cfg, seed=0, device=dev),
                                cfg.act_dtype)
        cache = G.init_kv_cache(cfg, 32, 1088, device=dev)
        logits, _ = G.prefill(params, prompt, cache, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = torch.tensor(1024, dtype=torch.int32, device=dev)

        def steps(k):
            t = tok
            for _ in range(k):
                lg, _ = G.decode_step(params, t, pos, cache, cfg)
                t = torch.argmax(lg, -1).to(torch.int32)

        blocks = [_wall_ms(lambda: steps(10)) / 10 for _ in range(3)]
        dev_ms, launches = _device(lambda: steps(5))
        out[name] = dict(host_ms_per_step=statistics.median(blocks),
                         device_ms_per_step=dev_ms / 5,
                         launches_per_step=launches / 5)
        del params, cache
        torch.cuda.empty_cache()
    return out


def time_k6_lengths(dev, kd) -> dict:
    import torch
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for L in (1088, 1100, 1104):
        q = torch.randn((32, 1, 16, 64), generator=gen, device=dev) \
            .to(torch.bfloat16)
        k = torch.randn((32, 16, 64, L), generator=gen, device=dev) \
            .to(torch.bfloat16)
        v = torch.randn((32, 16, 64, L), generator=gen, device=dev) \
            .to(torch.bfloat16)
        pos = torch.tensor(1024, dtype=torch.int32, device=dev)

        def call():
            kd.flash_decode(q, k, v, pos, 0.125)

        for _ in range(10):
            call()
        times = []
        for _ in range(100):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        dev_ms, _ = _device(lambda: [call() for _ in range(20)])
        out[L] = dict(events_ms=statistics.median(times),
                      device_ms=dev_ms / 20)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_moe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models import moe as M
    from rlo_tpu_torch.models import transformer as tt
    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    limits = M.PAD_ROWS, M.PAD_RATIO
    try:
        result = {"training_step_ms": time_training(dev, M, tt),
                  "prefill_forward_ms": time_prefill(dev, M, tt)}
    finally:
        M.PAD_ROWS, M.PAD_RATIO = limits
    result["decode_step"] = time_decode_steps(dev, G, tt)
    result["k6_by_cache_length"] = time_k6_lengths(dev, kd)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
