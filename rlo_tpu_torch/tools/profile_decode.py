"""Where the time of one decode step goes, on the card.

    python3 -m rlo_tpu_torch.tools.profile_decode [--batch 32] [--plen 1024]
                                                  [--paged]

Builds the flagship serving config (vocab 32768, d 1024, 16 heads, 8
layers, d_ff 4096, bf16; random weights from ``--seed``), prefills a
batch of ``--batch`` random prompts of ``--plen`` tokens, warms up a few
decode steps, then: times ``--steps`` decode steps on the host clock
(each ends in a device synchronise; median reported), and traces one
step and one prefill with ``torch.profiler``. With ``--paged`` the
prefilled cache is copied into pages of 128 under a permuted table, the
steps are ``paged_decode_step``s (K9 attends, K10 writes), and the
traced prefill is one 128-token ``paged_prefill_chunk`` (K9, K11).
Prints the host wall time, the device time summed over kernels (one
stream, so kernels do not overlap), the device's idle share of the wall
time, the device time by group (K6/K9 decode attention, K7/K10 cache
writes, K8/K11 block writes, K2 flash, matrix products, the rest), the top
kernels, the top PyTorch ops by the device time they launched and the
rest's device time by the op that launched it; then one JSON line with
the same numbers. Needs a CUDA card; fails without one, and fails if the
profiler records no device time. The profiler slows the host, so the
idle share is also given against the unprofiled median step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

#: kernel-name fragments of each group (the port's kernels by their
#: CUDA function names; cuBLAS/CUTLASS products by theirs)
GROUPS = (("K9 paged decode attention", ("paged_decode_kernel",)),
          ("K6 decode attention", ("decode_kernel",)),
          ("K7/K10 row write", ("write_row_kernel",)),
          ("K8/K11 block write", ("write_block_kernel",)),
          ("K2 flash", ("flash_fwd_",)),
          ("matrix products", ("gemm", "cutlass", "sm90_xmma", "nvjet",
                               "cublas")))


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def _group(name: str) -> str:
    low = name.lower()
    for label, frags in GROUPS:
        if any(f in low for f in frags):
            return label
    return "other"


def trace(fn) -> dict:
    """Profile one ``fn()`` (after which the device is synchronised),
    with kernel times summed by ``GROUPS`` (label, name fragments)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, calls, ops = {}, {}, {}
    for evt in prof.key_averages():
        self_dev = getattr(evt, "self_device_time_total", 0) or 0
        if evt.device_type == torch.autograd.DeviceType.CPU and self_dev:
            ops[evt.key] = self_dev
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and _device_us(evt) > 0:
            kernels[evt.key] = _device_us(evt)
            calls[evt.key] = evt.count
    device_us = sum(kernels.values())
    if device_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    by_group = {}
    for k, v in kernels.items():
        g = _group(k)
        ms, n = by_group.get(g, (0.0, 0))
        by_group[g] = (ms + v / 1e3, n + calls[k])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    # the "other" group by the PyTorch op that launched each kernel
    other = {}
    for evt in prof.events():
        for kern in getattr(evt, "kernels", ()):
            if _group(kern.name) == "other":
                other[evt.key] = other.get(evt.key, 0.0) + kern.duration
    return {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
            "idle_share": max(0.0, 1 - device_us / wall_us),
            "kernel_launches": sum(calls.values()),
            "groups_ms": {g: ms for g, (ms, _) in by_group.items()},
            "groups_launches": {g: n for g, (_, n) in by_group.items()},
            "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
            "top_ops_ms": {k: v / 1e3 for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:8]},
            "other_by_op_ms": {k: v / 1e3 for k, v in sorted(
                other.items(), key=lambda kv: -kv[1])[:12]}}


def _report(label: str, r: dict) -> None:
    print(f"[profile] {label}: wall {r['wall_ms']:.3f} ms, device "
          f"{r['device_ms']:.3f} ms, idle {100 * r['idle_share']:.1f}%, "
          f"{r['kernel_launches']} kernel launches")
    for g, ms in sorted(r["groups_ms"].items(), key=lambda kv: -kv[1]):
        print(f"           {ms:8.3f} ms  {100 * ms / r['device_ms']:5.1f}%  "
              f"{g} ({r['groups_launches'][g]} launches)")
    for k, v in r["top_kernels_ms"].items():
        print(f"           {v:8.3f} ms  {k}")
    print("           by the PyTorch op that launched it:")
    for k, v in r["top_ops_ms"].items():
        print(f"           {v:8.3f} ms  {k}")
    print("           the other group by the op that launched it:")
    for k, v in r["other_by_op_ms"].items():
        print(f"           {v:8.3f} ms  {k}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--plen", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="profile the paged decode step and prefill chunk")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA card", file=sys.stderr)
        return 2
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models import paged as PG
    from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                                  cast_params, init_params)
    # bf16 products accumulate in f32, as chip_smoke.py runs them
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}")
    cfg = TransformerConfig(vocab=32768, d_model=1024, n_heads=16,
                            n_layers=8, d_ff=4096, dtype="bfloat16")
    dev = torch.device("cuda", torch.cuda.current_device())
    params = cast_params(init_params(cfg, seed=args.seed, device=dev),
                         cfg.act_dtype)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.plen),
                           generator=gen, device=dev, dtype=torch.int32)
    max_len = args.plen + 2 * args.steps + 8
    cache = G.init_kv_cache(cfg, args.batch, max_len, device=dev)
    logits, _ = G.prefill(params, prompt, cache, cfg)
    tok = torch.argmax(logits, -1).to(torch.int32)
    # the paged step takes one position per row
    pos = torch.full((args.batch,) if args.paged else (), args.plen,
                     dtype=torch.int32, device=dev)
    ps = 128
    mp = -(-max_len // ps)
    n_pages = args.batch * mp + 1
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .to(torch.int32).reshape(args.batch, mp).contiguous()
    active = torch.ones(args.batch, dtype=torch.bool, device=dev)
    pools = PG.pages_from_dense(cache, table, n_pages, ps) \
        if args.paged else None

    def step():
        nonlocal tok, pos, logits
        if args.paged:
            logits, _ = PG.paged_decode_step(params, tok, pos, pools, table,
                                             active, cfg)
        else:
            logits, _ = G.decode_step(params, tok, pos, cache, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1

    for _ in range(3):
        step()
    walls = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(walls)
    mode = "paged" if args.paged else "dense"
    print(f"[decode] {mode}, batch {args.batch}, plen {args.plen}: median step "
          f"{step_ms:.3f} ms over {args.steps} steps "
          f"({args.batch / step_ms * 1e3:.0f} tok/s), no profiler")
    dec = trace(step)
    # the profiler slows the host: the idle share of an unprofiled step
    dec["idle_share_unprofiled"] = max(0.0, 1 - dec["device_ms"] / step_ms)
    _report(f"one {mode} decode step", dec)
    print(f"[profile] device time {dec['device_ms']:.3f} ms of the "
          f"unprofiled {step_ms:.3f} ms step: idle "
          f"{100 * dec['idle_share_unprofiled']:.1f}%")
    if args.paged:
        # the last full page of row 0's prompt, as one prefill chunk
        a = (args.plen - 1) // ps * ps
        chunk = prompt[:1, a:a + ps]
        pre = trace(lambda: PG.paged_prefill_chunk(
            params, chunk, a, chunk.shape[1], pools, table[:1], cfg))
        label = f"one paged prefill chunk ({chunk.shape[1]} tokens at {a})"
    else:
        pre_cache = G.init_kv_cache(cfg, args.batch, max_len, device=dev)
        pre = trace(lambda: G.prefill(params, prompt, pre_cache, cfg))
        label = f"one prefill (batch {args.batch} x {args.plen})"
    _report(label, pre)
    print(json.dumps({"card": card, "mode": mode, "batch": args.batch,
                      "plen": args.plen, "step_ms_median": step_ms,
                      "decode_step": dec, "prefill": pre}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
