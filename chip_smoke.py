#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card: the rootless collectives, the
dense serving path, the paged serving path and the training step.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero
without them, and without the ``rlo_tpu_torch`` package beside it. Runs
on one card: with several visible it pins itself to the first.
Phases, each printing its own lines:

1. Card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   builds every kernel of the port from ``rlo_tpu_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together); the SASS of the
   flash library must hold HMMA (tensor-core) instructions in every bf16
   instantiation of K2-K5 and none in the f32 ones, and more in each bf16
   K4/K5 than in K3 at the same head dim (their products moved too).
2. K1 (the fused combine) against its plain PyTorch version on the card:
   f32/bf16 x sum/min/max, int32 x sum/min/max/and/or, with NaN inputs,
   int32 values above 2^24, ragged and unaligned sizes, the in-place
   accumulate, and the shapes of the main path. Results must be
   bit-identical to the plain version's (NaN payloads included). Times the
   kernel, the plain version and ``torch.add(out=)`` at 256 MB fp32.
3. The facade at full size: ``rlo_tpu_torch.init(backend="cuda",
   world_size=8)`` with a 256 MB fp32 buffer per rank, all 8 ranks on
   the one card: every allreduce algorithm, bf16, int32 min/max, bcast,
   consensus, reduce-scatter, all-gather, all-to-all, barrier,
   hierarchical allreduce (psum and int8) and sharded consensus. K1's
   launch count is set to 0 before this phase and read after it.
4. K2 (flash forward), K6 (flash decode), K7 and K8 (cache writes)
   against their plain versions at the serving path's shapes, plus
   ragged edges, GQA group sizes 1/2/8 and int8 caches, and K2's
   tensor-core route at head dims 16/32/64/128 (ragged, GQA 2 and 8,
   carried state, fully masked rows, permuted ring positions); K7 and K8
   must be bit-identical; operands that are views (an offset-by-one,
   misaligned bf16 k/v, a transposed q and o) give K2's bits for their
   contiguous copies. K2 is timed at the prefill shape, the training
   shape and on its f32 route, in turns with
   ``scaled_dot_product_attention``. Then K9 (paged decode) at the paged
   decode shape (289 permuted pages of 128), a prefill chunk, GQA group 4
   and pages
   of 256, and on pages holding a dense cache's columns, where it must
   equal K6 bit for bit; K10 and K11 (page writes) bit-identical,
   sentinels included. Times each kernel, its plain version, its bound
   and one PyTorch call that computes the same function (K9: K6 on the
   equivalent dense cache instead; no single call pages).
5. Serving at full width (the flagship config, vocab 32768, d 1024, 16
   heads, 8 layers, d_ff 4096, bf16, random weights from the seed):
   ``generate_timed`` at batch 32 / plen 1024 / 64 new tokens, the same
   with an int8 cache and 16 new tokens, a GQA+RoPE config against the
   plain versions on the CPU, and a 32-request ``DecodeServer`` held
   against each prompt's own ``generate``. K2, K6, K7 and K8's launch
   counts are set to 0 before this phase and read after it.
6. Paged serving at full width, same config: a batch-32 / 1024-token
   prefill copied into 289 permuted pages, then 64 teacher-forced steps
   of ``paged_decode_step`` beside ``decode_step`` (tokens equal at every
   step); a paged ``DecodeServer`` (8 slots, pages of 128, prefill budget
   256) with 32 requests sharing a 256-token prefix or repeating a
   prompt, held against each request's own paged reference (its prompt
   in the same page-aligned prefill chunks, decode in batches of 8) and,
   partings at near-ties only, against each prompt's own ``generate``;
   with prefix hits, a copy-on-write and a leak-free pool. K2 and K6-K11's launch
   counts are set to 0 just before the server run and read just after:
   K9-K11 must have run, K2 and K6-K8 not.
7. K3 (tie counts), K4 (dq) and K5 (dk, dv), the flash backward, against
   their plain versions at the training path's shapes (64 folded heads x
   1024 x 64 bf16, causal and not, f32, GQA group 4 through the host
   fold, ragged Lq/Lk, the ring step, fully masked rows, structural ties):
   K3's counts equal exactly (each side on its own forward's m'), K4/K5
   within rtol 1e-4 (each side on that m' too); at bf16 head dims
   16/32/128 too (33 x 7, 129 x 77, 256 x 256, causal and not) K3 ties
   K2's m' on every row from the initial state and K4/K5 hold rtol 1e-4;
   100 repeat launches of K3-K5 give the bits of the first, and views
   (misaligned, transposed) the bits of their contiguous copies. Times
   each kernel, its plain version, its bound and (K4, K5) the backward of
   ``scaled_dot_product_attention`` at the same shape (its device time,
   by the profiler: timed by events, the call is bound by the host).
8. The VJP (``FlashBlockUpdate``) in its three modes at 64 x 1024 x 64:
   'pallas' and 'pallas_fast' against 'xla' on one update and on a chain
   of two (the ring step); values bit-identical across the modes. The
   exact-mode chain is K3's path (training runs 'pallas_fast', no K3):
   K3's launch count is set to 0 just before it and read just after.
9. Training at full width (the flagship config, batch 4 x 1024, one
   batch from the seed): the kernel path's loss and grads against the
   attention backward in 'xla' mode, 3 runs each with and without remat
   bit-identical to the first, 10 SGD and 10 Adam steps with the loss
   falling, the median step time,
   tokens/s, model FLOPs per token and their share of the bf16 peak,
   peak memory and launches per step.
10. The explicit dp combine: 2 ranks of a ``LocalMesh`` on the card, each
   on half the batch, grads through ``allreduce(algorithm="ring")`` (K1),
   equal to the single-process grads within the stated limit. K1, K2,
   K4 and K5's launch counts are set to 0 just before phase 9 and read
   after phase 10: each must have run.
11. One JSON line of kernel figures, each with the path whose launches
   it counts, then the last line ``{"ok": true, "device": {...}}``.

Every failure raises, so the exit code is non-zero and no result line
is printed.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

SEED = 20261016
WS = 8
N_FULL = 64 * 2 ** 20          # 256 MB of fp32 per rank (BASELINE size)
PEAK_HBM_BYTES_S = 3.35e12     # H100 SXM data sheet
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core rate
K1_SOURCE = "rlo_tpu_torch/kernels/csrc/reduce.cu"
K1_REPLACES = "rlo_tpu/pallas/reduce.py:49"
FLASH_SOURCE = "rlo_tpu_torch/kernels/csrc/flash.cu"
DECODE_SOURCE = "rlo_tpu_torch/kernels/csrc/decode.cu"
KERNEL_SOURCES = ("reduce", "flash", "decode")
#: the flagship serving config (benchmarks/serve_bench.py:377-382,
#: benchmarks/decode_bench.py:166-170)
SERVE_CFG = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8,
                 d_ff=4096, dtype="bfloat16")
#: the GQA+RoPE config of benchmarks/tpu_parity_check.py:59-63
GQA_CFG = dict(vocab=4096, d_model=512, n_heads=8, n_layers=4, d_ff=1024,
               dtype="bfloat16", n_kv_heads=2, pos_encoding="rope")
#: phase 6: the teacher-forced paged-vs-dense decode and the shared prefix
PAGED_TF = dict(batch=32, plen=1024, steps=64)
PAGED_PREFIX = 256
#: a top-2 logit gap under this is a near-tie: greedy tokens may part there
NEAR_TIE = 1e-2
#: ... or under this many units in the last place of the top logit, for
#: logits that come out of a bf16 product (one bf16 ulp at 2..4 is 2^-6)
NEAR_TIE_ULPS = 2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def time_ms(fn, iters: int = 20, warmup: int = 3, per: int = 1) -> float:
    """Median device time of one ``fn()`` call, by CUDA events around
    ``per`` calls in a row (divided by ``per``). With ``per`` > 1 the host
    enqueues the next call while the card runs this one, so a wrapper's
    Python time is left out of a kernel that outlasts it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one ``fn()`` call: its kernels' times summed by
    ``torch.profiler`` over ``reps`` calls, divided by ``reps``. Leaves
    out the host time between the kernels of a call (autograd's engine
    around SDPA's backward), which CUDA events around a run include."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us += float(getattr(evt, "device_time_total", 0)
                        or getattr(evt, "cuda_time_total", 0))
    check(us > 0, "the profiler recorded no device time")
    return us / reps / 1e3


def wall_ms(fn, reps: int = 3) -> float:
    """Median host time of ``fn()`` ending in a device synchronise."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def same_bits(got, want) -> bool:
    """Equal bit for bit (NaN payloads included)."""
    import torch
    if got.dtype.is_floating_point:
        view = torch.int32 if got.element_size() == 4 else torch.int16
        return torch.equal(got.view(view), want.view(view))
    return torch.equal(got, want)


def abs_err(got, want) -> float:
    import torch
    g, w = got.double(), want.double()
    ok = ~(torch.isnan(g) & torch.isnan(w))
    return float((g - w).abs()[ok].max()) if bool(ok.any()) else 0.0


# ---------------------------------------------------------------------------
# Phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_operands(n, dtype, gen, dev, nan: bool):
    import torch
    if dtype == torch.int32:
        lo, hi = -2 ** 31, 2 ** 31 - 1   # far above 2^24
        return (torch.randint(lo, hi, (n,), generator=gen, device=dev,
                              dtype=dtype),
                torch.randint(lo, hi, (n,), generator=gen, device=dev,
                              dtype=dtype))
    a = torch.randn(n, generator=gen, device=dev)
    b = torch.randn(n, generator=gen, device=dev)
    if nan:
        a[::7] = float("nan")
        b[3::11] = float("nan")
    return a.to(dtype), b.to(dtype)


def phase_k1(dev, n_full: int) -> dict:
    import torch
    from rlo_tpu_torch.kernels import reduce as k1

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(dt, op) for dt in (torch.float32, torch.bfloat16)
             for op in ("sum", "min", "max")]
    cases += [(torch.int32, op) for op in ("sum", "min", "max", "and", "or")]
    # ragged tails, then every operand size the main path hands K1:
    # bidir-ring sub-chunks (n/64, n/32, n/16), the ring chunk (n/8), the
    # halving rounds (n/2, n/4, n/8) and recursive doubling's whole buffer
    sizes = [1, 105, 513] + [n_full // d for d in (64, 32, 16, 8, 4, 2, 1)]
    tally = {"cases": 0, "worst": 0.0}

    def compare(got, want, what):
        torch.cuda.synchronize()
        check(same_bits(got, want), f"K1 {what} is not bit-identical to "
                                    f"its plain version")
        tally["cases"] += 1
        tally["worst"] = max(tally["worst"], abs_err(got, want))

    for dtype, op in cases:
        for n in sizes:
            a, b = k1_operands(n, dtype, gen, dev, nan=op != "sum")
            compare(k1.fused_combine(a, b, op),
                    k1.fused_combine_plain(a, b, op), f"{op} {dtype} n={n}")
        # unaligned views (scalar path) and the in-place accumulate
        a, b = k1_operands(514, dtype, gen, dev, nan=op != "sum")
        want = k1.fused_combine_plain(a[1:], b[1:], op)
        compare(k1.fused_combine(a[1:], b[1:], op), want,
                f"{op} {dtype} on unaligned views")
        acc = a[1:].clone()
        k1.fused_combine(acc, b[1:], op, out=acc)
        compare(acc, want, f"{op} {dtype} with out=a")
    for dtype in (torch.int8, torch.int16, torch.int64, torch.bool):
        a = torch.randint(0, 2, (1000,), generator=gen, device=dev).to(dtype)
        b = torch.randint(0, 2, (1000,), generator=gen, device=dev).to(dtype)
        for op in ("and", "or"):
            compare(k1.fused_combine(a, b, op),
                    k1.fused_combine_plain(a, b, op), f"{op} on {dtype}")
    print(f"[k1] {tally['cases']} cases bit-identical to "
          f"fused_combine_plain on the card (NaN payloads included); "
          f"max |err| {tally['worst']}")

    # times at the main path's shapes: the whole buffer and a ring chunk
    out = {}
    for label, n in (("256MB", n_full), ("ring_chunk", n_full // WS)):
        a, b = k1_operands(n, torch.float32, gen, dev, nan=False)
        c = torch.empty_like(a)
        kern = time_ms(lambda: k1.fused_combine(a, b, "sum", out=c))
        plain = time_ms(lambda: k1.fused_combine_plain(a, b, "sum", out=c))
        lib = time_ms(lambda: torch.add(a, b, out=c))
        # one add per 12 bytes moved: bound by HBM bytes at every size
        nbytes = 3 * n * 4
        bound = nbytes / PEAK_HBM_BYTES_S * 1e3
        out[label] = dict(ms=kern, plain_ms=plain, library_ms=lib,
                          bound_ms=bound, bound_by="bytes")
        print(f"[k1] f32 sum n={n} ({nbytes // 3 / 2 ** 20:.0f} MiB each): "
              f"kernel {kern:.4f} ms, plain {plain:.4f} ms, torch.add "
              f"{lib:.4f} ms, bound {bound:.4f} ms (3 x n x 4 B at "
              f"3.35 TB/s), kernel at {100 * bound / kern:.1f}% of bound, "
              f"{nbytes / (kern * 1e-3) / 1e9:.1f} GB/s")
    out["max_abs_err"] = tally["worst"]
    return out


# ---------------------------------------------------------------------------
# Phase 3: the facade at full size
# ---------------------------------------------------------------------------

def phase_facade(dev, n: int) -> dict:
    import torch
    import rlo_tpu_torch
    from rlo_tpu_torch.kernels import reduce as k1
    from rlo_tpu_torch.ops import device_collectives as dc
    from rlo_tpu_torch.parallel.consensus import TorchConsensus
    from rlo_tpu_torch.parallel.mesh import LocalMesh

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    b = rlo_tpu_torch.init(backend="cuda", world_size=WS,
                           device=None if dev.type == "cuda" else dev)
    ints = [torch.randint(-8, 9, (n,), generator=gen, device=dev).float()
            for _ in range(WS)]
    exact = ints[0].clone()
    for x in ints[1:]:
        exact += x          # integer-valued: every order gives this sum
    normal = [torch.randn(n, generator=gen, device=dev) for _ in range(WS)]
    psum = b.allreduce(normal, algorithm="psum")

    def all_equal(outs, want, what):
        torch.cuda.synchronize()
        check(len(outs) == WS and all(torch.equal(o, want) for o in outs),
              what)

    stats = {}
    algs = [("psum", None), ("ring", None), ("bidir_ring", 1),
            ("bidir_ring", 2), ("bidir_ring", 4),
            ("recursive_doubling", None), ("halving_doubling", None)]
    for alg, q in algs:
        name = alg if q is None else f"{alg}_q{q}"
        before = k1.fused_combine.launches
        outs = b.allreduce(ints, algorithm=alg, pipeline_chunks=q)
        launches = k1.fused_combine.launches - before
        all_equal(outs, exact, f"allreduce {name} != exact sum")
        del outs
        outs = b.allreduce(normal, algorithm=alg, pipeline_chunks=q)
        torch.cuda.synchronize()
        for o, p in zip(outs, psum):
            check(torch.allclose(o, p, rtol=1e-3, atol=1e-5),
                  f"allreduce {name} != psum at rtol 1e-3, atol 1e-5")
        del outs
        ms = wall_ms(lambda: b.allreduce(ints, algorithm=alg,
                                         pipeline_chunks=q))
        bus = None if alg == "psum" else dc.allreduce_cost(
            alg, WS, n * 4, pipeline_chunks=q, device=dev)["total_bytes"]
        stats[name] = dict(ms=ms, bus_bytes_per_rank=bus,
                           k1_launches=launches)
        print(f"[facade] allreduce {name:<18} {ms:9.3f} ms, bus bytes/rank "
              f"{bus}, K1 launches {launches} ({WS} ranks on one card, "
              f"{n * 4 // 2 ** 20} MiB fp32 each; exact and psum checks "
              f"passed)")
    check(stats["ring"]["k1_launches"] > 0,
          "fused_combine.launches did not grow during the ring allreduce")
    del normal, psum

    # bf16 ring at 128 MB per rank: integer values keep every sum exact
    bf = [x.to(torch.bfloat16) for x in ints]
    all_equal(b.allreduce(bf, algorithm="ring"), exact.to(torch.bfloat16),
              "bf16 ring allreduce")
    del bf
    print("[facade] bf16 ring allreduce (128 MB per rank): exact")

    # int32 min/max, values far above 2^24
    big = [torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                         device=dev, dtype=torch.int32) for _ in range(WS)]
    for op, fn in (("min", torch.minimum), ("max", torch.maximum)):
        want = big[0].clone()
        for x in big[1:]:
            want = fn(want, x)
        for alg in ("ring", "halving_doubling", "psum"):
            all_equal(b.allreduce(big, op=op, algorithm=alg), want,
                      f"int32 {op} {alg}")
    del big, want
    print("[facade] int32 min/max (ring, halving_doubling, psum): exact")

    for sched in ("binomial", "skip_ring"):
        outs = b.bcast(5, ints[5], schedule=sched)
        all_equal(outs, ints[5], f"bcast {sched} from origin 5")
        ms = wall_ms(lambda: b.bcast(5, ints[5], schedule=sched))
        print(f"[facade] bcast {sched} from 5: {ms:.3f} ms, exact")
    del outs

    check(b.consensus([1] * WS) == 1, "unanimous consensus")
    check(b.consensus([1, 1, 1, 0, 1, 1, 1, 1]) == 0, "vetoed consensus")
    print("[facade] consensus: unanimous -> 1, one veto -> 0")

    rs = b.reduce_scatter(ints)
    torch.cuda.synchronize()
    rows = exact.reshape(WS, -1)
    check(all(torch.equal(rs[r], rows[r]) for r in range(WS)),
          "reduce_scatter")
    del rs
    ag = b.all_gather(ints)
    torch.cuda.synchronize()
    check(all(torch.equal(ag[r][s], ints[s]) for r in range(WS)
              for s in range(WS)), "all_gather")
    del ag
    xss = [list(x.reshape(WS, -1)) for x in ints]
    for alg in ("direct", "ring", "xla"):
        out = b.all_to_all(xss, algorithm=alg)
        torch.cuda.synchronize()
        check(all(torch.equal(out[r][s], xss[s][r]) for r in range(WS)
                  for s in range(WS)), f"all_to_all {alg}")
        del out
    b.barrier()
    print("[facade] reduce_scatter, all_gather, all_to_all (direct, ring, "
          "xla), barrier: exact")

    # hierarchical allreduce on a (dcn=2, ici=4) mesh
    mesh2 = LocalMesh((2, 4), ("dcn", "ici"), b.device)
    outs = mesh2.run(lambda axes, v: dc.hierarchical_allreduce(
        v, axes["ici"], axes["dcn"]), ints)
    all_equal(outs, exact, "hierarchical allreduce (psum)")
    del outs
    normal = [torch.randn(n, generator=gen, device=dev) for _ in range(WS)]
    want = normal[0].clone()
    for x in normal[1:]:
        want += x
    outs = mesh2.run(lambda axes, v: dc.hierarchical_allreduce(
        v, axes["ici"], axes["dcn"], dcn_algorithm="int8"), normal)
    torch.cuda.synchronize()
    # one quantisation half-step per slice of the largest slice scale
    slice_amax = max(float(sum(normal[4 * d:4 * d + 4]).abs().max())
                     for d in range(2))
    bound = 2 * (slice_amax / 127.0) * 0.51 + 1e-5
    err = max(float((o - want).abs().max()) for o in outs)
    check(err <= bound, f"int8 hierarchical error {err} > bound {bound}")
    print(f"[facade] hierarchical allreduce (2, 4): psum exact, int8 max "
          f"|err| {err:.4g} <= bound {bound:.4g}")
    del outs

    cons = TorchConsensus(b.mesh, "x")
    finite = lambda v: torch.isfinite(v).all().to(torch.int32)  # noqa: E731
    check(cons.submit_sharded(b"clean", normal, finite) == 1,
          "sharded consensus, clean")
    normal[6][12345] = float("inf")
    check(cons.submit_sharded(b"poisoned", normal, finite) == 0,
          "sharded consensus, one vetoing rank")
    print("[facade] TorchConsensus.submit_sharded: clean -> 1, rank 6 "
          "poisoned -> 0")
    return stats


# ---------------------------------------------------------------------------
# Phase 4: K2, K6, K7 and K8 against their plain versions
# ---------------------------------------------------------------------------

def _close(got, want, rtol: float, atol_unit: float) -> bool:
    """|got - want| <= rtol*|want| + atol_unit * max(1, max|want|)."""
    import torch
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    return bool(torch.allclose(got, want, rtol=rtol,
                               atol=atol_unit * scale))


def _offset(t):
    """The values of ``t`` as a contiguous view one element into its
    storage: a bf16 one starts 2 bytes past 16 bytes."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def _transposed(t):
    """The values of ``t`` as a non-contiguous view (the last two axes
    swapped in storage)."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


#: f32 FMA rate of an H100 SXM's CUDA cores (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12


def _k2_bound(h, lq, lk, d, esize, pairs, flops_rate):
    """(bytes, bound ms, bound_by) of one K2 launch on folded operands:
    q, k, v read in their dtype, the carried f32 (m, l, o) read and
    (m', l', o') written, against 4 * d FLOPs per unmasked pair at
    ``flops_rate``."""
    nbytes = (h * lq + 2 * h * lk) * d * esize + 2 * h * lq * d * 4 \
        + 4 * h * lq * 4
    bound_b = nbytes / PEAK_HBM_BYTES_S * 1e3
    bound_f = 4 * d * pairs / flops_rate * 1e3
    return nbytes, max(bound_b, bound_f), ("bytes" if bound_b >= bound_f
                                           else "operations")


def phase_k2(dev) -> dict:
    """K2 at the prefill shapes (batch x heads folded: 32*16 = 512 heads,
    L 64 and 1024, D 64), a carried (non-initial) state, ragged Lq/Lk and
    GQA groups 1/2/8; then the tensor-core route at D 16/32/64/128 on
    ragged Lq/Lk, GQA groups 2 and 8, a carried state, fully masked rows
    and permuted (non-monotone) ring positions. Tolerance on m, l and o:
    rtol 1e-4 with atol 1e-4 per unit of the largest |value| (f32 sums in
    another order against one BLAS pass; bf16 p split into two bf16
    terms, ~2^-17 relative; exp by the SFU, ~2^-22 relative)."""
    import torch
    import torch.nn.functional as F
    from rlo_tpu_torch.kernels import flash as k2

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def case(h, hk, lq, lk, dtype, carried, d=64, kp_off=0, perm=False):
        q = torch.randn(h, lq, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(hk, lk, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(hk, lk, d, generator=gen, device=dev).to(dtype)
        if carried:
            m = torch.randn(h, 1, lq, generator=gen, device=dev)
            l = torch.rand(h, 1, lq, generator=gen, device=dev) + 0.5
            o = torch.randn(h, lq, d, generator=gen, device=dev)
        else:
            m = torch.full((h, 1, lq), k2.NEG, device=dev)
            l = torch.zeros(h, 1, lq, device=dev)
            o = torch.zeros(h, lq, d, device=dev)
        qp = torch.arange(lk - lq, lk, dtype=torch.int32,
                          device=dev).reshape(1, lq)
        kp = torch.arange(lk, dtype=torch.int32, device=dev) + kp_off
        if perm:
            kp = kp[torch.randperm(lk, generator=gen, device=dev)]
        return q, k, v, m, l, o, qp, kp.reshape(1, lk).contiguous()

    def held(cases):
        worst = 0.0
        for c in cases:
            opts = dict(c[6]) if len(c) > 6 else {}
            scale = opts.pop("scale", 0.125)
            args = case(*c[:6], **opts)
            for causal in (True, False):
                got = k2.flash_block_update_hld(*args, causal=causal,
                                                scale=scale)
                want = k2.flash_block_update_hld_plain(*args, causal=causal,
                                                       scale=scale)
                torch.cuda.synchronize()
                for name, g, w in zip("mlo", got, want):
                    check(bool(torch.isfinite(g).all()) and
                          _close(g, w, 1e-4, 1e-4),
                          f"K2 {name} {c} causal={causal} differs from its "
                          f"plain version")
                l2g, l2w = (t[1].transpose(1, 2) for t in (got, want))
                live = l2w > 0
                worst = max(worst, abs_err(
                    torch.where(live, got[2] / torch.where(live, l2g, 1), 0),
                    torch.where(live, want[2] / torch.where(live, l2w, 1),
                                0)))
        return worst

    bf, f32 = torch.bfloat16, torch.float32
    worst = held([(512, 512, 64, 64, bf, False),
                  (512, 512, 1024, 1024, bf, False),
                  (64, 64, 200, 1000, bf, True),
                  (64, 64, 129, 77, f32, True),
                  (32, 16, 128, 128, bf, False),
                  (32, 4, 128, 128, bf, False),
                  (32, 4, 100, 100, f32, True)])
    print(f"[k2] 14 cases (folded heads 512 at L 64 and 1024, carried "
          f"state, ragged Lq/Lk, GQA groups 1/2/8, bf16/f32) within rtol "
          f"1e-4 of the plain version; max |err| of o/l {worst:.3g}")
    dims = []
    for d in (16, 32, 64, 128):
        dims += [(4, 4, 33, 7, bf, False, dict(d=d)),
                 (8, 4, 129, 77, bf, True, dict(d=d)),
                 (16, 2, 100, 130, bf, True, dict(d=d)),
                 (8, 8, 64, 96, bf, False, dict(d=d, kp_off=48)),
                 (8, 8, 70, 200, bf, True, dict(d=d, perm=True))]
    # a negative scale (the row max is then the smallest raw score) and 0
    dims += [(8, 4, 129, 77, bf, True, dict(scale=-0.125)),
             (4, 4, 33, 7, bf, True, dict(d=128, scale=0.0))]
    worst_d = held(dims)
    print(f"[k2] {2 * len(dims)} tensor-core cases (bf16, D 16/32/64/128: "
          f"ragged 33 x 7 and 129 x 77, GQA groups 2 and 8, carried state, "
          f"fully masked rows, permuted ring positions; scale -0.125 and 0) "
          f"within rtol 1e-4 of the plain version; max |err| of o/l "
          f"{worst_d:.3g}")

    # views: the wrapper copies an operand that is not contiguous or (bf16
    # q, k, v) does not start on 16 bytes, as the reference takes any
    # array (one head count: a GQA fold would copy the views itself)
    args = case(8, 8, 129, 77, bf, True)
    views = [_transposed(args[0]), _offset(args[1]), _offset(args[2]),
             args[3], args[4], _transposed(args[5])] + list(args[6:])
    check(not views[0].is_contiguous() and views[1].data_ptr() % 16,
          "the K2 view case holds no view")
    for causal in (True, False):
        got = k2.flash_block_update_hld(*views, causal=causal, scale=0.125)
        want = k2.flash_block_update_hld(*args, causal=causal, scale=0.125)
        torch.cuda.synchronize()
        check(all(same_bits(g, w) for g, w in zip(got, want)),
              f"K2 on views differs from K2 on contiguous copies "
              f"(causal={causal})")
    print("[k2] views (transposed q and o, k and v one bf16 element into "
          "their storage) give the bits of their contiguous copies")

    stats = {}
    for label, h, dtype, rate in (("prefill", 512, bf, PEAK_BF16_FLOPS),
                                  ("training", 64, bf, PEAK_BF16_FLOPS),
                                  ("f32 route", 512, f32, PEAK_F32_FLOPS)):
        q, k, v, m, l, o, qp, kp = case(h, h, 1024, 1024, dtype, False)

        def kern():
            return k2.flash_block_update_hld(q, k, v, m, l, o, qp, kp,
                                             causal=True, scale=0.125)
        q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                  scale=0.125)
        # in turns (kernel, library, kernel, library): the card's clock
        # drifts between calls
        turns = [time_ms(fn, iters=10, per=10) for fn in (kern, sdpa) * 2]
        ms = statistics.median(turns[0::2])
        lib = statistics.median(turns[1::2])
        one = time_ms(kern, iters=10)
        plain = time_ms(lambda: k2.flash_block_update_hld_plain(
            q, k, v, m, l, o, qp, kp, causal=True, scale=0.125), iters=5)
        pairs = h * int((kp[0][None, :] <= qp[0][:, None]).sum())
        nbytes, bound, by = _k2_bound(h, 1024, 1024, 64, q.element_size(),
                                      pairs, rate)
        stats[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                            bound_ms=bound, bound_by=by,
                            max_abs_err=max(worst, worst_d))
        print(f"[k2] {label}: causal {h} heads x 1024 x 64 {dtype}: kernel "
              f"{ms:.4f} ms a launch in runs of 10 ({one:.4f} ms alone), "
              f"scaled_dot_product_attention {lib:.4f} ms "
              f"({ms / lib:.2f}x), plain {plain:.4f} ms, bound {bound:.4f} "
              f"ms ({by}: {nbytes} B / 3.35 TB/s, {4 * 64 * pairs} flop / "
              f"{rate / 1e12:.0f} TFLOP/s), kernel at "
              f"{100 * bound / ms:.1f}% of bound")
    return stats


def _int8_cache(x):
    """Seq-minor (b, g, d, L) f32 -> int8 + (b, g, L) scales."""
    import torch
    amax = x.abs().amax(dim=2)
    s = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    return torch.round(x / s[:, :, None, :]).to(torch.int8), s


def phase_k6(dev) -> dict:
    """K6 at T = 1 and 4, batch 32, L 1088, 16 kv heads, hd 64, bf16 and
    int8 caches, scalar and ragged positions (one past max_len, as a
    retired serving slot has), plus GQA groups 2 and 8. Tolerance rtol
    1e-3 / atol 2e-3: the kernel and its plain twin share the tile
    partition and the bf16 roundings, and differ in f32 summation order
    and the last bit of exp (which can move a probability across a bf16
    rounding boundary)."""
    import torch
    import torch.nn.functional as F
    from rlo_tpu_torch.kernels import decode as kd

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    L = 1088

    def caches(b, nkv, kind):
        k = torch.randn(b, nkv, 64, L, generator=gen, device=dev)
        v = torch.randn(b, nkv, 64, L, generator=gen, device=dev)
        if kind == "int8":
            (k, ks), (v, vs) = _int8_cache(k), _int8_cache(v)
            return k, v, ks, vs
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return k.to(dt), v.to(dt), None, None

    worst, n = 0.0, 0
    for b, nkv, nh in ((32, 16, 16), (4, 8, 16), (4, 2, 16)):
        for kind in ("bf16", "int8", "f32"):
            if kind == "f32" and nkv != 16:
                continue
            k, v, ks, vs = caches(b, nkv, kind)
            for T in (1, 4):
                q = torch.randn(b, T, nh, 64, generator=gen,
                                device=dev).to(torch.bfloat16)
                ragged = torch.randint(0, L - T, (b,), generator=gen,
                                       device=dev, dtype=torch.int32)
                ragged[0] = L + 5          # a retired slot past max_len
                for pos in (torch.tensor(L - T, dtype=torch.int32,
                                         device=dev), ragged):
                    got = kd.flash_block_decode(q, k, v, pos, 0.125, ks, vs)
                    want = kd.flash_block_decode_plain(q, k, v, pos, 0.125,
                                                       ks, vs)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(got).all()) and bool(
                        torch.allclose(got, want, rtol=1e-3, atol=2e-3)),
                        f"K6 b={b} kvh={nkv} {kind} T={T} "
                        f"pos={'ragged' if pos.dim() else 'scalar'} differs "
                        f"from its plain version")
                    worst = max(worst, abs_err(got, want))
                    n += 1
    print(f"[k6] {n} cases (T 1 and 4, batch 32 x 16 kv heads x L {L} x hd "
          f"64, GQA groups 1/2/8, bf16/int8/f32 caches, scalar and ragged "
          f"pos incl. one past max_len) within rtol 1e-3 / atol 2e-3 of the "
          f"plain version; max |err| {worst:.3g}")

    out = {}
    for kind in ("bf16", "int8"):
        k, v, ks, vs = caches(32, 16, kind)
        q = torch.randn(32, 1, 16, 64, generator=gen,
                        device=dev).to(torch.bfloat16)
        pos = torch.tensor(L - 1, dtype=torch.int32, device=dev)
        kern = time_ms(lambda: kd.flash_block_decode(q, k, v, pos, 0.125,
                                                     ks, vs))
        plain = time_ms(lambda: kd.flash_block_decode_plain(
            q, k, v, pos, 0.125, ks, vs), iters=5)
        lib = None
        if kind == "bf16":
            qh = q.transpose(1, 2)                        # (b, h, 1, d)
            kh, vh = k.transpose(2, 3), v.transpose(2, 3)  # (b, h, L, d)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, scale=0.125))
        nbytes = 2 * k.numel() * k.element_size() + (
            2 * ks.numel() * 4 if ks is not None else 0)
        bound = nbytes / PEAK_HBM_BYTES_S * 1e3
        out[kind] = dict(ms=kern, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by="bytes")
        print(f"[k6] T=1 batch 32 x 16 kv heads x L {L} {kind} cache: kernel "
              f"{kern:.4f} ms, plain {plain:.4f} ms, "
              f"scaled_dot_product_attention "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound:.4f} ms ({nbytes} B of live cache / 3.35 TB/s), "
              f"kernel at {100 * bound / kern:.1f}% of bound")
    out["bf16"]["max_abs_err"] = worst
    return out["bf16"]


def phase_writes(dev) -> dict:
    """K7 and K8 bit-identical to their plain versions, out-of-range
    positions included (they must leave the cache unchanged)."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    n = 0

    def same(fn_k, fn_p, cache, what):
        nonlocal n
        a, b = cache.clone(), cache.clone()
        fn_k(a)
        fn_p(b)
        torch.cuda.synchronize()
        check(same_bits(a, b), f"{what} is not bit-identical to its plain "
                               f"version")
        n += 1
        return a

    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        for shape in ((32, 16, 64, 1088), (32, 16, 1, 1088)):  # + scales
            if dtype == torch.int8:
                cache = torch.randint(-127, 128, shape, generator=gen,
                                      device=dev, dtype=torch.int8)
            else:
                cache = torch.randn(shape, generator=gen,
                                    device=dev).to(dtype)
            b, L = shape[0], shape[3]
            row = cache[..., 7].clone() + (1 if dtype == torch.int8 else 0.5)
            rows = cache[..., 100:164].clone() + 1
            ragged = torch.randint(0, L, (b,), generator=gen, device=dev,
                                   dtype=torch.int32)
            ragged[:3] = torch.tensor([L, L + 999, L - 1], device=dev)
            for pos in (ragged, torch.tensor(1000, dtype=torch.int32,
                                             device=dev),
                        torch.tensor(L, dtype=torch.int32, device=dev)):
                p_desc = "ragged" if pos.dim() else int(pos)
                out = same(lambda c: kd.write_kv_row(c, row, pos),
                           lambda c: kd.write_kv_row_plain(c, row, pos),
                           cache, f"K7 {dtype} {shape} pos {p_desc}")
                same(lambda c: kd.write_kv_block(c, rows, pos),
                     lambda c: kd.write_kv_block_plain(c, rows, pos),
                     cache, f"K8 {dtype} {shape} pos0 {p_desc}")
                if not pos.dim() and int(pos) >= L:
                    check(same_bits(out, cache), f"K7 at pos {int(pos)} "
                                                 f"changed the cache")
    print(f"[k7/k8] {n} cases (bf16/int8/f32 caches and f32 scale "
          f"sidecars, batch 32 x L 1088, ragged and scalar pos incl. out of "
          f"range, T 64 blocks straddling the end) bit-identical to the "
          f"plain versions")

    out = {}
    cache = torch.randn(32, 16, 64, 1088, generator=gen,
                        device=dev).to(torch.bfloat16)
    row = torch.randn(32, 16, 64, generator=gen, device=dev) \
        .to(torch.bfloat16)
    pos = torch.randint(0, 1088, (32,), generator=gen, device=dev,
                        dtype=torch.int32)
    bidx = torch.arange(32, device=dev)

    def lib_row():
        cache[bidx, :, :, pos] = row

    out["K7"] = dict(
        ms=time_ms(lambda: kd.write_kv_row(cache, row, pos)),
        plain_ms=time_ms(lambda: kd.write_kv_row_plain(cache, row, pos)),
        library_ms=time_ms(lib_row),
        bound_ms=row.numel() * 2 / PEAK_HBM_BYTES_S * 1e3, bound_by="bytes")
    rcache = torch.randn(1, 16, 64, 256, generator=gen,
                         device=dev).to(torch.bfloat16)
    rows = torch.randn(1, 16, 64, 64, generator=gen, device=dev) \
        .to(torch.bfloat16)
    p0 = torch.tensor(64, dtype=torch.int32, device=dev)

    def lib_block():
        rcache[:, :, :, 64:128] = rows

    out["K8"] = dict(
        ms=time_ms(lambda: kd.write_kv_block(rcache, rows, p0)),
        plain_ms=time_ms(lambda: kd.write_kv_block_plain(rcache, rows, p0)),
        library_ms=time_ms(lib_block),
        bound_ms=rows.numel() * 2 / PEAK_HBM_BYTES_S * 1e3, bound_by="bytes")
    for name, shape, st in (("K7", "row (32, 16, 64) into (32, 16, 64, 1088)",
                             out["K7"]),
                            ("K8", "block (1, 16, 64, 64) into "
                                   "(1, 16, 64, 256)", out["K8"])):
        print(f"[{name.lower()}] bf16 {shape}: kernel {st['ms']:.4f} ms, "
              f"plain {st['plain_ms']:.4f} ms, indexed assignment "
              f"{st['library_ms']:.4f} ms, bound {st['bound_ms']:.6f} ms "
              f"(bytes written / 3.35 TB/s)")
        st["max_abs_err"] = 0.0
    return out


def _live_bytes(pos, T, L, nkv, hd, esize, quant) -> int:
    """Bytes of k, v (and the int8 scales) a decode attention must read:
    positions [0, min(pos_b + T, L)) of every row, each once."""
    live = int((pos.long() + T).clamp(0, L).sum())
    return live * nkv * (2 * hd * esize + (8 if quant else 0))


def phase_k9(dev) -> dict:
    """K9 at the paged decode shape (batch 32 x 16 kv heads x hd 64,
    pages of 128 over 9 logical pages, 289 pages with a seeded
    permutation as the table, positions spread over 0..1087, T 1; bf16
    and int8 pools), a prefill chunk (batch 1, T 128), GQA group 4 and
    pages of 256, each against its plain version at K6's tolerance (rtol
    1e-3 / atol 2e-3: shared tile partition and bf16 roundings, another
    f32 summation order). Then K9 on pages holding a dense cache's
    columns against K6 on that cache: equal bit for bit. Times K9, its
    plain version and K6 on the equivalent dense cache (the yardstick of
    the indirection's cost); no single PyTorch call computes paged
    attention, so there is no library figure."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models import paged as PG

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    L = 1088

    def pools(P, nkv, ps, kind):
        k = torch.randn(P, nkv, 64, ps, generator=gen, device=dev)
        v = torch.randn(P, nkv, 64, ps, generator=gen, device=dev)
        if kind == "int8":
            (k, ks), (v, vs) = _int8_cache(k), _int8_cache(v)
            return k, v, ks, vs
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return k.to(dt), v.to(dt), None, None

    def table_of(b, mp, P):
        perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
        return perm[:b * mp].to(torch.int32).reshape(b, mp).contiguous()

    def spread(b, T, hi):
        pos = torch.randint(0, hi - T + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        pos[0], pos[-1] = 0, hi - T
        return pos

    worst, n = 0.0, 0
    # (label, b, nh, kvh, ps, mp, T, kinds)
    cases = [("decode", 32, 16, 16, 128, 9, 1, ("bf16", "int8", "f32")),
             ("decode T=4", 32, 16, 16, 128, 9, 4, ("bf16", "int8")),
             ("prefill chunk", 1, 16, 16, 128, 9, 128, ("bf16", "int8")),
             ("GQA group 4", 8, 16, 4, 128, 9, 4, ("bf16", "int8")),
             ("pages of 256", 32, 16, 16, 256, 5, 1, ("bf16", "int8"))]
    for label, b, nh, nkv, ps, mp, T, kinds in cases:
        P = b * mp + 1
        table = table_of(b, mp, P)
        table[b // 2, mp // 2:] = 0           # unmapped tail: null page
        for kind in kinds:
            k, v, ks, vs = pools(P, nkv, ps, kind)
            q = torch.randn(b, T, nh, 64, generator=gen,
                            device=dev).to(torch.bfloat16)
            pos = spread(b, T, min(L, mp * ps))
            pos[b // 2] = min(pos[b // 2], (mp // 2) * ps - T)
            got = kd.paged_flash_decode(q, k, v, table, pos, 0.125, ks, vs)
            want = kd.paged_flash_decode_plain(q, k, v, table, pos, 0.125,
                                               ks, vs)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()) and bool(
                torch.allclose(got, want, rtol=1e-3, atol=2e-3)),
                f"K9 {label} {kind} differs from its plain version")
            worst = max(worst, abs_err(got, want))
            n += 1
    print(f"[k9] {n} cases (decode b 32 x 16 kv heads x hd 64 over 289 "
          f"permuted pages of 128, T 1/4; a prefill chunk b 1 x T 128; GQA "
          f"group 4; pages of 256; bf16/int8/f32 pools, null-page tails) "
          f"within rtol 1e-3 / atol 2e-3 of the plain version; max |err| "
          f"{worst:.3g}")

    # K9 on pages that hold a dense cache's columns == K6 on that cache
    out = {}
    b, nkv, ps, mp = 32, 16, 128, 9
    P = b * mp + 1
    table = table_of(b, mp, P)
    pos = spread(b, 1, L)
    same = {}
    for kind in ("bf16", "int8"):
        kc = torch.randn(b, nkv, 64, L, generator=gen, device=dev)
        vc = torch.randn(b, nkv, 64, L, generator=gen, device=dev)
        if kind == "int8":
            (kc, ksc), (vc, vsc) = _int8_cache(kc), _int8_cache(vc)
        else:
            kc, vc, ksc, vsc = kc.to(torch.bfloat16), vc.to(torch.bfloat16), \
                None, None
        dense = {"k": kc, "v": vc} | ({} if ksc is None else
                                      {"ks": ksc, "vs": vsc})
        paged = PG.pages_from_dense([dense], table, P, ps)[0]
        q = torch.randn(b, 1, 16, 64, generator=gen,
                        device=dev).to(torch.bfloat16)
        k9 = kd.paged_flash_decode(q, paged["k"], paged["v"], table, pos,
                                   0.125, paged.get("ks"), paged.get("vs"))
        k6 = kd.flash_block_decode(q, kc, vc, pos, 0.125, ksc, vsc)
        torch.cuda.synchronize()
        same[kind] = abs_err(k9, k6)
        check(torch.equal(k9, k6), f"K9 on pages holding the dense cache's "
                                   f"columns differs from K6 ({kind}): max "
                                   f"|err| {same[kind]}")
        k9_fn = lambda: kd.paged_flash_decode(  # noqa: E731
            q, paged["k"], paged["v"], table, pos, 0.125, paged.get("ks"),
            paged.get("vs"))
        k6_fn = lambda: kd.flash_block_decode(  # noqa: E731
            q, kc, vc, pos, 0.125, ksc, vsc)
        # in turns (K9, K6, K6, K9), so neither gains from going second
        t = [time_ms(fn) for fn in (k9_fn, k6_fn, k6_fn, k9_fn)]
        kern, dense_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        plain = time_ms(lambda: kd.paged_flash_decode_plain(
            q, paged["k"], paged["v"], table, pos, 0.125, paged.get("ks"),
            paged.get("vs")), iters=5)
        nbytes = (_live_bytes(pos, 1, L, nkv, 64, kc.element_size(),
                              ksc is not None)
                  + table.numel() * 4 + pos.numel() * 4
                  + q.numel() * 2 + q.numel() * 4)
        bound = nbytes / PEAK_HBM_BYTES_S * 1e3
        out[kind] = dict(ms=kern, plain_ms=plain, library_ms=None,
                         bound_ms=bound, bound_by="bytes", k6_ms=dense_ms)
        extra = 100 * (kern / dense_ms - 1)
        print(f"[k9] T=1 batch 32 x 16 kv heads, 289 pages of 128, ragged "
              f"pos {kind} pools: kernel {kern:.4f} ms, K6 on the same "
              f"columns dense {dense_ms:.4f} ms ({extra:+.1f} %), plain "
              f"{plain:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes} B live cache + table + q + out / 3.35 TB/s), "
              f"kernel at {100 * bound / kern:.1f}% of bound; max |K9 - K6| "
              f"{same[kind]}")
    out["bf16"]["max_abs_err"] = worst
    out["bf16"]["k6_equal_max_abs_err"] = max(same.values())
    return out


def phase_page_writes(dev) -> dict:
    """K10 and K11 bit-identical to their plain versions, the drop
    sentinels included (off = ps, a negative off, pads past n_valid, a
    page past the pool), on bf16/int8/f32 pools and the f32 scale pools'
    (P, kvh, 1, ps) view; then their times at the serving path's
    shapes."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    P, b, ps = 289, 32, 128
    n = 0

    def same(fn_k, fn_p, pool, what):
        nonlocal n
        a, c = pool.clone(), pool.clone()
        fn_k(a)
        fn_p(c)
        torch.cuda.synchronize()
        check(same_bits(a, c), f"{what} is not bit-identical to its plain "
                               f"version")
        n += 1

    page = (torch.randperm(P - 1, generator=gen, device=dev)[:b] + 1) \
        .to(torch.int32)
    page[5] = P + 7                           # past the pool: clamped
    off = torch.randint(0, ps, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    off[:3] = torch.tensor([ps, -1, ps - 1], device=dev)
    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        for shape in ((P, 16, 64, ps), (P, 16, 1, ps)):   # + scale pools
            if dtype == torch.int8:
                pool = torch.randint(-127, 128, shape, generator=gen,
                                     device=dev, dtype=torch.int8)
            else:
                pool = torch.randn(shape, generator=gen,
                                   device=dev).to(dtype)
            row = pool[:b, ..., 7].clone() + (1 if dtype == torch.int8
                                              else 0.5)
            rows = pool[9, ..., :].clone() + 1
            same(lambda t: kd.write_kv_page_row(t, row, page, off),
                 lambda t: kd.write_kv_page_row_plain(t, row, page, off),
                 pool, f"K10 {dtype} {shape}")
            for pg, o0, nv, T in ((3, 0, ps, ps), (4, 100, 28, ps),
                                  (5, 0, 5, ps), (P + 3, 64, 64, 64),
                                  (6, -3, 10, 32), (7, ps - 8, 16, 16)):
                same(lambda t: kd.write_kv_page_block(t, rows[..., :T], pg,
                                                      o0, nv),
                     lambda t: kd.write_kv_page_block_plain(
                         t, rows[..., :T], pg, o0, nv),
                     pool, f"K11 {dtype} {shape} page {pg} off0 {o0} "
                           f"n_valid {nv} T {T}")
    print(f"[k10/k11] {n} cases (bf16/int8/f32 pools of 289 pages x 16 kv "
          f"heads x 64 x 128 and f32 scale pools; off = ps, -1, a page past "
          f"the pool; chunks with pads, at the page edge, from a negative "
          f"start) bit-identical to the plain versions")

    out = {}
    pool = torch.randn(P, 16, 64, ps, generator=gen,
                       device=dev).to(torch.bfloat16)
    row = torch.randn(b, 16, 64, generator=gen, device=dev) \
        .to(torch.bfloat16)
    page = (torch.randperm(P - 1, generator=gen, device=dev)[:b] + 1) \
        .to(torch.int32)
    off = torch.randint(0, ps, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pidx, oidx = page.long(), off.long()

    def lib_row():
        pool[pidx, :, :, oidx] = row

    out["K10"] = dict(
        ms=time_ms(lambda: kd.write_kv_page_row(pool, row, page, off)),
        plain_ms=time_ms(lambda: kd.write_kv_page_row_plain(pool, row, page,
                                                            off)),
        library_ms=time_ms(lib_row),
        bound_ms=(2 * row.numel() * 2 + 2 * b * 4) / PEAK_HBM_BYTES_S * 1e3,
        bound_by="bytes")
    rows = torch.randn(16, 64, ps, generator=gen, device=dev) \
        .to(torch.bfloat16)
    pg, o0, nv = (torch.tensor([x], dtype=torch.int32, device=dev)
                  for x in (17, 0, ps))

    def lib_block():
        pool[17, :, :, 0:ps] = rows

    out["K11"] = dict(
        ms=time_ms(lambda: kd.write_kv_page_block(pool, rows, pg, o0, nv)),
        plain_ms=time_ms(lambda: kd.write_kv_page_block_plain(pool, rows, pg,
                                                              o0, nv)),
        library_ms=time_ms(lib_block),
        bound_ms=(2 * rows.numel() * 2 + 12) / PEAK_HBM_BYTES_S * 1e3,
        bound_by="bytes")
    for name, shape, st in (("K10", "rows (32, 16, 64) into 289 pages of "
                                    "(16, 64, 128)", out["K10"]),
                            ("K11", "chunk (16, 64, 128) into one page",
                             out["K11"])):
        print(f"[{name.lower()}] bf16 {shape}: kernel {st['ms']:.4f} ms, "
              f"plain {st['plain_ms']:.4f} ms, indexed assignment "
              f"{st['library_ms']:.4f} ms, bound {st['bound_ms']:.6f} ms "
              f"(rows read + bytes written / 3.35 TB/s)")
        st["max_abs_err"] = 0.0
    return out


# ---------------------------------------------------------------------------
# Phase 5: serving at full width
# ---------------------------------------------------------------------------

def top2_gap(logits, cfg):
    """Each row's top-2 logit gap; for bf16 configs rescaled so that
    ``NEAR_TIE`` stands for the larger of 1e-2 and ``NEAR_TIE_ULPS`` bf16
    ulps of the top logit (the logits' own resolution)."""
    import torch
    top = torch.topk(logits, 2, dim=-1).values
    gap = top[:, 0] - top[:, 1]
    if cfg.act_dtype == torch.bfloat16:
        # bf16 logits: a gap of a few ulps is as close as they get
        ulp = torch.exp2(torch.floor(torch.log2(top[:, 0].abs())) - 7)
        gap = gap * (NEAR_TIE / torch.maximum(
            torch.full_like(ulp, NEAR_TIE), NEAR_TIE_ULPS * ulp))
    return gap


def greedy_with_gaps(params, prompt, cfg, max_new, prompt_lengths=None):
    """Greedy generation through the port's prefill/decode_step (the loop
    of ``generate``), also returning each pick's top-2 logit gap, so a
    comparison can stop at a near-tie. For bf16 configs the gap is
    rescaled so that ``NEAR_TIE`` stands for the larger of 1e-2 and
    ``NEAR_TIE_ULPS`` bf16 ulps of the top logit (the logits' own
    resolution). Returns host arrays (tokens, gaps), each (b,
    max_new)."""
    import torch
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models.transformer import cast_params

    params = cast_params(params, cfg.act_dtype)
    dev = params["embed"].device
    b, plen = prompt.shape
    cache = G.init_kv_cache(cfg, b, plen + max_new, device=dev)
    if prompt_lengths is None:
        logits, _ = G.prefill(params, prompt, cache, cfg)
        pos = torch.tensor(plen, dtype=torch.int32, device=dev)
    else:
        pos = torch.as_tensor(prompt_lengths, dtype=torch.int32, device=dev)
        logits, _ = G.prefill(params, prompt, cache, cfg,
                              last_index=pos - 1)
    toks, gaps = [], []
    for i in range(max_new):
        gaps.append(top2_gap(logits, cfg))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
        if i + 1 < max_new:
            logits, _ = G.decode_step(params, tok, pos, cache, cfg)
            pos = pos + 1
    return (torch.stack(toks, 1).cpu().numpy(),
            torch.stack(gaps, 1).float().cpu().numpy())


def compare_until_near_tie(got, want, gaps):
    """Tokens equal to the reference run's, position by position. Where
    they part, the reference's top-2 logit gap there must be under
    NEAR_TIE (a near-tie, which another summation order may flip), and
    the comparison ends: the contexts differ after it. Returns
    (positions compared equal, whether the comparison reached the
    end); raises on a parting away from a near-tie."""
    import numpy as np
    n = len(got)
    bad = np.nonzero(np.asarray(got) != np.asarray(want[:n]))[0]
    if len(bad) == 0:
        return n, True
    p = int(bad[0])
    check(gaps[p] < NEAR_TIE, f"tokens part at position {p} where the "
                              f"reference's top-2 gap is {gaps[p]:.4g}")
    return p, False


def _timed(G, params, prompt, cfg, max_new, what):
    from rlo_tpu_torch.utils.metrics import Registry
    reg = Registry()
    toks = G.generate_timed(params, prompt, cfg, max_new=max_new,
                            metrics=reg)
    h = reg.snapshot()["histograms"]
    ttft = h["serve.ttft_usec"]["sum"] / 1e3
    tok_ms = h["serve.tok_usec"]["sum"] / 1e3
    b = prompt.shape[0]
    check(tuple(toks.shape) == (b, max_new), f"{what}: tokens shape "
                                              f"{tuple(toks.shape)}")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"{what}: token ids out of range")
    print(f"[serve] {what}: TTFT {ttft:.1f} ms, {tok_ms:.3f} ms per decode "
          f"step, {b / tok_ms * 1e3:.0f} tok/s decode")
    return toks, dict(ttft_ms=ttft, ms_per_token=tok_ms,
                      tok_per_s=b / tok_ms * 1e3)


def phase_serving(dev) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models import serve as S
    from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params)
    from rlo_tpu_torch.utils.metrics import Registry

    out = {}
    cfg = TransformerConfig(**SERVE_CFG)
    params = init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    prompt = torch.randint(0, cfg.vocab, (32, 1024), generator=gen,
                           device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    G.generate(params, prompt, cfg, max_new=2)   # warm-up: library setup
    toks, out["generate_bf16"] = _timed(
        G, params, prompt, cfg, 64,
        "generate batch 32, plen 1024, 64 new, bf16 cache")
    qcfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    qtoks, out["generate_int8"] = _timed(
        G, params, prompt, qcfg, 16,
        "generate batch 32, plen 1024, 16 new, int8 cache")
    agree = float((qtoks == toks[:, :16]).float().mean())
    print(f"[serve] int8 cache tokens equal the bf16 cache's at "
          f"{100 * agree:.1f}% of positions (quantisation moves near-ties)")
    out["generate_int8"]["agree_with_bf16"] = agree

    gcfg = TransformerConfig(**GQA_CFG)
    gparams = init_params(gcfg, seed=SEED + 1, device=dev)
    gprompt = torch.randint(0, gcfg.vocab, (4, 128), generator=gen,
                            device=dev, dtype=torch.int32)
    gtoks, out["generate_gqa_rope"] = _timed(
        G, gparams, gprompt, gcfg, 32,
        "GQA+RoPE (8 heads, 2 kv heads) generate batch 4, plen 128, 32 new")
    # the whole path against the plain versions on the CPU, same weights
    # and prompts, in f32: bf16 on two devices rounds differently
    fcfg = dataclasses.replace(gcfg, dtype="float32")
    card, _ = greedy_with_gaps(gparams, gprompt, fcfg, 32)
    ref, gaps = greedy_with_gaps(_to_device(gparams, "cpu"), gprompt.cpu(),
                                 fcfg, 32)
    compared = [compare_until_near_tie(card[i], ref[i], gaps[i])
                for i in range(4)]
    print(f"[serve] GQA+RoPE in f32, tokens on the card (K2, K6, K7) "
          f"against the plain versions on the CPU (same weights and "
          f"prompts): equal positions per row {[c[0] for c in compared]} "
          f"of 32, any parting at a near-tie (top-2 gap < {NEAR_TIE})")
    out["generate_gqa_rope"]["cpu_positions_compared"] = \
        [c[0] for c in compared]
    print(f"[serve] generate phases took {time.perf_counter() - t0:.1f} s")

    # the continuous-batching server (serve_bench's shape)
    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(32):
        if i % 8 == 3:    # long prompts: admission extends past the bucket
            reqs.append((rng.integers(0, cfg.vocab, int(rng.integers(96, 161))),
                         int(rng.integers(16, 65))))
        else:
            reqs.append((rng.integers(0, cfg.vocab, int(rng.integers(32, 65))),
                         int(rng.integers(16, 161))))
    reg = Registry()
    srv = S.DecodeServer(params, cfg, n_slots=8, max_len=256, round_len=32,
                         prompt_buckets=(64,), metrics=reg)
    t0 = time.perf_counter()
    for p, m in reqs:
        srv.submit(p, m)
    outs = srv.run()
    wall = time.perf_counter() - t0
    ntok = sum(len(o) for o in outs)
    check([len(o) for o in outs] == [m for _, m in reqs],
          "DecodeServer returned the wrong number of tokens")
    # oracle: the port's generate of each prompt alone (one call per
    # request; a ragged batch-32 prefill runs other GEMM shapes, whose
    # bf16 roundings move the K/V rows enough to flip exact bf16 ties)
    compared, gaps = [], []
    for i, (p, m) in enumerate(reqs):
        ptens = torch.as_tensor(p[None].astype(np.int32), device=dev)
        want = G.generate(params, ptens, cfg, max_new=m)[0].cpu().numpy()
        wtoks, g = greedy_with_gaps(params, ptens, cfg, m)
        check(bool((wtoks[0] == want).all()),
              f"greedy_with_gaps differs from generate on request {i}")
        gaps.append(g[0])
        compared.append(compare_until_near_tie(outs[i], want, g[0]))
    full = sum(1 for _, done in compared if done)
    for i, (upto, done) in enumerate(compared):
        if not done:
            print(f"[serve] request {i}: tokens part at position {upto} of "
                  f"{len(outs[i])}, a near-tie (scaled top-2 gap "
                  f"{gaps[i][upto]:.4g})")
    check(full >= 24, f"only {full} of 32 requests compared to the end")
    st = srv.stats()
    hs = st["histograms"]
    summary = {k: {q: hs[k][q] for q in ("count", "mean", "p50", "p99")}
               for k in ("serve.ttft_usec", "serve.e2e_usec",
                         "serve.tok_usec")}
    print(f"[serve] DecodeServer(n_slots=8, max_len=256, round_len=32, "
          f"buckets (64,)): 32 requests (4 extended past the bucket), "
          f"{ntok} tokens in {wall:.2f} s ({ntok / wall:.0f} tok/s), "
          f"{srv.rounds_run} rounds / {srv.steps_run} steps; tokens equal "
          f"each prompt's own generate, {full} of 32 to the end and the rest up "
          f"to a parting at a near-tie (top-2 gap < max({NEAR_TIE}, "
          f"{NEAR_TIE_ULPS} bf16 ulps))")
    print(f"[serve] stats: {json.dumps(summary)}")
    out["server"] = dict(requests=32, tokens=ntok, wall_s=wall,
                         tok_per_s=ntok / wall, rounds=srv.rounds_run,
                         steps=srv.steps_run, compared_to_end=full,
                         stats=summary)
    return out


def paged_requests(vocab: int, rng):
    """The paged server's 32 requests: 16 share a 256-token prefix (a
    16-96-token suffix), 12 are unrelated (32-400 tokens), 4 repeat an
    earlier short prompt exactly, queued after position 8 so that the
    original's pages are in the trie when they are admitted; max_new
    16-128. Returns [(prompt, max_new, kind)]."""
    import numpy as np
    prefix = rng.integers(0, vocab, PAGED_PREFIX)

    def shared():
        suffix = rng.integers(0, vocab, int(rng.integers(16, 97)))
        return np.concatenate([prefix, suffix]), "shared"

    def unrelated(hi):
        return rng.integers(0, vocab, int(rng.integers(32, hi + 1))), \
            "unrelated"

    kinds = []
    for i in range(8):     # the first pass: short unrelated ones prefill
        kinds.append(shared() if i % 2 == 0 else unrelated(200))  # at once
    dups = iter([1, 3, 5, 7])
    n_shared, n_unrel = 4, 4
    for i in range(8, 32):
        if i in (8, 13, 18, 23):
            kinds.append((kinds[next(dups)][0].copy(), "duplicate"))
        elif n_shared < 16 and (i % 2 == 0 or n_unrel >= 12):
            kinds.append(shared())
            n_shared += 1
        else:
            kinds.append(unrelated(400))
            n_unrel += 1
    return [(p, int(rng.integers(16, 129)), k) for p, k in kinds]


def paged_reference(params, cfg, reqs, ps, group):
    """Each request alone through the paged path: its prompt in the
    page-aligned chunks the server prefills (``paged_prefill_chunk``, one
    request at a time), then greedy ``paged_decode_step``s in batches of
    ``group`` rows (the server's decode batch, so its matrix products
    keep their shapes). Returns per request (tokens, top-2 gaps)."""
    import numpy as np
    import torch
    from rlo_tpu_torch.models import paged as PG
    dev = params["embed"].device
    out = []
    for g0 in range(0, len(reqs), group):
        rows = reqs[g0:g0 + group]
        need = [-(-(len(p) + m) // ps) for p, m, _ in rows]
        pools = PG.init_page_pool(cfg, sum(need) + 1, ps, device=dev)
        table = np.zeros((len(rows), max(need)), np.int32)
        nxt = 1
        for i, n in enumerate(need):
            table[i, :n] = np.arange(nxt, nxt + n)
            nxt += n
        table = torch.as_tensor(table, device=dev)
        firsts = []
        for i, (p, _, _) in enumerate(rows):
            for a in range(0, len(p), ps):
                n = min(ps, len(p) - a)
                toks = np.zeros((1, ps), np.int32)
                toks[0, :n] = p[a:a + n]
                logits, _ = PG.paged_prefill_chunk(
                    params, torch.as_tensor(toks, device=dev), a, n, pools,
                    table[i:i + 1], cfg)
            firsts.append(logits)
        logits = torch.cat(firsts)
        budget = torch.as_tensor([m for _, m, _ in rows], device=dev)
        pos = torch.as_tensor([len(p) for p, _, _ in rows], device=dev,
                              dtype=torch.int32)
        toks, gaps = [], []
        for step in range(int(budget.max())):
            gaps.append(top2_gap(logits, cfg))
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
            active = step + 1 < budget
            if bool(active.any()):
                logits, _ = PG.paged_decode_step(params, tok, pos, pools,
                                                 table, active, cfg)
                pos = pos + active.to(torch.int32)
        toks = torch.stack(toks, 1).cpu().numpy()
        gaps = torch.stack(gaps, 1).float().cpu().numpy()
        out += [(toks[i, :m], gaps[i, :m])
                for i, (_, m, _) in enumerate(rows)]
    return out


def phase_paged_serving(dev, counted) -> dict:
    """Paged serving at full width on the flagship config: (a) a batch-32
    prefill of 1024 tokens into a dense cache, its columns copied into
    289 permuted pages, then 64 teacher-forced steps of
    ``paged_decode_step`` beside ``decode_step`` (greedy tokens equal at
    every position); (b) a paged ``DecodeServer`` with 32 requests that
    share prefixes and repeat prompts, held against each request's own
    paged reference (at least 24 of 32 to the end) and against each
    prompt's own ``generate``, partings only at near-ties. ``counted`` kernels' launch
    counts are set to 0 just before the server run and read just after
    it."""
    import numpy as np
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models import paged as PG
    from rlo_tpu_torch.models import serve as S
    from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                                  cast_params, init_params)
    from rlo_tpu_torch.utils.metrics import Registry

    out = {}
    cfg = TransformerConfig(**SERVE_CFG)
    params = cast_params(init_params(cfg, seed=SEED, device=dev),
                         cfg.act_dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    b, plen, steps, ps = PAGED_TF["batch"], PAGED_TF["plen"], \
        PAGED_TF["steps"], 128
    L = plen + steps
    mp = -(-L // ps)
    P = b * mp + 1
    prompt = torch.randint(0, cfg.vocab, (b, plen), generator=gen,
                           device=dev, dtype=torch.int32)
    cache = G.init_kv_cache(cfg, b, L, device=dev)
    logits, _ = G.prefill(params, prompt, cache, cfg)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[:b * mp] + 1) \
        .to(torch.int32).reshape(b, mp).contiguous()
    pools = PG.pages_from_dense(cache, table, P, ps)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    pos = torch.full((b,), plen, dtype=torch.int32, device=dev)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    dense_ms, paged_ms, dmax = [], [], 0.0
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dl, _ = G.decode_step(params, tok, pos, cache, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pl, _ = PG.paged_decode_step(params, tok, pos, pools, table, active,
                                     cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dense_ms.append((t1 - t0) * 1e3)
        paged_ms.append((t2 - t1) * 1e3)
        dtok = torch.argmax(dl, dim=-1).to(torch.int32)
        check(torch.equal(dtok, torch.argmax(pl, dim=-1).to(torch.int32)),
              f"paged and dense greedy tokens differ at step {i}")
        dmax = max(dmax, abs_err(pl, dl))
        tok, pos = dtok, pos + 1
    out["teacher_forced"] = dict(
        steps=steps, max_abs_logit_diff=dmax,
        dense_ms_per_step=statistics.median(dense_ms),
        paged_ms_per_step=statistics.median(paged_ms))
    print(f"[paged] teacher-forced batch {b}, plen {plen}, {steps} steps, "
          f"{P} pages of {ps} (permuted): greedy tokens equal at every step, "
          f"max |paged - dense logit| {dmax}; median step dense "
          f"{out['teacher_forced']['dense_ms_per_step']:.3f} ms, paged "
          f"{out['teacher_forced']['paged_ms_per_step']:.3f} ms")
    del cache, pools

    rng = np.random.default_rng(SEED + 1)
    reqs = paged_requests(cfg.vocab, rng)
    reg = Registry()
    srv = S.DecodeServer(params, cfg, n_slots=8, max_len=640, round_len=32,
                         paged=True, page_size=ps, prefill_budget=256,
                         metrics=reg)
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    for p, m, _ in reqs:
        srv.submit(p, m)
    outs = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for fn in (kd.paged_flash_decode, kd.write_kv_page_row,
               kd.write_kv_page_block):
        check(launches[fn.__name__] > 0,
              f"{fn.__name__} was not launched by the paged server")
    for name, nl in launches.items():
        if name not in ("paged_flash_decode", "write_kv_page_row",
                        "write_kv_page_block"):
            check(nl == 0, f"{name} was launched {nl} times by the paged "
                           f"server (it runs only K9-K11)")
    check([len(o) for o in outs] == [m for _, m, _ in reqs],
          "the paged server returned the wrong number of tokens")
    check(srv.allocator.pages_in_use == srv.trie.entries,
          f"page leak: {srv.allocator.pages_in_use} pages in use, "
          f"{srv.trie.entries} held by the trie")
    check(all(not bool(t[0].any()) for e in srv.pools for t in e.values()),
          "the null page was written")
    st = srv.stats()
    c = st["counters"]
    check(c.get("serve.cow_copies", 0) >= 1, "no copy-on-write was taken")
    check(c.get("serve.prefix_hits", 0) > 0, "no prefix hit was taken")
    # the oracle: each request alone through the same paged prefill
    # chunks and paged decode (K9 attends prefill chunks with p rounded to
    # bf16 before P.V, where generate's prefill through K2 keeps it f32)
    compared = []
    for i, (want, g) in enumerate(paged_reference(params, cfg, reqs, ps, 8)):
        upto, done = compare_until_near_tie(outs[i], want, g)
        compared.append(done)
        if not done:
            print(f"[paged] request {i} ({reqs[i][2]}): tokens part from "
                  f"the paged reference at position {upto} of {reqs[i][1]}, "
                  f"a near-tie (scaled top-2 gap {g[upto]:.4g})")
    full = sum(compared)
    check(full >= 24, f"only {full} of 32 paged requests compared to the "
                      f"end")
    # and against each prompt's own dense generate: every parting at a
    # near-tie
    gen_full = 0
    for i, (p, m, _) in enumerate(reqs):
        want, g = greedy_with_gaps(
            params, torch.as_tensor(p[None].astype(np.int32), device=dev),
            cfg, m)
        gen_full += compare_until_near_tie(outs[i], want[0], g[0])[1]
    ntok = sum(len(o) for o in outs)
    hs = st["histograms"]
    summary = {k: {q: hs[k][q] for q in ("count", "mean", "p50", "p99")}
               for k in ("serve.ttft_usec", "serve.e2e_usec",
                         "serve.tok_usec")}
    counters = {k: c.get(f"serve.{k}", 0)
                for k in ("prefix_hits", "prefix_tokens_shared", "cow_copies",
                          "prefill_chunks", "admission_stalls",
                          "trie_evictions")}
    print(f"[paged] DecodeServer(paged, n_slots=8, max_len=640, round_len=32,"
          f" page_size=128, prefill_budget=256): 32 requests (16 sharing a "
          f"{PAGED_PREFIX}-token prefix, 4 exact duplicates, 12 unrelated), "
          f"{ntok} tokens in {wall:.2f} s ({ntok / wall:.0f} tok/s), "
          f"{srv.rounds_run} rounds / {srv.steps_run} steps, peak device "
          f"memory {peak:.2f} GiB; {json.dumps(counters)}; launches "
          f"{json.dumps(launches)}; tokens equal each request's own paged "
          f"reference, {full} of 32 to the end and the rest up to a parting "
          f"at a near-tie; against each prompt's own dense generate {gen_full}"
          f" of 32 to the end, every parting at a near-tie")
    print(f"[paged] stats: {json.dumps(summary)}; pages "
          f"{json.dumps(st['pages'])}")
    out["server"] = dict(requests=32, tokens=ntok, wall_s=wall,
                         tok_per_s=ntok / wall, rounds=srv.rounds_run,
                         steps=srv.steps_run, compared_to_end=full,
                         generate_compared_to_end=gen_full, peak_gib=peak, counters=counters, stats=summary,
                         pages=st["pages"])
    return out, launches


# ---------------------------------------------------------------------------
# Phase 7: K3, K4 and K5 against their plain versions
# ---------------------------------------------------------------------------

def _bwd_bound(which: int, h, lq, lk, d, esize, pairs):
    """(bound ms, bound_by) of K3/K4/K5 on one folded block: the bytes it
    must move (q, k and for K4/K5 v in the input dtype, f32 do' and rows,
    int32 positions read once; f32 outputs written once) over the HBM
    rate, against its products (1, 3 or 4 of 2*d FLOPs per unmasked
    pair of this run's positions) over the bf16 dense peak."""
    pos = (lq + lk) * 4
    if which == 3:
        nbytes = (h * lq * d + h * lk * d) * esize + 2 * h * lq * 4 + pos
        flops = 2 * d * pairs
    else:
        nbytes = ((h * lq * d + 2 * h * lk * d) * esize + h * lq * d * 4
                  + 3 * h * lq * 4 + pos)
        nbytes += h * lq * d * 4 if which == 4 else 2 * h * lk * d * 4
        flops = (3 if which == 4 else 4) * 2 * d * pairs
    bound_b = nbytes / PEAK_HBM_BYTES_S * 1e3
    bound_f = flops / PEAK_BF16_FLOPS * 1e3
    return max(bound_b, bound_f), ("bytes" if bound_b >= bound_f
                                   else "operations")


def phase_k345(dev) -> dict:
    """K3 (tie counts), K4 (dq) and K5 (dk, dv) against their plain
    versions at the training path's shapes: 64 folded heads x 1024 x 64
    bf16 causal, the same non-causal and in f32; GQA group 4 through the
    host fold (the GQA+RoPE config's 32 query / 8 K/V heads at L 128);
    ragged Lq/Lk; the ring step (a second, fully masked block after a
    first, and fully masked rows from the initial state); and structural
    ties (duplicated keys, a zero q row, m preset to the row max) on
    scores that are exact in f32. Each side takes its own forward's m'
    (K2's for the kernels, the plain forward's for the plain versions):
    K3's counts must equal the plain counts exactly, and be >= 1 on every
    row that starts from the initial state (K3's recomputed scores tie
    K2's m'). K4 and K5 get the same operands as their plain versions but
    that m' too (the routed term lands where a side's own recomputed
    score ties its own m': bf16 scores come from the tensor cores in the
    kernels and from cuBLAS in the plain versions, whose last bits differ)
    and must agree within rtol 1e-4 and atol 1e-4 per unit of the largest
    |value|: f32 sums of up to 1024 products in another order."""
    import torch
    import torch.nn.functional as F
    from rlo_tpu_torch.kernels import flash as kf

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    scale, d = 0.125, 64
    h, n = BWD_SHAPE

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def block(h, lq, lk, dtype, *, carried=False, groups=1, kp_off=0,
              exact=False):
        """Folded operands: h heads, groups query groups of lq rows."""
        q, k, v = rand(h, groups * lq, d), rand(h, lk, d), rand(h, lk, d)
        if exact:  # multiples of 1/8: every score exact, ties structural
            q, k = (torch.round(t * 4) / 8 for t in (q, k))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        n = groups * lq
        if carried:
            m, l, o = rand(h, 1, n), rand(h, 1, n).abs() + 0.5, rand(h, n, d)
        else:
            m = torch.full((h, 1, n), kf.NEG, device=dev)
            l, o = torch.zeros(h, 1, n, device=dev), torch.zeros(h, n, d,
                                                                 device=dev)
        qp = torch.arange(lk - lq, lk, dtype=torch.int32,
                          device=dev).repeat(groups).reshape(1, n)
        kp = (torch.arange(lk, dtype=torch.int32, device=dev)
              + kp_off).reshape(1, lk)
        return [q, k, v, m, l, o, qp, kp]

    cases = [("path", block(h, n, n, torch.bfloat16), True),
             ("non-causal", block(h, n, n, torch.bfloat16), False),
             ("f32", block(h, n, n, torch.float32), True),
             ("GQA group 4", block(8, 128, 128, torch.bfloat16, groups=4),
              True),
             ("ragged", block(h, n - 24, n - 24, torch.bfloat16), True),
             ("ragged 129x77", block(16, 129, 77, torch.float32,
                                     carried=True), True),
             ("fully masked rows", block(h, n, n, torch.bfloat16,
                                         kp_off=n), True)]
    # the ring step: a second block, all of it past every query, carried
    # from a first
    first = block(h, n, n, torch.bfloat16)
    with torch.no_grad():
        carried = kf.flash_block_update_hld(*first, causal=True, scale=scale)
    ring = block(h, n, n, torch.bfloat16, kp_off=n)
    ring[0], ring[3:6] = first[0], list(carried)
    cases.append(("ring step", ring, True))
    # structural ties: duplicated keys, a zero q row, m = the row max
    ties = block(8, 256, 256, torch.float32, exact=True)
    ties[1][:, 200] = ties[1][:, 100]
    ties[0][:, 7] = 0.0
    mx = kf.flash_block_update_hld_plain(*ties, causal=True,
                                         scale=scale)[0]
    ties[3] = torch.where(torch.arange(256, device=dev) % 3 == 0, mx,
                          ties[3])
    cases.append(("structural ties", ties, True))
    cases.append(("structural ties, non-causal", ties, False))

    worst = {3: 0.0, 4: 0.0, 5: 0.0}
    ties_seen = 0
    for name, (q, k, v, m, l, o, qp, kp), causal in cases:
        kw = dict(causal=causal, scale=scale)
        with torch.no_grad():
            m2k = kf.flash_block_update_hld(q, k, v, m, l, o, qp, kp, **kw)[0]
            m2p = kf.flash_block_update_hld_plain(q, k, v, m, l, o, qp, kp,
                                                  **kw)[0]
        cnt = kf.rowstats(q, k, m2k, qp, kp, **kw)
        cnt_p = kf.rowstats_plain(q, k, m2p, qp, kp, **kw)
        hq, nq = q.shape[0], q.shape[1]
        dl2, do2, route = rand(hq, 1, nq), rand(hq, nq, d), rand(hq, 1, nq)
        ops = (q, k, v, m2k, dl2, do2, route, qp, kp)
        pops = (q, k, v, m2p, dl2, do2, route, qp, kp)
        dq, (dk, dv) = kf.bwd_dq(*ops, **kw), kf.bwd_dkv(*ops, **kw)
        pdq, (pdk, pdv) = kf.bwd_dq_plain(*pops, **kw), \
            kf.bwd_dkv_plain(*pops, **kw)
        torch.cuda.synchronize()
        check(torch.equal(cnt, cnt_p), f"K3 counts differ from the plain "
                                       f"counts ({name})")
        if bool((m == kf.NEG).all()):
            check(bool((cnt >= 1).all()), f"K3 found no tie with K2's m' on "
                                          f"some row ({name})")
        ties_seen += int((cnt > 1).sum())
        worst[3] = max(worst[3], abs_err(cnt, cnt_p))
        for what, g, w, key in (("dq", dq, pdq, 4), ("dk", dk, pdk, 5),
                                ("dv", dv, pdv, 5)):
            check(bool(torch.isfinite(g).all()) and _close(g, w, 1e-4, 1e-4),
                  f"K{key} {what} differs from its plain version ({name})")
            worst[key] = max(worst[key], abs_err(g, w))
    check(ties_seen > 0, "no row with several tied positions was exercised")
    print(f"[k3-k5] {len(cases)} cases ({h} folded heads x {n} x 64 "
          f"bf16/f32, causal and not, GQA group 4, ragged, the ring step, "
          f"fully masked rows, structural ties: {ties_seen} rows with "
          f"several tied positions): K3 counts equal the plain counts "
          f"exactly; K4/K5 within rtol 1e-4 of the plain versions; max "
          f"|err| K4 {worst[4]:.3g}, K5 {worst[5]:.3g}")

    # every bf16 head dim: K3 recomputes K2's tensor-core scores, so each
    # row from the initial state ties K2's m'; K4/K5 (every product on the
    # tensor cores) against their plain versions, each side on its own m'
    n_dims = 0
    for dd in (16, 32, 128):
        for lq, lk in ((33, 7), (129, 77), (256, 256)):
            q, k, v = (torch.randn(8, ll, dd, generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for ll in (lq, lk, lk))
            m = torch.full((8, 1, lq), kf.NEG, device=dev)
            state = (m, torch.zeros_like(m), torch.zeros(8, lq, dd,
                                                         device=dev))
            qp = torch.arange(lk - lq, lk, dtype=torch.int32,
                              device=dev).reshape(1, lq)
            kp = torch.arange(lk, dtype=torch.int32, device=dev).reshape(1,
                                                                         lk)
            dl2, do2, route = rand(8, 1, lq), rand(8, lq, dd), rand(8, 1, lq)
            for causal in (True, False):
                kw = dict(causal=causal, scale=scale)
                with torch.no_grad():
                    m2 = kf.flash_block_update_hld(q, k, v, *state, qp, kp,
                                                   **kw)[0]
                    m2p = kf.flash_block_update_hld_plain(q, k, v, *state,
                                                          qp, kp, **kw)[0]
                cnt = kf.rowstats(q, k, m2, qp, kp, **kw)
                check(bool((cnt >= 1).all()),
                      f"K3 found no tie with K2's m' on some row (bf16, "
                      f"D={dd}, {lq} x {lk}, causal={causal})")
                ops = (q, k, v, m2, dl2, do2, route, qp, kp)
                pops = (q, k, v, m2p, dl2, do2, route, qp, kp)
                got = (kf.bwd_dq(*ops, **kw), *kf.bwd_dkv(*ops, **kw))
                want = (kf.bwd_dq_plain(*pops, **kw),
                        *kf.bwd_dkv_plain(*pops, **kw))
                torch.cuda.synchronize()
                for what, g, w, key in zip(("dq", "dk", "dv"), got, want,
                                           (4, 5, 5)):
                    check(bool(torch.isfinite(g).all()) and
                          _close(g, w, 1e-4, 1e-4),
                          f"K{key} {what} differs from its plain version "
                          f"(bf16, D={dd}, {lq} x {lk}, causal={causal})")
                    worst[key] = max(worst[key], abs_err(g, w))
                n_dims += 1
    print(f"[k3-k5] bf16 at D 16/32/128 (33 x 7, 129 x 77, 256 x 256, "
          f"causal and not; {n_dims} cases): K3 ties K2's m' on every row; "
          f"K4/K5 within rtol 1e-4 of the plain versions; max |err| K4 "
          f"{worst[4]:.3g}, K5 {worst[5]:.3g}")

    # no atomics: two launches give the same bits; views (a transposed
    # q, k and v one bf16 element into their storage, a misaligned do')
    # give the bits of their contiguous copies
    q, k, v, m, l, o, qp, kp = cases[0][1]
    kw = dict(causal=True, scale=scale)
    with torch.no_grad():
        m2 = kf.flash_block_update_hld(q, k, v, m, l, o, qp, kp, **kw)[0]
    dl2, do2, route = rand(h, 1, n), rand(h, n, d), rand(h, 1, n)

    def k345(q, k, v, do2):
        return (kf.rowstats(q, k, m2, qp, kp, **kw),
                kf.bwd_dq(q, k, v, m2, dl2, do2, route, qp, kp, **kw),
                *kf.bwd_dkv(q, k, v, m2, dl2, do2, route, qp, kp, **kw))

    # (a race between a block's warps shows as a rare launch that differs,
    # so the check repeats the launches REPEATS times)
    names = ("K3", "K4 dq", "K5 dk", "K5 dv")
    first = k345(q, k, v, do2)
    differ = dict.fromkeys(names, 0)
    for _ in range(REPEATS):
        for name, a, b in zip(names, first, k345(q, k, v, do2)):
            differ[name] += not same_bits(a, b)
    viewed = k345(_transposed(q), _offset(k), _offset(v), _offset(do2))
    torch.cuda.synchronize()
    print(f"[k3-k5] causal {h} heads x {n} x 64 bf16: launches differing "
          f"from the first in {REPEATS} repeats {json.dumps(differ)}")
    check(not any(differ.values()), "repeat launches of K3-K5 differ")
    for name, a, c in zip(names, first, viewed):
        check(same_bits(a, c), f"{name}: views differ from their "
                               f"contiguous copies")
    print(f"[k3-k5] causal {h} heads x {n} x 64 bf16: {REPEATS} repeat "
          f"launches of K3-K5 give the same bits; views (transposed q, "
          f"misaligned k, v, do') the bits of their contiguous copies")

    # times at the path's shape: causal 64 x 1024 x 64 bf16 (the fast
    # mode's zero route)
    ops = (q, k, v, m2, dl2, do2, torch.zeros(h, 1, n, device=dev), qp, kp)
    q4, k4, v4 = (t.unsqueeze(0).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                         scale=scale)
    dout = torch.randn(out.shape, generator=gen, device=dev,
                       dtype=out.dtype)
    def sdpa_bwd():
        return torch.autograd.grad(out, (q4, k4, v4), dout, retain_graph=True)
    # the library's device time: timed by events in runs of 10, the call
    # is bound by the host (autograd's engine), not by its kernels
    lib = device_ms(sdpa_bwd)
    lib_events = time_ms(sdpa_bwd, iters=10, per=10)
    pairs = h * int((kp[0][None, :] <= qp[0][:, None]).sum())
    stats = {}
    for which, kern, plain, library in (
            (3, lambda: kf.rowstats(q, k, m2, qp, kp, **kw),
             lambda: kf.rowstats_plain(q, k, m2, qp, kp, **kw), None),
            (4, lambda: kf.bwd_dq(*ops, **kw),
             lambda: kf.bwd_dq_plain(*ops, **kw), lib),
            (5, lambda: kf.bwd_dkv(*ops, **kw),
             lambda: kf.bwd_dkv_plain(*ops, **kw), lib)):
        ms = time_ms(kern, iters=10, per=10)
        plain_ms = time_ms(plain, iters=5)
        bound, by = _bwd_bound(which, h, n, n, d, 2, pairs)
        stats[f"K{which}"] = dict(ms=ms, plain_ms=plain_ms,
                                  library_ms=library, bound_ms=bound,
                                  bound_by=by, max_abs_err=worst[which])
        print(f"[k3-k5] K{which} causal {h} heads x {n} x 64 bf16: kernel "
              f"{ms:.4f} ms a launch in runs of 10, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms "
              f"({by}), kernel at {100 * bound / ms:.1f}% of bound")
    k45 = stats['K4']['ms'] + stats['K5']['ms']
    print(f"[k3-k5] scaled_dot_product_attention backward at the same "
          f"shape (the yardstick of K4+K5, {k45:.4f} ms): device {lib:.4f} "
          f"ms by the profiler ({k45 / lib:.2f}x), {lib_events:.4f} ms a "
          f"call in runs of 10 by CUDA events (host time included)")
    return stats


# ---------------------------------------------------------------------------
# Phase 8: the VJP in its three modes
# ---------------------------------------------------------------------------

#: the bf16 grads of phase 8 (of bf16 q, k and v)
BF16_GRADS = ("dq", "dk", "dv", "dk1", "dv1", "dk2", "dv2")


def _grads_close(got, want, names, what) -> float:
    """bf16 grads within two bf16 units in the last place (rtol 2^-7)
    and atol 1e-3 per unit of the largest |value|: both sides round an
    f32 sum to bf16, and a last-bit difference in f32 may round to the
    other neighbour; f32 grads within rtol 1e-4 / atol 1e-4 per unit.
    Returns the max |err|."""
    import torch
    worst = 0.0
    for g, w, name in zip(got, want, names):
        g, w = g.float(), w.float()
        tol = (2 ** -7, 1e-3) if name in BF16_GRADS else (1e-4, 1e-4)
        check(bool(torch.isfinite(g).all()) and _close(g, w, *tol),
              f"{what}: {name} differs from the xla mode")
        worst = max(worst, abs_err(g, w))
    return worst


def phase_vjp(dev) -> dict:
    """``FlashBlockUpdate`` in its three backward modes at 64 folded
    heads x 1024 x 64 bf16, causal: one block update from a carried
    state, under a loss on raw (m', l', o') ('pallas' against 'xla') and
    under the normalised o'/l' (all three; 'pallas_fast' is exact only
    there), and a chain of two updates whose second block is fully
    masked (the ring step), normalised. (m', l', o') are the same bits in
    every mode (K2 runs the forward of all three). The exact-mode chain
    is K3's path (the training step runs 'pallas_fast' and no K3): its
    K3 launches are counted from 0 around that chain alone."""
    import torch
    from rlo_tpu_torch.kernels import flash as kf

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    (h, n), d, scale = BWD_SHAPE, 64, 0.125

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q, k1, v1, k2, v2 = (rand(h, n, d).to(torch.bfloat16) for _ in range(5))
    m, l, o = rand(h, 1, n), rand(h, 1, n).abs() + 0.5, rand(h, n, d)
    qp = torch.arange(n, dtype=torch.int32, device=dev).reshape(1, n)
    w = torch.cos(torch.arange(h * n * d, device=dev).reshape(h, n, d)
                  * 0.01)

    def normed(o2, l2):
        return ((o2 / l2.transpose(1, 2)) * w).sum()

    def single(mode, raw):
        ts = [t.detach().clone().requires_grad_(True)
              for t in (q, k1, v1, m, l, o)]
        m2, l2, o2 = kf.flash_block_update_hld(*ts, qp, qp, causal=True,
                                               scale=scale, bwd=mode)
        loss = ((o2 * w).sum() + torch.sin(l2).sum() + (m2 * 0.3).sum()) \
            if raw else normed(o2, l2)
        return (m2.detach(), l2.detach(), o2.detach()), \
            torch.autograd.grad(loss, ts)

    def chain(mode):
        ts = [t.detach().clone().requires_grad_(True)
              for t in (q, k1, v1, k2, v2)]
        st = (torch.full((h, 1, n), kf.NEG, device=dev),
              torch.zeros(h, 1, n, device=dev),
              torch.zeros(h, n, d, device=dev))
        st = kf.flash_block_update_hld(ts[0], ts[1], ts[2], *st, qp, qp,
                                       causal=True, scale=scale, bwd=mode)
        st = kf.flash_block_update_hld(ts[0], ts[3], ts[4], *st, qp,
                                       qp + n, causal=True, scale=scale,
                                       bwd=mode)
        return torch.autograd.grad(normed(st[2], st[1]), ts)

    names6 = ("dq", "dk", "dv", "dm", "dl", "do")
    worst = 0.0
    vals_x, raw_x = single("xla", True)
    vals_p, raw_p = single("pallas", True)
    worst = max(worst, _grads_close(raw_p, raw_x, names6,
                                    "pallas, raw cotangents"))
    _, norm_x = single("xla", False)
    for mode in ("pallas", "pallas_fast"):
        vals, g = single(mode, False)
        for a, b in zip(vals, vals_x):
            check(same_bits(a, b), f"(m', l', o') of {mode} differ from "
                                   f"the xla mode's")
        worst = max(worst, _grads_close(g, norm_x, names6,
                                        f"{mode}, normalised"))
    for a, b in zip(vals_p, vals_x):
        check(same_bits(a, b), "(m', l', o') of pallas differ")
    chain_x = chain("xla")
    names5 = ("dq", "dk1", "dv1", "dk2", "dv2")
    # K3's path: the exact-mode chained block update (the ring
    # composition), counted in a window of its own
    kf.rowstats.launches = 0
    chain_p = chain("pallas")
    k3_launches = kf.rowstats.launches
    check(k3_launches > 0, "rowstats was not launched on the exact-mode "
                           "chained block update")
    for mode, g in (("pallas", chain_p),
                    ("pallas_fast", chain("pallas_fast"))):
        worst = max(worst, _grads_close(g, chain_x, names5,
                                        f"{mode}, chain of two"))
    torch.cuda.synchronize()
    print(f"[vjp] {h} heads x {n} x 64 bf16 causal: 'pallas' and "
          f"'pallas_fast' against 'xla' on one update (raw and normalised "
          f"cotangents) and a chain of two (ring step): values bit-identical "
          f"across modes, grads within 2 bf16 ulps (dq/dk/dv) or rtol 1e-4 "
          f"(dm/dl/do); max |err| {worst:.3g}; K3 launches on the "
          f"exact-mode chain {k3_launches}")
    return {"max_abs_err": worst, "k3_launches": k3_launches}


# ---------------------------------------------------------------------------
# Phase 9: the training step at full width; phase 10: the dp combine
# ---------------------------------------------------------------------------

#: the flagship training batch (benchmarks/train_bench.py:65-67)
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
#: (folded heads, length) of phases 7 and 8: the training path's
#: attention (batch 4 x 16 heads, L 1024)
BWD_SHAPE = (64, 1024)
#: phase 7's repeat launches of K3-K5, each held bit-equal to the first
REPEATS = 100
#: per-tensor relative L2 error of the kernel path's grads against the
#: same step with the attention backward in 'xla' mode: dq/dk/dv leave
#: each layer's attention in bf16 on both sides, rounded from f32 sums
#: taken in another order, so a last-bit difference can move one bf16
#: unit (2^-8) and spread through the backward of the layers below
GRAD_REL_LIMIT = 1e-2
#: ... of the 2-rank dp combine against the single-process batch-4
#: grads: each rank's GEMMs have half the rows, so cuBLAS may sum in
#: another order and bf16 activations round differently
DP_REL_LIMIT = 2e-2
#: runs of the step with and without remat held bit-equal to the first
REMAT_REPEATS = 3
SGD_LR, ADAM_LR = 0.05, 3e-4


@contextlib.contextmanager
def _attention_backward_xla():
    """For the duration, ``flash_attention`` (the model's attention)
    hands its block update the 'xla' backward (autograd through K2's
    plain version) in place of 'pallas_fast': the model's own fold and
    K2 forward, the oracle backward. K2's launch count carries over."""
    from rlo_tpu_torch.kernels import flash as kf
    orig = kf.flash_block_update_hld

    def xla(*args, **kw):
        return orig(*args, **dict(kw, bwd="xla"))

    xla.launches = orig.launches
    kf.flash_block_update_hld = xla
    try:
        yield
    finally:
        kf.flash_block_update_hld = orig
        orig.launches = xla.launches


def _rel_l2(got, want) -> list:
    from rlo_tpu_torch.models.transformer import tree_leaves
    out = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        den = float(w.double().norm())
        out.append(float((g.double() - w.double()).norm()) / max(den,
                                                                   1e-30))
    return out


def phase_train(dev, flash_fns) -> dict:
    """The flagship training step at full width (vocab 32768, d 1024, 16
    heads, 8 layers, d_ff 4096, bf16, f32 params; batch 4 x 1024, one
    batch from the seed): the kernel path's loss and grads (K2 forward,
    K4/K5 backward through ``flash_attention``'s 'pallas_fast') against
    the same step with the attention backward in 'xla' mode (losses
    equal, grads within GRAD_REL_LIMIT per tensor); REMAT_REPEATS runs
    each with ``remat=True`` and ``remat=False`` against the first (loss
    and grads bit-identical); 10 SGD steps and 10 ``torch.optim.Adam``
    steps (loss finite at every step, lower after than before); the
    median step time, tokens/s, model FLOPs per token
    (benchmarks/train_bench.py:40-42) and their share of the bf16 dense
    peak, peak device memory and launches per step."""
    import dataclasses
    import torch
    from rlo_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(**SERVE_CFG)
    params = tt.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tt.tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()

    loss_k, grads_k = tt.grads_and_loss(params, tokens, cfg)
    with _attention_backward_xla():
        loss_x, grads_x = tt.grads_and_loss(params, tokens, cfg)
    check(bool(torch.isfinite(loss_k)) and torch.equal(loss_k, loss_x),
          f"the kernel path's loss {float(loss_k)} != the xla mode's "
          f"{float(loss_x)}")
    rel = _rel_l2(grads_k, grads_x)
    check(all(torch.isfinite(g).all() for g in tt.tree_leaves(grads_k)),
          "non-finite grads on the kernel path")
    check(max(rel) <= GRAD_REL_LIMIT,
          f"kernel-path grads differ from the xla mode's: max relative L2 "
          f"{max(rel):.3g} > {GRAD_REL_LIMIT}")
    del grads_x
    print(f"[train] {n_params} params, batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"loss {float(loss_k):.6f} equal with the attention backward in "
          f"xla mode; per-tensor relative L2 error of the grads max "
          f"{max(rel):.3g}, median {statistics.median(rel):.3g} (limit "
          f"{GRAD_REL_LIMIT})")

    # remat, and the step run again without it, each REMAT_REPEATS times
    # (a rare race in a kernel shows as one run that parts)
    diffs, parted = [0.0], {False: 0, True: 0}
    for remat in (True, False) * REMAT_REPEATS:
        loss_r, grads_r = tt.grads_and_loss(
            params, tokens, dataclasses.replace(cfg, remat=remat))
        diffs += [float((loss_r - loss_k).abs())] + [
            float((a - b).abs().max()) for a, b in
            zip(tt.tree_leaves(grads_r), tt.tree_leaves(grads_k))]
        parted[remat] += not (torch.equal(loss_r, loss_k) and all(
            torch.equal(a, b) for a, b in zip(tt.tree_leaves(grads_r),
                                              tt.tree_leaves(grads_k))))
        del grads_r
    print(f"[train] {REMAT_REPEATS} runs each of remat=True and of "
          f"remat=False against the first step: {parted[True]} and "
          f"{parted[False]} parted; loss and grads max |delta| {max(diffs)}")
    check(not parted[True], "remat changed the loss or the grads")
    check(not parted[False], "the step's loss or grads changed between runs")

    walls, sgd = [], []
    p = params
    before = {fn.__name__: fn.launches for fn in flash_fns}
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, loss = tt.train_step(p, tokens, cfg, lr=SGD_LR)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        sgd.append(float(loss))
    step_counts = {fn.__name__: (fn.launches - before[fn.__name__]) / 10
                   for fn in flash_fns}
    del p
    check(all(map(math.isfinite, sgd)) and sgd[-1] < sgd[0],
          f"SGD losses not finite and falling: {sgd}")
    step_ms = statistics.median(walls[1:])
    p = tt.init_params(cfg, seed=SEED, device=dev)
    adam = torch.optim.Adam(tt.tree_leaves(p), lr=ADAM_LR)
    adam_l = []
    for _ in range(10):
        p, loss = tt.train_step_optim(p, adam, tokens, cfg)
        adam_l.append(float(loss))
    del p, adam
    check(all(map(math.isfinite, adam_l)) and adam_l[-1] < adam_l[0],
          f"Adam losses not finite and falling: {adam_l}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    tok_s = n_tok / step_ms * 1e3
    fpt = 6.0 * n_params + 12.0 * cfg.n_layers * cfg.d_model \
        * TRAIN_SEQ * 0.5
    share = fpt * tok_s / PEAK_BF16_FLOPS
    name = torch.cuda.get_device_name(0)
    print(f"[train] 10 SGD steps (lr {SGD_LR}): "
          f"{' '.join(f'{x:.4f}' for x in sgd)}")
    print(f"[train] 10 Adam steps (lr {ADAM_LR}): "
          f"{' '.join(f'{x:.4f}' for x in adam_l)}")
    print(f"[train] median SGD step {step_ms:.3f} ms ({tok_s:.0f} tokens/s); "
          f"{fpt:.4g} model FLOPs per token, {100 * share:.2f}% of the "
          f"{name}'s 989 TFLOP/s bf16 dense peak; peak device memory "
          f"{peak:.2f} GiB; launches per step {json.dumps(step_counts)}")
    return {"params": params, "tokens": tokens, "cfg": cfg, "loss": loss_k,
            "grads": grads_k,
            "stats": {"n_params": n_params, "loss": float(loss_k),
                      "grad_rel_l2_max": max(rel),
                      "remat_max_abs_delta": max(diffs),
                      "sgd_losses": sgd, "adam_losses": adam_l,
                      "step_ms_median": step_ms, "tokens_per_s": tok_s,
                      "flops_per_token": fpt, "peak_share": share,
                      "peak_mem_gib": peak,
                      "launches_per_step": step_counts}}


def phase_dp(dev, train) -> dict:
    """The explicit dp combine: a 2-rank ``LocalMesh`` on the card, each
    rank ``grads_and_loss`` on half the batch (2 x 1024) with
    ``dp_axis``, ``grad_algorithm='ring'`` (K1 per step). Both ranks'
    combined grads are the same bits, and equal the single-process
    batch-4 grads within DP_REL_LIMIT per tensor; the averaged loss
    within rtol 1e-3."""
    import torch
    from rlo_tpu_torch.kernels import reduce as k1
    from rlo_tpu_torch.models import transformer as tt
    from rlo_tpu_torch.parallel.mesh import LocalMesh

    params, tokens, cfg = train["params"], train["tokens"], train["cfg"]
    mesh = LocalMesh((2,), ("dp",), device=dev)
    before = k1.fused_combine.launches
    t0 = time.perf_counter()
    outs = mesh.run(lambda axes, t: tt.grads_and_loss(
        params, t, cfg, dp_axis=axes["dp"], grad_algorithm="ring"),
        [tokens[:2], tokens[2:]])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    k1_n = k1.fused_combine.launches - before
    (l0, g0), (l1, g1) = outs
    check(torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(
        tt.tree_leaves(g0), tt.tree_leaves(g1))),
        "the two dp ranks hold different combined grads")
    rel = _rel_l2(g0, train["grads"])
    lrel = abs(float(l0) - float(train["loss"])) / abs(float(train["loss"]))
    check(k1_n > 0, "K1 did not run in the dp ring combine")
    check(max(rel) <= DP_REL_LIMIT and lrel <= 1e-3,
          f"dp combine differs from the single-process step: max relative "
          f"L2 {max(rel):.3g} (limit {DP_REL_LIMIT}), loss rel {lrel:.3g}")
    print(f"[dp] 2 ranks x (2 x 1024) on one card, ring combine ({k1_n} K1 "
          f"launches) in {ms:.1f} ms: grads equal the batch-4 step within "
          f"max relative L2 {max(rel):.3g} (limit {DP_REL_LIMIT}), loss "
          f"{float(l0):.6f} vs {float(train['loss']):.6f}")
    return {"ms": ms, "k1_launches": k1_n, "grad_rel_l2_max": max(rel),
            "loss_rel": lrel}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def pin_one_card() -> None:
    """Run on one card: with several visible, keep the first (before
    CUDA starts), so the device count the last line reports is the
    count this run used."""
    import os
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    elif "," in visible:
        os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]


def build_all() -> None:
    """Build every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from rlo_tpu_torch.kernels import build
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for f in [pool.submit(build.load, n) for n in KERNEL_SOURCES]:
            f.result()


def check_tensor_cores() -> None:
    """K2-K5's bf16 instantiations run on the tensor cores and their f32
    ones on the CUDA cores: count HMMA instructions per kernel in the
    SASS of the built flash library (``cuobjdump`` beside ``nvcc``). K4
    and K5 run every product there, K3 only its scores: each bf16 K4/K5
    must hold more HMMA than K3 at the same head dim."""
    import re
    from pathlib import Path
    from rlo_tpu_torch.kernels import build
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass",
                           str(build._lib_path("flash"))], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    hmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            hmma[fn] = 0
        elif fn and "HMMA" in line:
            hmma[fn] += 1
    kinds = {"K2": "flash_fwd_", "K3": "flash_rowstats_kernel",
             "K4": "flash_bwd_dq_", "K5": "flash_bwd_dkv_"}
    seen = {}
    for fn, n in hmma.items():
        for k, frag in kinds.items():
            if frag in fn:
                bf16 = "mma_kernel" in fn or "__nv_bfloat16" in fn
                check((n > 0) == bf16,
                      f"{k} {'bf16' if bf16 else 'f32'} instantiation {fn} "
                      f"has {n} HMMA instructions")
                d = int(re.search(r"Li(\d+)E", fn).group(1))
                seen.setdefault((k, bf16), {})[d] = n
    check(len(seen) == 8 and all(sorted(v) == [16, 32, 64, 128]
                                 for v in seen.values()),
          f"expected K2-K5 x bf16/f32 x 4 head dims in the SASS: {seen}")
    for k in ("K4", "K5"):
        for d, n in seen[(k, True)].items():
            check(n > seen[("K3", True)][d],
                  f"bf16 {k} at D={d} has {n} HMMA, not more than K3's "
                  f"{seen[('K3', True)][d]}: its products are not on the "
                  f"tensor cores")
    print("[build] SASS HMMA counts (head dims 16/32/64/128): " + "; ".join(
        f"{k} {'bf16' if b else 'f32'} {[v[d] for d in sorted(v)]}"
        for (k, b), v in sorted(seen.items())))


def kernel_entry(name, source, replaces, launches, st, path) -> dict:
    """One kernel of the ``kernels`` line; ``path`` names the run whose
    launches it counts."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st["library_ms"]}


def main() -> int:
    pin_one_card()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.kernels import flash as k2
    from rlo_tpu_torch.kernels import reduce as k1

    t_start = time.perf_counter()
    # bf16 products accumulate in f32, as on the TPU: no bf16 reductions
    # between split-K partial sums (they make a row's result depend on
    # the batch's shape)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = torch.device("cuda", torch.cuda.current_device())
    print(card_line())
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    check(torch.cuda.device_count() == 1, "more than one card visible")
    t0 = time.perf_counter()
    build_all()
    print(f"[build] csrc/{{reduce,flash,decode}}.cu built with nvcc (in "
          f"parallel) and loaded in {time.perf_counter() - t0:.1f} s")
    check_tensor_cores()

    k1_stats = phase_k1(dev, N_FULL)

    torch.cuda.reset_peak_memory_stats()
    k1.fused_combine.launches = 0
    t0 = time.perf_counter()
    facade = phase_facade(dev, N_FULL)
    launches = k1.fused_combine.launches
    print(f"[facade] main path took {time.perf_counter() - t0:.1f} s, "
          f"K1 launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(launches > 0, "K1 was not launched on the main path")
    torch.cuda.empty_cache()

    k2_stats = phase_k2(dev)
    k6_stats = phase_k6(dev)
    w_stats = phase_writes(dev)
    k9_stats = phase_k9(dev)
    pw_stats = phase_page_writes(dev)
    torch.cuda.empty_cache()

    counted = (k2.flash_block_update_hld, kd.flash_block_decode,
               kd.write_kv_row, kd.write_kv_block, kd.paged_flash_decode,
               kd.write_kv_page_row, kd.write_kv_page_block)
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    serving = phase_serving(dev)
    served = {fn.__name__: fn.launches for fn in counted}
    print(f"[serve] serving path took {time.perf_counter() - t0:.1f} s, "
          f"launches {served}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for fn in counted[:4]:
        check(served[fn.__name__] > 0,
              f"{fn.__name__} was not launched on the serving path")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    paged, paged_launches = phase_paged_serving(dev, counted)
    print(f"[paged] paged serving phase took {time.perf_counter() - t0:.1f} "
          f"s")
    torch.cuda.empty_cache()

    k345_stats = phase_k345(dev)
    torch.cuda.empty_cache()
    # the VJP modes; K3's launches are those of its exact-mode chain
    vjp = phase_vjp(dev)
    torch.cuda.empty_cache()
    # the training path: the full-width step and the dp combine
    trained = (k1.fused_combine, k2.flash_block_update_hld, k2.bwd_dq,
               k2.bwd_dkv)
    for fn in trained:
        fn.launches = 0
    t0 = time.perf_counter()
    train = phase_train(dev, (k2.flash_block_update_hld, k2.rowstats,
                              k2.bwd_dq, k2.bwd_dkv))
    dp = phase_dp(dev, train)
    train_launches = {fn.__name__: fn.launches for fn in trained}
    print(f"[train] training path (phases 9-10) took "
          f"{time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps(train_launches)}")
    for fn in trained:
        check(train_launches[fn.__name__] > 0,
              f"{fn.__name__} was not launched on the training path")
    del train["params"], train["grads"]
    torch.cuda.empty_cache()

    print(json.dumps({"k1_ring_chunk": k1_stats["ring_chunk"],
                      "facade_allreduce": facade, "serving": serving,
                      "paged_serving": paged,
                      "k9_int8": k9_stats["int8"], "vjp": vjp,
                      "training": train["stats"], "dp_combine": dp}))
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    # the path whose run counted each kernel's launches
    facade_p, serve_p = "facade (phase 3)", "dense serving (phase 5)"
    paged_p = "paged serving (phase 6)"
    chain_p = "exact-mode chained block update (phase 8)"
    train_p = "training step and dp combine (phases 9-10)"
    print(json.dumps({"kernels": [
        kernel_entry("K1 fused_combine", K1_SOURCE, K1_REPLACES, launches,
                     dict(k1_stats["256MB"],
                          max_abs_err=k1_stats["max_abs_err"]), facade_p),
        kernel_entry("K2 flash_block_update_hld", FLASH_SOURCE,
                     "rlo_tpu/pallas/flash.py:114",
                     served["flash_block_update_hld"], k2_stats["prefill"],
                     serve_p),
        kernel_entry("K6 flash_block_decode", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:70",
                     served["flash_block_decode"], k6_stats, serve_p),
        kernel_entry("K7 write_kv_row", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:141",
                     served["write_kv_row"], w_stats["K7"], serve_p),
        kernel_entry("K8 write_kv_block", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:168",
                     served["write_kv_block"], w_stats["K8"], serve_p),
        kernel_entry("K9 paged_flash_decode", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:466",
                     paged_launches["paged_flash_decode"], k9_stats["bf16"],
                     paged_p),
        kernel_entry("K10 write_kv_page_row", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:350",
                     paged_launches["write_kv_page_row"], pw_stats["K10"],
                     paged_p),
        kernel_entry("K11 write_kv_page_block", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:402",
                     paged_launches["write_kv_page_block"], pw_stats["K11"],
                     paged_p),
        kernel_entry("K3 rowstats", FLASH_SOURCE,
                     "rlo_tpu/pallas/flash.py:249", vjp["k3_launches"],
                     k345_stats["K3"], chain_p),
        kernel_entry("K4 bwd_dq", FLASH_SOURCE,
                     "rlo_tpu/pallas/flash.py:296",
                     train_launches["bwd_dq"], k345_stats["K4"], train_p),
        kernel_entry("K5 bwd_dkv", FLASH_SOURCE,
                     "rlo_tpu/pallas/flash.py:320",
                     train_launches["bwd_dkv"], k345_stats["K5"], train_p)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
