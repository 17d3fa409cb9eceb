#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card: the rootless collectives and
the dense serving path.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero
without them, and without the ``rlo_tpu_torch`` package beside it. Runs
on one card: with several visible it pins itself to the first.
Phases, each printing its own lines:

1. Card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   builds every kernel of the port from ``rlo_tpu_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together).
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
   ragged edges, GQA group sizes 1/2/8 and int8 caches; K7 and K8 must
   be bit-identical. Times each kernel, its plain version, its bound and
   one PyTorch call that computes the same function.
5. Serving at full width (the flagship config, vocab 32768, d 1024, 16
   heads, 8 layers, d_ff 4096, bf16, random weights from the seed):
   ``generate_timed`` at batch 32 / plen 1024 / 64 new tokens, the same
   with an int8 cache and 16 new tokens, a GQA+RoPE config against the
   plain versions on the CPU, and a 32-request ``DecodeServer`` held
   against each prompt's own ``generate``. K2, K6, K7 and K8's launch counts are set to 0
   before this phase and read after it.
6. One JSON line of kernel figures, then the last line
   ``{"ok": true, "device": {...}}``.

Every failure raises, so the exit code is non-zero and no result line
is printed.
"""

from __future__ import annotations

import json
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
#: a top-2 logit gap under this is a near-tie: greedy tokens may part there
NEAR_TIE = 1e-2
#: ... or under this many units in the last place of the top logit, for
#: logits that come out of a bf16 product (one bf16 ulp at 2..4 is 2^-6)
NEAR_TIE_ULPS = 2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call, by CUDA events."""
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


def phase_k2(dev) -> dict:
    """K2 at the prefill shapes (batch x heads folded: 32*16 = 512 heads,
    L 64 and 1024, D 64), a carried (non-initial) state, ragged Lq/Lk and
    GQA groups 1/2/8. Tolerance on m, l and o: rtol 1e-4 with atol 1e-4
    per unit of the largest |value| (f32 sums in another order: the
    kernel's FMA loop over 64-wide tiles against one BLAS pass)."""
    import torch
    import torch.nn.functional as F
    from rlo_tpu_torch.kernels import flash as k2

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def case(h, hk, lq, lk, dtype, carried):
        q = torch.randn(h, lq, 64, generator=gen, device=dev).to(dtype)
        k = torch.randn(hk, lk, 64, generator=gen, device=dev).to(dtype)
        v = torch.randn(hk, lk, 64, generator=gen, device=dev).to(dtype)
        if carried:
            m = torch.randn(h, 1, lq, generator=gen, device=dev)
            l = torch.rand(h, 1, lq, generator=gen, device=dev) + 0.5
            o = torch.randn(h, lq, 64, generator=gen, device=dev)
        else:
            m = torch.full((h, 1, lq), k2.NEG, device=dev)
            l = torch.zeros(h, 1, lq, device=dev)
            o = torch.zeros(h, lq, 64, device=dev)
        qp = torch.arange(lk - lq, lk, dtype=torch.int32,
                          device=dev).reshape(1, lq)
        kp = torch.arange(lk, dtype=torch.int32, device=dev).reshape(1, lk)
        return q, k, v, m, l, o, qp, kp

    worst = 0.0
    cases = [(512, 512, 64, 64, torch.bfloat16, False),
             (512, 512, 1024, 1024, torch.bfloat16, False),
             (64, 64, 200, 1000, torch.bfloat16, True),
             (64, 64, 129, 77, torch.float32, True),
             (32, 16, 128, 128, torch.bfloat16, False),
             (32, 4, 128, 128, torch.bfloat16, False),
             (32, 4, 100, 100, torch.float32, True)]
    for h, hk, lq, lk, dtype, carried in cases:
        args = case(h, hk, lq, lk, dtype, carried)
        for causal in (True, False):
            got = k2.flash_block_update_hld(*args, causal=causal,
                                            scale=0.125)
            want = k2.flash_block_update_hld_plain(*args, causal=causal,
                                                   scale=0.125)
            torch.cuda.synchronize()
            for name, g, w in zip("mlo", got, want):
                check(bool(torch.isfinite(g).all()) and _close(g, w, 1e-4,
                                                               1e-4),
                      f"K2 {name} H={h} Hkv={hk} Lq={lq} Lk={lk} {dtype} "
                      f"causal={causal} differs from its plain version")
            worst = max(worst, abs_err(got[2] / got[1].transpose(1, 2),
                                       want[2] / want[1].transpose(1, 2)))
    print(f"[k2] {2 * len(cases)} cases (folded heads 512 at L 64 and 1024, "
          f"carried state, ragged Lq/Lk, GQA groups 1/2/8, bf16/f32) within "
          f"rtol 1e-4 of the plain version; max |err| of o/l {worst:.3g}")

    q, k, v, m, l, o, qp, kp = case(512, 512, 1024, 1024, torch.bfloat16,
                                    False)
    kern = time_ms(lambda: k2.flash_block_update_hld(
        q, k, v, m, l, o, qp, kp, causal=True, scale=0.125), iters=10)
    plain = time_ms(lambda: k2.flash_block_update_hld_plain(
        q, k, v, m, l, o, qp, kp, causal=True, scale=0.125), iters=5)
    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=0.125), iters=10)
    nbytes = 3 * q.numel() * 2 + o.numel() * 4 + 2 * m.numel() * 4
    flops = 4 * 512 * 64 * (1024 * 1025 // 2)
    bound_b = nbytes / PEAK_HBM_BYTES_S * 1e3
    bound_f = flops / PEAK_BF16_FLOPS * 1e3
    bound = max(bound_b, bound_f)
    by = "bytes" if bound_b >= bound_f else "operations"
    print(f"[k2] causal 512 heads x 1024 x 64 bf16: kernel {kern:.4f} ms, "
          f"plain {plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, "
          f"bound {bound:.4f} ms ({by}: {nbytes} B / 3.35 TB/s = "
          f"{bound_b:.4f} ms, {flops} flop / 989 TFLOP/s = {bound_f:.4f} ms),"
          f" kernel at {100 * bound / kern:.1f}% of bound")
    return dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=by, max_abs_err=worst)


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


# ---------------------------------------------------------------------------
# Phase 5: serving at full width
# ---------------------------------------------------------------------------

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
        top = torch.topk(logits, 2, dim=-1).values
        gap = top[:, 0] - top[:, 1]
        if cfg.act_dtype == torch.bfloat16:
            # bf16 logits: a gap of a few ulps is as close as they get
            ulp = torch.exp2(torch.floor(torch.log2(top[:, 0].abs())) - 7)
            gap = gap * (NEAR_TIE / torch.maximum(
                torch.full_like(ulp, NEAR_TIE), NEAR_TIE_ULPS * ulp))
        gaps.append(gap)
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


def kernel_entry(name, source, replaces, launches, st) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
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
    torch.cuda.empty_cache()

    counted = (k2.flash_block_update_hld, kd.flash_block_decode,
               kd.write_kv_row, kd.write_kv_block)
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    serving = phase_serving(dev)
    served = {fn.__name__: fn.launches for fn in counted}
    print(f"[serve] serving path took {time.perf_counter() - t0:.1f} s, "
          f"launches {served}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for name, n in served.items():
        check(n > 0, f"{name} was not launched on the serving path")

    print(json.dumps({"k1_ring_chunk": k1_stats["ring_chunk"],
                      "facade_allreduce": facade, "serving": serving}))
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        kernel_entry("K1 fused_combine", K1_SOURCE, K1_REPLACES, launches,
                     dict(k1_stats["256MB"],
                          max_abs_err=k1_stats["max_abs_err"])),
        kernel_entry("K2 flash_block_update_hld", FLASH_SOURCE,
                     "rlo_tpu/pallas/flash.py:114",
                     served["flash_block_update_hld"], k2_stats),
        kernel_entry("K6 flash_block_decode", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:70",
                     served["flash_block_decode"], k6_stats),
        kernel_entry("K7 write_kv_row", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:141",
                     served["write_kv_row"], w_stats["K7"]),
        kernel_entry("K8 write_kv_block", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:168",
                     served["write_kv_block"], w_stats["K8"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
