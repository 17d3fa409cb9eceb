"""Where the time of one training step goes, on the card.

    python3 -m rlo_tpu_torch.tools.profile_train

Builds the flagship training config (vocab 32768, d 1024, 16 heads, 8
layers, d_ff 4096, bf16; ``benchmarks/train_bench.py:65-67``) with
random weights from a seed and one fixed batch of 4 x 1024 random tokens
(the flagship batch), warms up two SGD ``train_step``s, then times 8
steps on the host clock (each ends in a device synchronise; median
reported) and traces one step with ``torch.profiler``. Prints the
host wall time, the device time summed over kernels (one stream, so
kernels do not overlap), the device's idle share of the traced step and
of the unprofiled median step, the device time and launches by group (K2
flash forward, K4 flash dq, K5 flash dk/dv, K3 tie counts, matrix
products, the rest: elementwise, reductions, copies), the top kernels,
the top PyTorch ops and the rest's device time by the op that launched
it; then one JSON line with the same numbers. Needs a
CUDA card; fails without one, and fails if the profiler records no
device time.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

from rlo_tpu_torch.tools.profile_decode import _report, trace

#: kernel-name fragments of each group (the port's kernels by their CUDA
#: function names; cuBLAS/CUTLASS products by theirs)
GROUPS = (("K2 flash forward", ("flash_fwd_",)),
          ("K3 tie counts", ("flash_rowstats_kernel",)),
          ("K4 flash dq", ("flash_bwd_dq_",)),
          ("K5 flash dk/dv", ("flash_bwd_dkv_",)),
          ("matrix products", ("gemm", "cutlass", "sm90_xmma", "nvjet",
                               "cublas")))
#: the flagship batch (benchmarks/train_bench.py:65-67), timed steps, seed
BATCH, SEQ, STEPS, SEED = 4, 1024, 8, 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA card", file=sys.stderr)
        return 2
    from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                                  init_params, train_step)
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
    params = init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ),
                           generator=gen, device=dev, dtype=torch.int32)

    def step():
        nonlocal params
        params, _ = train_step(params, tokens, cfg, lr=1e-2)

    for _ in range(2):
        step()
    walls = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(walls)
    n_tok = BATCH * SEQ
    print(f"[train] batch {BATCH} x seq {SEQ}: median step "
          f"{step_ms:.3f} ms over {STEPS} steps "
          f"({n_tok / step_ms * 1e3:.0f} tokens/s), no profiler")
    r = trace(step, GROUPS)
    # the profiler slows the host: the idle share of an unprofiled step
    r["idle_share_unprofiled"] = max(0.0, 1 - r["device_ms"] / step_ms)
    _report("one SGD training step", r)
    print(f"[profile] device time {r['device_ms']:.3f} ms of the "
          f"unprofiled {step_ms:.3f} ms step: idle "
          f"{100 * r['idle_share_unprofiled']:.1f}%")
    print(json.dumps({"card": card, "batch": BATCH, "seq": SEQ,
                      "step_ms_median": step_ms, "train_step": r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
